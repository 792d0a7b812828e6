"""Host helpers: splines, bilinear lookup, matrix roots, stage timing."""
