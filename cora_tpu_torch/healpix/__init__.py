"""HEALPix geometry and the scan-mode spherical harmonic synthesis."""
