"""Hand-written GPU kernels of the port, each beside its plain version."""
