"""Foreground models: the Gaussian SCK foregrounds and the full-sky
synchrotron amplitudes."""
