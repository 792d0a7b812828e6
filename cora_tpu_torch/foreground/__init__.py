"""Foreground models: the Gaussian SCK foregrounds, the Haslam-constrained
galaxy with its Faraday screen, and the point sources."""
