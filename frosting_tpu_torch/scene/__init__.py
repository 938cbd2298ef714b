"""Gaussian parameter store, PLY checkpoints, COLMAP / NeRF-synthetic
loaders and synthetic scenes."""
