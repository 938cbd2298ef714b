"""Gaussian parameter store, PLY checkpoints and synthetic scenes."""
