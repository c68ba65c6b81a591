"""Utilities: image grids (`visualize`)."""
