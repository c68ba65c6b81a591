"""Utilities: image grids (`visualize`) and resumable checkpoints (`checkpoint`)."""
