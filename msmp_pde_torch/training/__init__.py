"""Experiment setup and the model forward (training waits for the next slice)."""
