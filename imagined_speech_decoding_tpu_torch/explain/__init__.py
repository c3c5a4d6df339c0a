"""Gradient attributions of the PyTorch port's FAST."""
