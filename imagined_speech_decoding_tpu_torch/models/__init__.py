"""FAST with the Conv4Layers head, in PyTorch."""
