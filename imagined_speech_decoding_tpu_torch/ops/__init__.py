"""PyTorch tensor ops: filters, and the hand-written CUDA kernels in ``ops.cuda``."""
