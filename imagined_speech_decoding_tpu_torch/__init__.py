"""PyTorch + CUDA port of imagined_speech_decoding_tpu, for NVIDIA Hopper.

The JAX package beside this one is the reference. This package imports
``torch`` and never ``jax``. Its hand-written CUDA kernels live in
``csrc/`` and are built with ``nvcc`` on first use (``ops.cuda``).
"""
