"""Batch indices for the stacked training engine.

Counterpart of ``imagined_speech_decoding_tpu/data/arrays.py``. The corpus
stays on the device as one ``(S*N, C, T)`` tensor, and each model gathers
its batches through its own index rows. Batching follows torch
``DataLoader(shuffle=True, drop_last=False)``: a fresh permutation per
epoch, ``ceil(n / B)`` batches, a short last batch.

Permutations come from a CPU ``torch.Generator``, so one seed gives the
same batches whichever device trains. They cannot reproduce the JAX
package's ``jax.random`` permutations.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def num_batches(n: int, batch_size: int) -> int:
    return -(-n // batch_size)


def epoch_permutations(generator: torch.Generator, n_models: int, n: int) -> torch.Tensor:
    """One epoch's order of ``n`` trials for each model: ``(M, n)`` int64,
    drawn model by model from the CPU ``generator``."""
    return torch.stack([torch.randperm(n, generator=generator) for _ in range(n_models)])


def sequential_batch_indices(n: int, batch_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic (eval-order) batch indices with a validity mask:
    ``(n_steps, B)`` int32 indices (0 on the padding of the last batch)
    and float32 weights (1 on real slots, 0 on padding)."""
    n_steps = num_batches(n, batch_size)
    pad = n_steps * batch_size - n
    idx = np.concatenate([np.arange(n), np.zeros(pad, np.int64)]).reshape(n_steps, batch_size)
    w = (np.arange(n_steps * batch_size) < n).astype(np.float32).reshape(n_steps, batch_size)
    return idx.astype(np.int32), w
