"""Learning-rate schedule: linear warmup, then cosine decay, per step.

Counterpart of ``imagined_speech_decoding_tpu/train/schedule.py`` as a
numpy table. Step k of the optimizer (k updates already applied, the
optax count) uses ``table[min(k, len(table) - 1)]``.
"""

from __future__ import annotations

import numpy as np


def cosine_scheduler(
    base_value: float,
    final_value: float,
    epochs: int,
    niter_per_ep: int,
    warmup_epochs: int = 0,
    start_warmup_value: float = 0.0,
) -> np.ndarray:
    """Per-step value table of length ``epochs * niter_per_ep``."""
    warmup_iters = min(warmup_epochs * niter_per_ep, epochs * niter_per_ep)
    warmup = (
        np.linspace(start_warmup_value, base_value, warmup_iters)
        if warmup_iters > 0
        else np.array([])
    )
    n = epochs * niter_per_ep - warmup_iters
    iters = np.arange(n)
    main = final_value + 0.5 * (base_value - final_value) * (1 + np.cos(np.pi * iters / max(n, 1)))
    schedule = np.concatenate((warmup, main))
    assert len(schedule) == epochs * niter_per_ep
    return schedule


def warmup_cosine_lr(
    learning_rate: float,
    epochs: int,
    niter_per_ep: int,
    warmup_epochs: int = 10,
    final_scale: float = 0.1,
) -> np.ndarray:
    """The per-step learning rates: ``learning_rate`` times a 1 -> ``final_scale``
    cosine multiplier table after ``warmup_epochs`` of linear warmup from 0."""
    return learning_rate * cosine_scheduler(
        1.0, final_scale, epochs, niter_per_ep, warmup_epochs=warmup_epochs
    )


def lr_at(table: np.ndarray, step: int) -> float:
    """The learning rate of optimizer step ``step``; steps past the table
    keep its last value."""
    return float(table[min(step, len(table) - 1)])
