"""Synthetic EEG with learnable class structure, in numpy and SciPy.

Restates ``synthetic_trials`` and ``synthetic_corpus`` of
``imagined_speech_decoding_tpu/data/synthetic.py`` (the JAX package's
``data`` package imports ``jax`` on import). The same numpy calls in the
same order, so a seed gives bit-equal trials in both packages: each class
imprints three band-limited sinusoidal sources (4-30 Hz) through a fixed
random spatial mixing, over AR(1)-coloured noise.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .constants import SFREQ, TARGET_TIMEPOINTS


def synthetic_trials(
    seed: int,
    n_trials: int,
    n_channels: int = 64,
    n_samples: int = TARGET_TIMEPOINTS,
    n_classes: int = 5,
    sfreq: float = SFREQ,
    snr: float = 0.6,
) -> Tuple[np.ndarray, np.ndarray]:
    """``(N, C, T)`` float32 trials and ``(N,)`` uint8 labels."""
    from scipy.signal import lfilter

    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / sfreq
    freqs = 4.0 + 26.0 * rng.random((n_classes, 3))
    mixing = rng.normal(size=(n_classes, 3, n_channels)).astype(np.float32)
    y = rng.integers(0, n_classes, size=n_trials).astype(np.uint8)
    x = rng.normal(scale=1.0, size=(n_trials, n_channels, n_samples)).astype(np.float32)
    # 1/f-ish background: half white noise, half its unit-variance AR(1) low-pass.
    a = 0.9
    smooth = lfilter([1.0], [1.0, -a], x, axis=-1).astype(np.float32)
    smooth *= np.float32(np.sqrt(1.0 - a * a))
    x = (0.5 * x + 0.5 * smooth).astype(np.float32)

    phases = rng.uniform(0, 2 * np.pi, size=(n_trials, 3))
    for k in range(n_classes):
        sel = np.flatnonzero(y == k)
        if sel.size == 0:
            continue
        src = np.sin(
            2 * np.pi * freqs[k][None, :, None] * t[None, None, :] + phases[sel][:, :, None]
        ).astype(np.float32)
        x[sel] += snr * np.einsum("nst,sc->nct", src, mixing[k])
    return x, y


def synthetic_corpus(
    seed: int,
    n_subjects: int = 15,
    n_trials: int = 350,
    n_channels: int = 64,
    n_samples: int = TARGET_TIMEPOINTS,
    n_classes: int = 5,
) -> Tuple[np.ndarray, np.ndarray]:
    """A ``(S, N, C, T)`` corpus; subject s draws from seed ``seed + 1000 s``."""
    xs, ys = [], []
    for s in range(n_subjects):
        x, y = synthetic_trials(seed + 1000 * s, n_trials, n_channels, n_samples, n_classes)
        xs.append(x)
        ys.append(y)
    return np.stack(xs), np.stack(ys)
