"""Windowing and epoching over the trailing time axis, in PyTorch.

Counterpart of ``imagined_speech_decoding_tpu/ops/windowing.py``:
``sliding_window`` is ``Tensor.unfold`` (a strided view, no copy), the
reference's own tokenizer (``x.unfold(-1, window_len, slide_step)``);
``zone_gather`` gathers montage channels into the dense zone layout.
The batch-norm zone heads (``models/heads.py``) window and gather their
input through these two functions.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def num_windows(seq_len: int, window_len: int, step: int) -> int:
    """Token count of the sliding tokenizer (reference ``fast.py:232``)."""
    return (seq_len - window_len) // step + 1


def sliding_window(x: torch.Tensor, window_len: int, step: int) -> torch.Tensor:
    """``(..., T) -> (..., N, W)`` overlapping windows, ``N = (T -
    window_len) // step + 1``; trailing samples that fill no window are
    dropped. A view of ``x``."""
    if num_windows(x.shape[-1], window_len, step) < 1:
        raise ValueError(f"{x.shape[-1]} samples hold no window of {window_len}")
    return x.unfold(-1, window_len, step)


def edge_pad(x: torch.Tensor, target_len: int) -> torch.Tensor:
    """Edge-pad the trailing axis to ``target_len`` (795 -> 800 parity,
    reference ``src/fast/data/preprocess.py:62``)."""
    t = x.shape[-1]
    if t >= target_len:
        return x
    return torch.cat([x, x[..., -1:].expand(*x.shape[:-1], target_len - t)], dim=-1)


def baseline_correct(x: torch.Tensor, n_baseline: int) -> torch.Tensor:
    """Subtract the mean of the first ``n_baseline`` samples per signal."""
    return x - x[..., :n_baseline].mean(dim=-1, keepdim=True)


def epoch_continuous(x: torch.Tensor, onsets: Sequence[int], n_samples: int) -> torch.Tensor:
    """Cut epochs from a continuous recording ``(..., T)`` at the sample
    indices ``onsets``: ``(..., E, n_samples)``."""
    idx = np.asarray(onsets)[:, None] + np.arange(n_samples)[None, :]
    return x[..., torch.as_tensor(idx, device=x.device)]


def zone_gather(x: torch.Tensor, indices, mask) -> Tuple[torch.Tensor, torch.Tensor]:
    """Montage channels into the dense zone layout: ``x (..., C, T)`` and
    ``indices`` / ``mask (Z, C_max)`` (``data.constants.zone_layout``) ->
    ``(x_zones (..., Z, C_max, T), m)``, the padded slots zeroed, ``m`` the
    mask in x's dtype. The batched form of the reference's per-zone
    indexing ``x[:, self.index_dict[area]]`` (``fast.py:210``)."""
    idx = torch.as_tensor(indices, device=x.device)
    m = torch.as_tensor(mask, device=x.device).to(x.dtype)
    z, c_max = idx.shape
    gathered = x[..., idx.reshape(-1), :].reshape(*x.shape[:-2], z, c_max, x.shape[-1])
    return gathered * m[:, :, None], m

