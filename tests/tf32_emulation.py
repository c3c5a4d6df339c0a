"""3xTF32 tensor-core products emulated on the CPU, shared by the tests of
the f32 head kernels' routes (``test_torch_conv4head_tc.py``: B2f,
``test_torch_conv4head_bwd_x_tc.py``: B2x, ``test_torch_conv4head_bwd_w_tc.py``:
B2w; ``test_torch_tf32_split.py``: the split itself).

Every product of those kernels is 3xTF32 (``csrc/mma_tf32.cuh``): each f32
operand is split into hi (its low 13 mantissa bits cleared) and lo = v -
hi, which the tensor core reads truncated to TF32 as well; per reduction
step of 8, lo*hi, hi*lo and hi*hi go into f32 accumulators and lo*lo is
dropped.
"""

from __future__ import annotations

import torch


def to_tf32(a: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of an f32 operand: its top 19 bits."""
    return (a.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(a: torch.Tensor):
    hi = to_tf32(a)
    return hi, to_tf32(a - hi)


def mma(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """``a (..., M, R) @ b (..., R, n)`` as mma.sync m16n8k8 steps of 8
    along R, each step's products added into f32 accumulators: lo*hi,
    hi*lo, hi*hi (``passes`` 3), or hi*hi alone (one TF32 pass)."""
    (ah, al), (bh, bl) = split(a), split(b)
    pairs = [(al, bh), (ah, bl), (ah, bh)][3 - passes:]
    acc = torch.zeros(torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]) + (a.shape[-2], b.shape[-1]))
    for r0 in range(0, a.shape[-1], 8):
        for x, y in pairs:
            acc = acc + x[..., r0:r0 + 8] @ y[..., r0:r0 + 8, :]
    return acc


def im2col(rows: torch.Tensor, n_cols: int, taps) -> torch.Tensor:
    """``P[..., i * R + c, t] = rows[..., c, t + shift_i]`` for t < n_cols,
    the shifts in ``taps`` order (tap-major)."""
    return torch.cat([rows[..., s:s + n_cols] for s in taps], dim=-2)
