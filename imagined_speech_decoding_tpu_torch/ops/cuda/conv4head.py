"""Fused sliding-window Conv4Layers head, forward: CUDA kernel B2 and its
plain PyTorch version.

Replaces the forward of ``imagined_speech_decoding_tpu/ops/pallas/
conv4head.py`` (``_fwd_impl`` / ``_fwd_kernel``, reached through
``fused_conv4_head``). The kernel source is ``csrc/conv4head.cu``; its
header says what bounds it on the H100 and what the design does about
that. The backward kernels (``_bwd_w_kernel``, ``_bwd_x_kernel``) serve
training and are not ported yet.

Operand layouts (from ``models.heads.Conv4LayersHead.prepare_fused_weights``):
  x      (B, C, T)       raw trials, batch-major
  w12    (Z*O, K1*C)     fused temporal x zone-scattered spatial conv, tap-major
  b12    (Z*O, 1)        fused bias
  w3, w4 (Z, O, K2*O)    per-zone 'same' temporal convs, tap-major
  out    (B, N, Z*O)     per-window zone features

Routing: a CPU tensor goes to ``fused_conv4_head_plain``; a CUDA tensor
launches the kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _lib

KERNEL_WIDTHS = (32,)  # O values csrc/conv4head.cu is instantiated for
MAX_SMEM_BYTES = 232448  # per-block dynamic shared memory on Hopper (227 KB)


def _geometry(x, w12, w3, window_len: int, step: int):
    b, c, t = x.shape
    zo, kc1 = w12.shape
    z, o, ko2 = w3.shape
    if zo != z * o or kc1 % c or ko2 % o:
        raise ValueError(
            f"inconsistent head operands: x {tuple(x.shape)}, w12 {tuple(w12.shape)}, "
            f"w3 {tuple(w3.shape)}"
        )
    k1, k2 = kc1 // c, ko2 // o
    if window_len < k1 or window_len > t or step < 1:
        raise ValueError(f"window_len={window_len}, step={step} do not fit T={t}, K1={k1}")
    n = (t - window_len) // step + 1
    return b, c, t, z, o, k1, k2, n


def fused_conv4_head_plain(x, w12, b12, w3, w4, window_len: int, step: int):
    """Plain PyTorch version, with the semantics of the JAX package's
    ``conv4layers_fused_all_zones_fullseq`` (``models/heads.py:749``):
    the first conv is valid, hence shift-invariant, so it runs once over
    the full sequence and each window's output is a slice of it; the two
    'same' tail convs zero-pad at the window edges, so they run per window.
    Then exact GELU and the mean over the window's ``t1`` steps."""
    b, c, _, z, o, k1, k2, n = _geometry(x, w12, w3, window_len, step)
    t1 = window_len - k1 + 1
    xp = x.unfold(2, k1, 1)  # (B, C, T-K1+1, K1)
    h = torch.einsum("bctk,pkc->bpt", xp, w12.view(z * o, k1, c)) + b12
    hw = torch.stack([h[..., i * step : i * step + t1] for i in range(n)], dim=1)
    hw = hw.view(b, n, z, o, t1)
    for w in (w3, w4):
        patches = F.pad(hw, (k2 // 2, k2 // 2)).unfold(-1, k2, 1)  # (B, N, Z, I, t1, K2)
        hw = torch.einsum("bnzitk,zoki->bnzot", patches, w.view(z, o, k2, o))
    return F.gelu(hw).mean(dim=-1).reshape(b, n, z * o)


def fused_conv4_head(x, w12, b12, w3, w4, window_len: int, step: int):
    """Sliding-window Conv4Layers head: ``x (B, C, T)`` -> ``(B, N, Z*O)``."""
    b, c, t, z, o, k1, k2, n = _geometry(x, w12, w3, window_len, step)
    if x.device.type == "cpu":
        return fused_conv4_head_plain(x, w12, b12, w3, w4, window_len, step)

    _lib.require_cuda_f32("x", x)
    _lib.require_cuda_f32("w12", w12, (z * o, k1 * c))
    _lib.require_cuda_f32("b12", b12, (z * o, 1))
    _lib.require_cuda_f32("w3", w3, (z, o, k2 * o))
    _lib.require_cuda_f32("w4", w4, (z, o, k2 * o))
    if any(t_.device != x.device for t_ in (w12, b12, w3, w4)):
        raise ValueError("head operands must share x's device")
    _lib.require_no_grad("the Conv4Layers head kernel", x, w12, b12, w3, w4)
    if o not in KERNEL_WIDTHS:
        raise ValueError(f"the kernel is built for O in {KERNEL_WIDTHS}, got O={o}")
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel grid's 65535 trials")
    lib = _lib.library()
    smem = lib.isd_conv4head_smem_bytes(c, window_len, o, k1, k2)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"one (trial, window, zone) block needs {smem} bytes of shared memory; "
            f"the card allows {MAX_SMEM_BYTES}"
        )
    out = torch.empty((b, n, z * o), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = lib.isd_conv4head_fwd(
            x.data_ptr(), w12.data_ptr(), b12.data_ptr(), w3.data_ptr(), w4.data_ptr(),
            out.data_ptr(), b, c, t, z, o, k1, k2, window_len, step, n, _lib.stream_of(x),
        )
    _lib.check(code, "isd_conv4head_fwd")
    fused_conv4_head.launches += 1
    return out


fused_conv4_head.launches = 0  # kernel launches; the CPU route does not count
