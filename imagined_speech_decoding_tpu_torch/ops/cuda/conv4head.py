"""Fused sliding-window Conv4Layers head: CUDA kernels B2f (forward), B2w
(weight gradients) and B2x (input gradient), and their plain PyTorch
version.

Replaces ``imagined_speech_decoding_tpu/ops/pallas/conv4head.py``:
``_fwd_impl`` / ``_fwd_kernel`` (B2f, ``csrc/conv4head.cu``) and the
custom VJP's ``_bwd_rule`` with ``_bwd_w_kernel`` (B2w) and
``_bwd_x_kernel`` (B2x), both in ``csrc/conv4head_bwd.cu``. Each source's
header says what bounds it on the H100 and what the design does about it.
B2f and B2w run on the tensor cores in 3xTF32 (f32 accuracy), sharing
one conv helper (``csrc/conv4head_tc.cuh``); they are built for O = 32
and K1 = K2 = 5. B2f takes any channel count C; B2w needs C to be a
multiple of 8 and raises for any other C.

Operand layouts (from ``models.heads.Conv4LayersHead.fused_weights``),
with a leading model axis M where the JAX kernel had ``jax.vmap``:
  x      (M, B, C, T)       raw trials, one batch per model
  w12    (M, Z*O, K1*C)     fused temporal x zone-scattered spatial conv, tap-major
  b12    (M, Z*O, 1)        fused bias
  w3, w4 (M, Z, O, K2*O)    per-zone 'same' temporal convs, tap-major
  out    (M, B, N, Z*O)     per-window zone features
The forward (``fused_conv4_head`` and its plain version) also takes the
operands without the model axis (``x (B, C, T)``, ``w12 (Z*O, K1*C)``
...) and runs them as M = 1; the backward functions take the model axis
only (``g (M, B, N, Z*O)``), as the autograd Function passes it.

Routing: a CPU tensor goes to ``fused_conv4_head_plain``, which autograd
differentiates; that autograd backward is the plain version of B2w and
B2x (``conv4head_bwd_plain``). A CUDA tensor launches the kernels or
raises; there is no fallback between the two. On CUDA the forward is a
``torch.autograd.Function``: it saves only its operands, and its backward
recomputes the forward inside B2w (when any weight operand needs a
gradient) and B2x (only when ``x`` needs one; training never asks).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import _lib

KERNEL_WIDTHS = (32,)  # O values the kernels are instantiated for
KERNEL_TAPS = 5  # K1 = K2 the kernels are instantiated for
MAX_SMEM_BYTES = 232448  # per-block dynamic shared memory on Hopper (227 KB)
MAX_GRID = 65535


def _geometry(x, w12, w3, window_len: int, step: int):
    """``(M, B, C, T, Z, O, K1, K2, N)`` of stacked operands."""
    m, b, c, t = x.shape
    mw, zo, kc1 = w12.shape
    _, z, o, ko2 = w3.shape
    if mw != m or zo != z * o or kc1 % c or ko2 % o or w3.shape[0] != m:
        raise ValueError(
            f"inconsistent head operands: x {tuple(x.shape)}, w12 {tuple(w12.shape)}, "
            f"w3 {tuple(w3.shape)}"
        )
    k1, k2 = kc1 // c, ko2 // o
    if window_len < k1 or window_len > t or step < 1:
        raise ValueError(f"window_len={window_len}, step={step} do not fit T={t}, K1={k1}")
    n = (t - window_len) // step + 1
    return m, b, c, t, z, o, k1, k2, n


def _model_axis(n_tensors: int):
    """Let ``fn`` take its first ``n_tensors`` operands without the model
    axis too (a 3-D first operand), running them as M = 1."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args):
            if args[0].dim() == 4:
                return fn(*args)
            out = fn(*(a[None] for a in args[:n_tensors]), *args[n_tensors:])
            return tuple(t[0] for t in out) if isinstance(out, tuple) else out[0]

        return call

    return wrap


@_model_axis(5)
def fused_conv4_head_plain(x, w12, b12, w3, w4, window_len: int, step: int):
    """Plain PyTorch version, with the semantics of the JAX package's
    ``conv4layers_fused_all_zones_fullseq`` (``models/heads.py:749``):
    the first conv is valid, hence shift-invariant, so it runs once over
    the full sequence and each window's output is a slice of it; the two
    'same' tail convs zero-pad at the window edges, so they run per window.
    Then exact GELU and the mean over the window's ``t1`` steps."""
    m, b, c, _, z, o, k1, k2, n = _geometry(x, w12, w3, window_len, step)
    t1 = window_len - k1 + 1
    xp = x.unfold(3, k1, 1)  # (M, B, C, T-K1+1, K1)
    h = torch.einsum("mbctk,mpkc->mbpt", xp, w12.view(m, z * o, k1, c)) + b12[:, None]
    hw = torch.stack([h[..., i * step : i * step + t1] for i in range(n)], dim=2)
    hw = hw.view(m, b, n, z, o, t1)
    for w in (w3, w4):
        patches = F.pad(hw, (k2 // 2, k2 // 2)).unfold(-1, k2, 1)  # (M, B, N, Z, I, t1, K2)
        hw = torch.einsum("mbnzitk,mzoki->mbnzot", patches, w.view(m, z, o, k2, o))
    return F.gelu(hw).mean(dim=-1).reshape(m, b, n, z * o)


def conv4head_bwd_plain(g, x, w12, b12, w3, w4, window_len: int, step: int):
    """Plain version of B2w and B2x: ``(dx, dw12, db12, dw3, dw4)``, the
    gradients of ``<g, fused_conv4_head_plain(x, ...)>``, by autograd."""
    with torch.enable_grad():
        ops = [t.detach().requires_grad_(True) for t in (x, w12, b12, w3, w4)]
        out = fused_conv4_head_plain(*ops, window_len, step)
        return torch.autograd.grad(out, ops, g)


def _check_cuda(x, w12, b12, w3, w4, window_len: int, step: int, g=None):
    """Validate stacked CUDA operands for the kernels; returns the geometry."""
    m, b, c, t, z, o, k1, k2, n = _geometry(x, w12, w3, window_len, step)
    _lib.require_cuda_f32("x", x)
    _lib.require_cuda_f32("w12", w12, (m, z * o, k1 * c))
    _lib.require_cuda_f32("b12", b12, (m, z * o, 1))
    _lib.require_cuda_f32("w3", w3, (m, z, o, k2 * o))
    _lib.require_cuda_f32("w4", w4, (m, z, o, k2 * o))
    if g is not None:
        _lib.require_cuda_f32("g", g, (m, b, n, z * o))
    if any(t_.device != x.device for t_ in (w12, b12, w3, w4) + ((g,) if g is not None else ())):
        raise ValueError("head operands must share x's device")
    if o not in KERNEL_WIDTHS:
        raise ValueError(f"the kernels are built for O in {KERNEL_WIDTHS}, got O={o}")
    if max(m, b) > MAX_GRID:
        raise ValueError(f"{m} models or {b} trials exceed the kernel grid's {MAX_GRID}")
    return m, b, c, t, z, o, k1, k2, n


def _check_smem(nbytes: int, what: str) -> None:
    if nbytes > MAX_SMEM_BYTES:
        raise ValueError(
            f"one {what} block needs {nbytes} bytes of shared memory; "
            f"the card allows {MAX_SMEM_BYTES}"
        )


def _check_taps(k1: int, k2: int) -> None:
    if k1 != KERNEL_TAPS or k2 != KERNEL_TAPS:
        raise ValueError(f"the head kernels are built for K1 = K2 = {KERNEL_TAPS}, "
                         f"got K1={k1}, K2={k2}")


def _check_bwd_w_channels(c: int) -> None:
    """B2w's reduction steps of 8 rows over ``K1 * C`` must not straddle taps."""
    if c % 8:
        raise ValueError(f"B2w needs the channel count C to be a multiple of 8, got C={c}")


def _launch_fwd(x, w12, b12, w3, w4, window_len: int, step: int):
    m, b, c, t, z, o, k1, k2, n = _check_cuda(x, w12, b12, w3, w4, window_len, step)
    _check_taps(k1, k2)
    lib = _lib.library()
    _check_smem(lib.isd_conv4head_smem_bytes(c, window_len, o, k1), "B2f")
    w3, w4 = _aligned16(w3), _aligned16(w4)
    s = _trial_splits(m, b, z, n, x.device)
    out = torch.empty((m, b, n, z * o), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = lib.isd_conv4head_fwd(
            x.data_ptr(), w12.data_ptr(), b12.data_ptr(), w3.data_ptr(), w4.data_ptr(),
            out.data_ptr(), m, b, c, t, z, o, k1, k2, window_len, step, n, s,
            _lib.stream_of(x),
        )
    _lib.check(code, "isd_conv4head_fwd")
    fused_conv4_head.launches += 1
    return out


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it in storage of its own when its data does not
    start on 16 bytes (B2f and B2w copy weights in 16-byte chunks)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _trial_splits(m: int, b: int, z: int, n: int, device) -> int:
    """Trial ranges per (model, zone, window) in B2f and B2w: at least
    two blocks per SM (one block fills an SM's shared memory, so two
    waves or more), never more ranges than trials."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(b, -(-2 * sms // (m * z * n))))


def conv4head_bwd_w(g, x, w12, b12, w3, w4, window_len: int, step: int):
    """B2w: ``(dw12, db12, dw3, dw4)`` of ``<g, fused_conv4_head(x, ...)>``."""
    if x.device.type == "cpu":
        return conv4head_bwd_plain(g, x, w12, b12, w3, w4, window_len, step)[1:]
    _, _, c, _, _, _, k1, k2, _ = _geometry(x, w12, w3, window_len, step)
    _check_taps(k1, k2)
    _check_bwd_w_channels(c)
    m, b, c, t, z, o, k1, k2, n = _check_cuda(x, w12, b12, w3, w4, window_len, step, g)
    lib = _lib.library()
    _check_smem(lib.isd_conv4head_bwd_w_smem_bytes(c, window_len, o, k1), "B2w")
    w12, w3, w4 = _aligned16(w12), _aligned16(w3), _aligned16(w4)
    s = _trial_splits(m, b, z, n, x.device)
    p = n * s
    grads = [torch.empty((m,) + tuple(w.shape[1:]), dtype=torch.float32, device=x.device)
             for w in (w12, b12, w3, w4)]
    parts = [torch.empty((m, p) + tuple(w.shape[1:]), dtype=torch.float32, device=x.device)
             for w in (w12, b12, w3, w4)]
    with torch.cuda.device(x.device):
        code = lib.isd_conv4head_bwd_w(
            g.data_ptr(), x.data_ptr(), w12.data_ptr(), b12.data_ptr(), w3.data_ptr(),
            w4.data_ptr(), *(t_.data_ptr() for t_ in grads), *(t_.data_ptr() for t_ in parts),
            m, b, c, t, z, o, k1, k2, window_len, step, n, s, _lib.stream_of(x),
        )
    _lib.check(code, "isd_conv4head_bwd_w")
    conv4head_bwd_w.launches += 1
    return tuple(grads)


def conv4head_bwd_x(g, x, w12, b12, w3, w4, window_len: int, step: int):
    """B2x: ``dx`` of ``<g, fused_conv4_head(x, ...)>``. The kernel writes
    per-window gradients; the overlapping windows are added here, in plain
    PyTorch, as the JAX package adds them in XLA."""
    if x.device.type == "cpu":
        return conv4head_bwd_plain(g, x, w12, b12, w3, w4, window_len, step)[0]
    m, b, c, t, z, o, k1, k2, n = _check_cuda(x, w12, b12, w3, w4, window_len, step, g)
    _check_taps(k1, k2)
    lib = _lib.library()
    _check_smem(lib.isd_conv4head_bwd_smem_bytes(c, window_len, o, k1), "backward")
    dxw = torch.empty((m, b, n, c, window_len), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = lib.isd_conv4head_bwd_x(
            g.data_ptr(), x.data_ptr(), w12.data_ptr(), b12.data_ptr(), w3.data_ptr(),
            w4.data_ptr(), dxw.data_ptr(), m, b, c, t, z, o, k1, k2, window_len, step, n,
            _lib.stream_of(x),
        )
    _lib.check(code, "isd_conv4head_bwd_x")
    conv4head_bwd_x.launches += 1
    dx = torch.zeros_like(x)
    for i in range(n):
        dx[..., i * step : i * step + window_len] += dxw[:, :, i]
    return dx


class _FusedConv4Head(torch.autograd.Function):
    """B2f forward; B2w / B2x backward, recomputing the forward in-kernel."""

    @staticmethod
    def forward(ctx, x, w12, b12, w3, w4, window_len, step):
        ctx.save_for_backward(x, w12, b12, w3, w4)
        ctx.geometry = (window_len, step)
        return _launch_fwd(x, w12, b12, w3, w4, window_len, step)

    @staticmethod
    def backward(ctx, g):
        x, w12, b12, w3, w4 = ctx.saved_tensors
        g = g.contiguous()
        dx = dw12 = db12 = dw3 = dw4 = None
        if any(ctx.needs_input_grad[1:5]):
            dw12, db12, dw3, dw4 = conv4head_bwd_w(g, x, w12, b12, w3, w4, *ctx.geometry)
        if ctx.needs_input_grad[0]:
            dx = conv4head_bwd_x(g, x, w12, b12, w3, w4, *ctx.geometry)
        return dx, dw12, db12, dw3, dw4, None, None


@_model_axis(5)
def fused_conv4_head(x, w12, b12, w3, w4, window_len: int, step: int):
    """Sliding-window Conv4Layers head: ``x (M, B, C, T)`` -> ``(M, B, N, Z*O)``
    (or ``(B, C, T)`` -> ``(B, N, Z*O)`` without the model axis)."""
    if x.device.type == "cpu":
        return fused_conv4_head_plain(x, w12, b12, w3, w4, window_len, step)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w12, b12, w3, w4)):
        return _FusedConv4Head.apply(x, w12, b12, w3, w4, window_len, step)
    return _launch_fwd(x, w12, b12, w3, w4, window_len, step)


fused_conv4_head.launches = 0  # B2f launches; the CPU route does not count
conv4head_bwd_w.launches = 0  # B2w launches
conv4head_bwd_x.launches = 0  # B2x launches
