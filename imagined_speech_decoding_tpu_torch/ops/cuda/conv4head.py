"""Fused sliding-window Conv4Layers head: CUDA kernels B2f (forward), B2w
(weight gradients) and B2x (input gradient), and their plain PyTorch
version.

Replaces ``imagined_speech_decoding_tpu/ops/pallas/conv4head.py``:
``_fwd_impl`` / ``_fwd_kernel`` (B2f, ``csrc/conv4head.cu``) and the
custom VJP's ``_bwd_rule`` with ``_bwd_w_kernel`` (B2w) and
``_bwd_x_kernel`` (B2x), both in ``csrc/conv4head_bwd.cu``. Each source's
header says what bounds it on the H100 and what the design does about it.
All three run on the tensor cores in 3xTF32 (f32 accuracy), sharing one
conv helper (``csrc/conv4head_tc.cuh``); they are built for O = 32 and
K1 = K2 = 5. B2f and B2x take any channel count C; B2w needs C to be a
multiple of 8 and raises for any other C (B2w-bf16 takes any C).

The precision is x's dtype, as in the Pallas kernel (``dt = xt.dtype``):
an f32 x takes the kernels above; a bf16 x takes their bf16
instantiations B2f-bf16 (``csrc/conv4head_fwd_bf16.cu``) and B2w-bf16
(``csrc/conv4head_bwd_w_bf16.cu``), one bf16 ``mma.sync`` pass per product
with f32 accumulators, rounding where the Pallas kernel rounds (any C, an
even T). The weights come in as f32 either way and the kernels round them
to bf16 as they stage them; the output and every weight gradient are f32.
B2x has no bf16 instantiation: a bf16 x that needs a gradient on the card
raises ``NotImplementedError`` (ROADMAP.md, Queue 2).

Operand layouts (from ``models.heads.Conv4LayersHead.fused_weights``),
with a leading model axis M where the JAX kernel had ``jax.vmap``:
  x      (M, B, C, T)       raw trials, one batch per model (f32 or bf16)
  w12    (M, Z*O, K1*C)     fused temporal x zone-scattered spatial conv, tap-major
  b12    (M, Z*O, 1)        fused bias
  w3, w4 (M, Z, O, K2*O)    per-zone 'same' temporal convs, tap-major
  out    (M, B, N, Z*O)     per-window zone features, f32
The forward (``fused_conv4_head`` and its plain version) also takes the
operands without the model axis (``x (B, C, T)``, ``w12 (Z*O, K1*C)``
...) and runs them as M = 1; the backward functions take the model axis
only (``g (M, B, N, Z*O)``), as the autograd Function passes it.

Routing: a CPU tensor goes to ``fused_conv4_head_plain``. In f32 autograd
differentiates it; that autograd backward is the plain version of B2w and
B2x (``conv4head_bwd_plain``; B2x's alone, dx with the weights held out
of the graph, is ``conv4head_bwd_x_plain``). In bf16 it rounds at the
Pallas kernel's points, and its gradient is the written-out bf16 backward
(``conv4head_bwd_bf16_plain``), which rounds the cotangents where
``_bwd_zone`` does. A CUDA tensor launches the kernels or raises; there
is no fallback between the two. On CUDA the forward is a
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
X_DTYPES = (torch.float32, torch.bfloat16)  # x's dtypes the kernels are instantiated for
_INV_SQRT2 = 0.70710678118654752
_INV_SQRT2PI = 0.39894228040143268


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
    Then exact GELU and the mean over the window's ``t1`` steps.

    A bf16 ``x`` takes the bf16 semantics of the Pallas kernel instead
    (``_bf16_forward``), differentiable through the written-out bf16
    backward."""
    if x.dtype == torch.bfloat16:
        return _PlainBf16Head.apply(x, w12, b12, w3, w4, window_len, step)
    m, b, _, _, z, o, _, _, n = _geometry(x, w12, w3, window_len, step)
    h = _conv1_windows(x, w12, window_len, step).view(m, b, n, z, o, -1)
    h = h + b12.view(m, 1, 1, z, o, 1)
    for w in (w3, w4):
        h = _same_conv(h, w)
    return F.gelu(h).mean(dim=-1).reshape(m, b, n, z * o)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (to nearest even, as ``astype``), held in f32."""
    return t.to(torch.bfloat16).float()


def _gelu_grad(v: torch.Tensor) -> torch.Tensor:
    """d/dv [v * Phi(v)] = Phi(v) + v * phi(v)."""
    return 0.5 * (1.0 + torch.erf(v * _INV_SQRT2)) + v * _INV_SQRT2PI * torch.exp(-0.5 * v * v)


def _conv1_windows(x, w12, window_len: int, step: int):
    """The first (valid) conv of every window, without its bias:
    ``(M, B, N, Z*O, t1)``, f32 sums over the full sequence, sliced."""
    m, b, c, t = x.shape
    k1 = w12.shape[-1] // c
    t1 = window_len - k1 + 1
    n = (t - window_len) // step + 1
    h = torch.einsum("mbctk,mpkc->mbpt", x.unfold(3, k1, 1), w12.view(m, -1, k1, c))
    return torch.stack([h[..., i * step : i * step + t1] for i in range(n)], dim=2)


def _same_conv(h, w):
    """A 'same' conv of every zone: ``h (M, B, N, Z, I, t1)``, ``w (M, Z, O, K*I)``."""
    m, z, o = w.shape[:3]
    i = h.shape[4]
    k = w.shape[-1] // i
    patches = F.pad(h, (k // 2, k // 2)).unfold(-1, k, 1)  # (M, B, N, Z, I, t1, K)
    return torch.einsum("mbnzitk,mzoki->mbnzot", patches, w.view(m, z, o, k, i))


def _bf16_forward(x, w12, b12, w3, w4, window_len: int, step: int):
    """The Pallas kernel's forward for a bf16 ``x`` (``_fwd_kernel``), in
    f32 arithmetic on bf16-rounded operands: every product of two bf16
    values is exact in f32, so only the order of the sums differs from a
    kernel. Returns ``(h1, h2, h3)``, each ``(M, B, N, Z, O, t1)``:
    h1 = bf16(w12 . p + b12), h2 = bf16(w3 . pad(h1)), h3 = w4 . pad(h2) in f32."""
    m, b, _, _, z, o, _, _, n = _geometry(x, w12, w3, window_len, step)
    h = _conv1_windows(x.float(), _bf16(w12), window_len, step)
    h1 = _bf16(h.view(m, b, n, z, o, -1) + b12.view(m, 1, 1, z, o, 1))
    h2 = _bf16(_same_conv(h1, _bf16(w3)))
    return h1, h2, _same_conv(h2, _bf16(w4))


def conv4head_bwd_bf16_plain(g, x, w12, b12, w3, w4, window_len: int, step: int):
    """Plain version of B2w-bf16 (and of a bf16 B2x): ``(dx, dw12, db12,
    dw3, dw4)`` of ``<g, fused_conv4_head_plain(x, ...)>`` for a bf16 ``x``,
    written out as the Pallas kernels compute them (``_bwd_zone``,
    ``_bwd_w_kernel``, ``_bwd_x_kernel``): dh3c = bf16(g / t1 * gelu'(h3)),
    dh2c = bf16(conv4^T(dh3c)), dh1 = conv3^T(dh2c) in f32; dw4 = dh3c . p4^T,
    dw3 = dh2c . p3^T, db12 = sum dh1, dw12 = bf16(dh1) . p^T, dx =
    conv1^T(bf16(dh1)) overlap-added, in f32 and returned in x's dtype. The
    transposes are autograd's of the linear f32 maps, on bf16-valued
    operands; autograd through the forward's roundings would not round the
    cotangents where the Pallas kernel does."""
    m, b, _, _, z, o, k1, _, n = _geometry(x, w12, w3, window_len, step)
    t1 = window_len - k1 + 1
    with torch.enable_grad():
        xf = x.detach().float().requires_grad_(True)
        w12r, w3r, w4r = (_bf16(w.detach()).requires_grad_(True) for w in (w12, w3, w4))
        conv1 = _conv1_windows(xf, w12r, window_len, step).view(m, b, n, z, o, t1)
        h1 = _bf16(conv1.detach() + b12.detach().view(m, 1, 1, z, o, 1)).requires_grad_(True)
        h2 = _same_conv(h1, w3r)
        h2r = _bf16(h2.detach()).requires_grad_(True)
        h3 = _same_conv(h2r, w4r)
        dh3c = _bf16(g.float().view(m, b, n, z, o, 1) / t1 * _gelu_grad(h3.detach()))
        dh2, dw4 = torch.autograd.grad(h3, (h2r, w4r), dh3c)
        dh1, dw3 = torch.autograd.grad(h2, (h1, w3r), _bf16(dh2))
        dx, dw12 = torch.autograd.grad(conv1, (xf, w12r), _bf16(dh1))
    db12 = dh1.sum(dim=(1, 2, 5)).reshape(m, z * o, 1)
    return dx.to(x.dtype), dw12, db12, dw3, dw4


class _PlainBf16Head(torch.autograd.Function):
    """The plain bf16 head: ``_bf16_forward``'s features; gradients from
    ``conv4head_bwd_bf16_plain``."""

    @staticmethod
    def forward(ctx, x, w12, b12, w3, w4, window_len, step):
        ctx.save_for_backward(x, w12, b12, w3, w4)
        ctx.geometry = (window_len, step)
        m, b, _, _, z, o, _, _, n = _geometry(x, w12, w3, window_len, step)
        h3 = _bf16_forward(x, w12, b12, w3, w4, window_len, step)[2]
        return F.gelu(h3).mean(dim=-1).reshape(m, b, n, z * o)

    @staticmethod
    def backward(ctx, g):
        grads = conv4head_bwd_bf16_plain(g, *ctx.saved_tensors, *ctx.geometry)
        return (*(d if need else None for d, need in zip(grads, ctx.needs_input_grad)),
                None, None)


def conv4head_bwd_plain(g, x, w12, b12, w3, w4, window_len: int, step: int):
    """Plain version of B2w and B2x: ``(dx, dw12, db12, dw3, dw4)``, the
    gradients of ``<g, fused_conv4_head_plain(x, ...)>``, by autograd (for
    a bf16 ``x``, through ``conv4head_bwd_bf16_plain``)."""
    with torch.enable_grad():
        ops = [t.detach().requires_grad_(True) for t in (x, w12, b12, w3, w4)]
        out = fused_conv4_head_plain(*ops, window_len, step)
        return torch.autograd.grad(out, ops, g)


def _check_cuda(x, w12, b12, w3, w4, window_len: int, step: int, g=None):
    """Validate stacked CUDA operands for the kernels; returns the geometry."""
    m, b, c, t, z, o, k1, k2, n = _geometry(x, w12, w3, window_len, step)
    f32 = torch.float32
    _lib.require_cuda("x", x, x.dtype if x.dtype in X_DTYPES else f32)
    _lib.require_cuda("w12", w12, f32, (m, z * o, k1 * c))
    _lib.require_cuda("b12", b12, f32, (m, z * o, 1))
    _lib.require_cuda("w3", w3, f32, (m, z, o, k2 * o))
    _lib.require_cuda("w4", w4, f32, (m, z, o, k2 * o))
    if g is not None:
        _lib.require_cuda("g", g, f32, (m, b, n, z * o))
    if x.dtype == torch.bfloat16 and t % 2:
        raise ValueError(f"the bf16 head kernels copy x in 4-byte pairs: T must be even, got T={t}")
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
    bf16 = x.dtype == torch.bfloat16
    smem = lib.isd_conv4head_bf16_smem_bytes if bf16 else lib.isd_conv4head_smem_bytes
    _check_smem(smem(c, window_len, o, k1), "B2f-bf16" if bf16 else "B2f")
    x, w3, w4 = (_aligned16(x) if bf16 else x), _aligned16(w3), _aligned16(w4)
    s = _trial_splits(m, b, z, n, x.device)
    out = torch.empty((m, b, n, z * o), dtype=torch.float32, device=x.device)
    entry = lib.isd_conv4head_fwd_bf16 if bf16 else lib.isd_conv4head_fwd
    with torch.cuda.device(x.device):
        code = entry(
            x.data_ptr(), w12.data_ptr(), b12.data_ptr(), w3.data_ptr(), w4.data_ptr(),
            out.data_ptr(), m, b, c, t, z, o, k1, k2, window_len, step, n, s,
            _lib.stream_of(x),
        )
    _lib.check(code, entry.__name__)
    if bf16:
        fused_conv4_head.launches_bf16 += 1
    else:
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
    """B2w: ``(dw12, db12, dw3, dw4)`` of ``<g, fused_conv4_head(x, ...)>``;
    B2w-bf16 for a bf16 ``x`` (any C), B2w for an f32 one (C % 8 == 0)."""
    if x.device.type == "cpu":
        return conv4head_bwd_plain(g, x, w12, b12, w3, w4, window_len, step)[1:]
    bf16 = x.dtype == torch.bfloat16
    _, _, c, _, _, _, k1, k2, _ = _geometry(x, w12, w3, window_len, step)
    _check_taps(k1, k2)
    if not bf16:
        _check_bwd_w_channels(c)
    m, b, c, t, z, o, k1, k2, n = _check_cuda(x, w12, b12, w3, w4, window_len, step, g)
    lib = _lib.library()
    smem = lib.isd_conv4head_bwd_w_bf16_smem_bytes if bf16 else lib.isd_conv4head_bwd_w_smem_bytes
    _check_smem(smem(c, window_len, o, k1), "B2w-bf16" if bf16 else "B2w")
    x = _aligned16(x) if bf16 else x
    w12, w3, w4 = _aligned16(w12), _aligned16(w3), _aligned16(w4)
    s = _trial_splits(m, b, z, n, x.device)
    p = n * s
    grads = [torch.empty((m,) + tuple(w.shape[1:]), dtype=torch.float32, device=x.device)
             for w in (w12, b12, w3, w4)]
    parts = [torch.empty((m, p) + tuple(w.shape[1:]), dtype=torch.float32, device=x.device)
             for w in (w12, b12, w3, w4)]
    entry = lib.isd_conv4head_bwd_w_bf16 if bf16 else lib.isd_conv4head_bwd_w
    with torch.cuda.device(x.device):
        code = entry(
            g.data_ptr(), x.data_ptr(), w12.data_ptr(), b12.data_ptr(), w3.data_ptr(),
            w4.data_ptr(), *(t_.data_ptr() for t_ in grads), *(t_.data_ptr() for t_ in parts),
            m, b, c, t, z, o, k1, k2, window_len, step, n, s, _lib.stream_of(x),
        )
    _lib.check(code, entry.__name__)
    if bf16:
        conv4head_bwd_w.launches_bf16 += 1
    else:
        conv4head_bwd_w.launches += 1
    return tuple(grads)


# B2x's time for one unit (one trial, window and zone) on one SM at full
# width: 47.6 us on an H100 80GB HBM3 at 700 W (1.522 ms for 4 waves of
# 8-zone blocks at M = 1, B = 100; PERF.md). _bwd_x_zone_splits weighs it
# against the bytes of the pass that a zone split adds.
X_UNIT_S = 47.6e-6
HBM_BYTES_S = 3.35e12


def _bwd_x_zone_splits(m: int, b: int, n: int, z: int, c: int, w: int, sms: int) -> int:
    """SZ, B2x's zone ranges per (model, trial, window). A block fills an
    SM, so the kernel takes about its waves of blocks times a block's
    zones; SZ > 1 adds a pass over SZ + 1 copies of dxw. The least
    estimate wins, ties to fewer ranges."""
    def seconds(sz):
        waves = -(-m * b * n * sz // sms)
        extra = (sz + 1) * m * b * n * c * w * 4 / HBM_BYTES_S if sz > 1 else 0.0
        return waves * -(-z // sz) * X_UNIT_S + extra

    return min(range(1, z + 1), key=lambda sz: (seconds(sz), sz))


def conv4head_bwd_x_plain(g, x, w12, b12, w3, w4, window_len: int, step: int):
    """Plain version of B2x alone: ``dx`` of ``<g, fused_conv4_head_plain(x, ...)>``
    by autograd, with the weights held out of the graph."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        out = fused_conv4_head_plain(xg, *(t.detach() for t in (w12, b12, w3, w4)),
                                     window_len, step)
        return torch.autograd.grad(out, xg, g)[0]


def conv4head_bwd_x(g, x, w12, b12, w3, w4, window_len: int, step: int):
    """B2x: ``dx`` of ``<g, fused_conv4_head(x, ...)>``. The kernel writes
    per-window gradients; the overlapping windows are added here, in plain
    PyTorch, as the JAX package adds them in XLA."""
    if x.device.type == "cpu":
        return conv4head_bwd_x_plain(g, x, w12, b12, w3, w4, window_len, step)
    return _launch_bwd_x(g, x, w12, b12, w3, w4, window_len, step)


def _launch_bwd_x(g, x, w12, b12, w3, w4, window_len: int, step: int, sz=None):
    """B2x with ``sz`` zone ranges per (model, trial, window), or with
    ``_bwd_x_zone_splits``'s when None."""
    if x.dtype == torch.bfloat16:
        raise NotImplementedError(
            "B2x has no bf16 instantiation yet (see ROADMAP.md, Queue 2): no entry point takes "
            "an input gradient in bf16; hold x in float32 to differentiate with respect to it"
        )
    m, b, c, t, z, o, k1, k2, n = _check_cuda(x, w12, b12, w3, w4, window_len, step, g)
    _check_taps(k1, k2)
    if sz is None:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        sz = _bwd_x_zone_splits(m, b, n, z, c, window_len, sms)
    lib = _lib.library()
    _check_smem(lib.isd_conv4head_bwd_x_smem_bytes(c, window_len, o, k1), "B2x")
    w3, w4 = _aligned16(w3), _aligned16(w4)
    dxw = torch.empty((m, b, n, c, window_len), dtype=torch.float32, device=x.device)
    part = (torch.empty((m, b, n, sz, c, window_len), dtype=torch.float32, device=x.device)
            if sz > 1 else None)
    with torch.cuda.device(x.device):
        code = lib.isd_conv4head_bwd_x(
            g.data_ptr(), x.data_ptr(), w12.data_ptr(), b12.data_ptr(), w3.data_ptr(),
            w4.data_ptr(), dxw.data_ptr(), None if part is None else part.data_ptr(),
            m, b, c, t, z, o, k1, k2, window_len, step, n, sz, _lib.stream_of(x),
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
fused_conv4_head.launches_bf16 = 0  # B2f-bf16 launches
conv4head_bwd_w.launches = 0  # B2w launches
conv4head_bwd_w.launches_bf16 = 0  # B2w-bf16 launches
conv4head_bwd_x.launches = 0  # B2x launches
