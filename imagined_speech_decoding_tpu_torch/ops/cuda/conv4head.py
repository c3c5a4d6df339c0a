"""Fused sliding-window Conv4Layers head: CUDA kernels B2f (forward), B2w
(weight gradients) and B2x (input gradient), their general-geometry
counterparts B2f-g, B2w-g and B2x-g, and their plain PyTorch version.

Replaces ``imagined_speech_decoding_tpu/ops/pallas/conv4head.py``:
``_fwd_impl`` / ``_fwd_kernel`` (B2f, ``csrc/conv4head.cu``) and the
custom VJP's ``_bwd_rule`` with ``_bwd_w_kernel`` (B2w) and
``_bwd_x_kernel`` (B2x), both in ``csrc/conv4head_bwd.cu``. Each source's
header says what bounds it on the H100 and what the design does about it.
All three run on the tensor cores in 3xTF32 (f32 accuracy), sharing one
conv helper (``csrc/conv4head_tc.cuh``); they are built for O = 32 and
K1 = K2 = 5, and their plans hold a block's window and activations in
shared memory, so their reach is bounded: B2f and B2x up to C = 72 and 64
at windows of 250, windows of 284 at C = 64. B2w needs C to be a multiple
of 8 (``_adapted`` pads it) and takes C up to 72 at every window: the
whole window up to 292 samples at C <= 64 and 268 at C = 72, past that in
column tiles of 256 conv rows with a recomputed 8-row halo (``col_tiles``,
B2w-bf16's geometry), whose plan does not grow with the window; C > 72
fits neither plan.

The precision is x's dtype, as in the Pallas kernel (``dt = xt.dtype``):
an f32 x takes the kernels above; a bf16 x takes their bf16
instantiations B2f-bf16 (``csrc/conv4head_fwd_bf16.cu``: the first conv
once per trial over the columns its windows use, every product one bf16
``wgmma`` pass) and B2w-bf16 (``csrc/conv4head_bwd_w_bf16.cu``, one bf16
``wgmma`` pass per product, the weight gradients held in registers across
a block's trials; a window past 260 samples in column tiles of 256 conv
rows with a recomputed 8-row halo), f32 accumulators, rounding where the
Pallas kernel rounds (an even T; B2w-bf16 C <= 64, any window). The weights come in as
f32 either way and the kernels round them to bf16 as they stage them; the
output and every weight gradient are f32.

The general kernels (``csrc/conv4head_general.cu``, f32 and bf16) take
any C, T, window, step and O at K1 = K2 = 5: their shared memory does not
grow with C, W or O (a unit's intermediates sit in a global workspace, a
slot per resident block). They run where no tuned plan fits, where O >
32, and for every bf16 input gradient (B2x-g bf16, the only one).

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

Routing: a CPU tensor goes to ``fused_conv4_head_plain`` (without a
gradient to take, through the ``isd::conv4head_fwd`` operator of
``library.py``, which launches B2f on a CUDA tensor). In f32 autograd
differentiates it; that autograd backward is the plain version of B2w and
B2x (``conv4head_bwd_plain``; B2x's alone, dx with the weights held out
of the graph, is ``conv4head_bwd_x_plain``). In bf16 it rounds at the
Pallas kernel's points, and its gradient is the written-out bf16 backward
(``conv4head_bwd_bf16_plain``), which rounds the cotangents where
``_bwd_zone`` does. Off the CPU every wrapper launches a kernel or
raises; nothing falls back. ``_adapted`` picks the kernel from the
geometry before any launch: a geometry a tuned kernel is not built for
but reaches exactly by zero padding (``dim_cnn`` 8 or 16, f32 B2w at C %
8 != 0, an odd T in bf16, a B2f-bf16 trial longer than its plan holds)
launches it on padded or split operands and adds one to the wrapper's
``adapted``; so does a bf16 geometry the bf16 kernel has no plan for (C >
64 in B2w-bf16), run on the f32 kernel with the bf16 kernel's operands
where that kernel's plan fits; the rest (no tuned plan fitting, O > 32, a
bf16 input gradient) launches the general kernel of x's precision,
counted in ``launches_general`` / ``launches_general_bf16``. K != 5
raises. On CUDA the kernel forward is a ``torch.autograd.Function``: it
saves only its operands, and its backward recomputes the forward inside
B2w (when any weight operand needs a gradient) and B2x (only when ``x``
needs one; training never asks), each routed the same way.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import _lib

KERNEL_WIDTH = 32  # the O the kernels are instantiated for
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
    h = _conv1_windows(x, w12, window_len, step).unflatten(3, (z, o))
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
    h1 = _bf16(h.unflatten(3, (z, o)) + b12.view(m, 1, 1, z, o, 1))
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
    if any(t_.device != x.device for t_ in (w12, b12, w3, w4) + ((g,) if g is not None else ())):
        raise ValueError("head operands must share x's device")
    if max(m, b) > MAX_GRID:
        raise ValueError(f"{m} models or {b} trials exceed the kernel grid's {MAX_GRID}")
    return m, b, c, t, z, o, k1, k2, n


def _require_x(x) -> None:
    """A wrapper's first check off the CPU, before any operand is adapted:
    x on the card, in a dtype the kernels take (``_check_cuda`` checks the
    rest at the launch)."""
    _lib.require_cuda("x", x, x.dtype if x.dtype in X_DTYPES else torch.float32)


def _widen(w12, b12, w3, w4, o: int):
    """The weights of a head of O-wide zones, zero-padded to KERNEL_WIDTH
    channels a zone (the padded rows of w12 and b12, and the padded rows
    and input columns of w3 and w4, zero)."""
    m, zo, kc = w12.shape
    z, p = zo // o, KERNEL_WIDTH - o

    def same(w):
        k = w.shape[-1] // o
        return F.pad(w.reshape(m, z, o, k, o), (0, p, 0, 0, 0, p)).reshape(
            m, z, KERNEL_WIDTH, k * KERNEL_WIDTH)

    return (F.pad(w12.reshape(m, z, o, kc), (0, 0, 0, p)).reshape(m, z * KERNEL_WIDTH, kc),
            F.pad(b12.reshape(m, z, o, 1), (0, 0, 0, p)).reshape(m, z * KERNEL_WIDTH, 1),
            same(w3), same(w4))


def _narrow(t, o: int, dims: int):
    """``t`` with KERNEL_WIDTH-wide zone channels cut back to O: the last
    axis (Z*O features or a bias, ``dims`` 1), rows and columns of w3 / w4
    (``dims`` 2), or rows of w12 (``dims`` 0: axis 1)."""
    if dims == 0:
        m, zo, kc = t.shape
        return t.reshape(m, -1, KERNEL_WIDTH, kc)[:, :, :o].reshape(m, -1, kc)
    if dims == 1:
        return t.reshape(*t.shape[:-1], -1, KERNEL_WIDTH)[..., :o].reshape(*t.shape[:-1], -1)
    m, z = t.shape[:2]
    return t.reshape(m, z, KERNEL_WIDTH, -1, KERNEL_WIDTH)[:, :, :o, :, :o].reshape(m, z, o, -1)


def _even_span(x, s0: int, length: int):
    """Samples [s0, s0 + length) of x's trials in a tensor of its own, one
    zero sample appended when ``length`` is odd (the bf16 kernels copy x in
    4-byte pairs: T even)."""
    span = x[..., s0:s0 + length]
    return F.pad(span, (0, length % 2)) if length % 2 else span.contiguous()


def _fwd_bf16_windows(c: int, window_len: int, step: int, n: int, smem_bytes) -> int:
    """Windows a B2f-bf16 launch takes: the most, up to N, whose plan
    ``smem_bytes(c, window_len, step, windows, KERNEL_WIDTH, KERNEL_TAPS)``
    (the library's ``isd_conv4head_fwd_bf16_smem_bytes``) fits a block; the
    block holds the h1 of all its windows, so a longer trial, or a wider
    one, runs in groups of windows."""
    for g in range(n, 0, -1):
        if smem_bytes(c, window_len, step, g, KERNEL_WIDTH, KERNEL_TAPS) <= MAX_SMEM_BYTES:
            return g
    raise ValueError(f"B2f-bf16 is not built for C={c} at windows of {window_len}: "
                     f"{smem_bytes(c, window_len, step, 1, KERNEL_WIDTH, KERNEL_TAPS)} bytes "
                     f"for one window, {MAX_SMEM_BYTES} a block")


@functools.lru_cache(maxsize=64)
def _fwd_bf16_windows_built(c: int, window_len: int, step: int, n: int) -> int:
    """``_fwd_bf16_windows`` on the library's own plan size (kept: a step
    asks the same)."""
    return _fwd_bf16_windows(c, window_len, step, n,
                             _lib.library().isd_conv4head_fwd_bf16_smem_bytes)


@functools.lru_cache(maxsize=64)
def _bwd_w_bf16_bytes_built(c: int, window_len: int) -> int:
    """The library's ``isd_conv4head_bwd_w_bf16_smem_bytes`` at O = 32, K = 5."""
    return _lib.library().isd_conv4head_bwd_w_bf16_smem_bytes(c, window_len, KERNEL_WIDTH,
                                                              KERNEL_TAPS)


def _bf16_refusal(op: str, c: int, window_len: int, step: int, n: int, smem_bytes,
                  bwd_w_smem_bytes):
    """Why B2f-bf16 (``op`` "fwd") or B2w-bf16 ("bwd_w") takes no plan for C
    channels at windows of ``window_len``, or None: B2f-bf16 when not even
    one window's plan fits a block, B2w-bf16 past its weight-gradient
    registers (C > 64; its column tiles take any window). Plan
    sizes from the library, or from ``smem_bytes`` / ``bwd_w_smem_bytes``
    (the Python mirrors: ``fwd_bf16_plan``, ``bwd_w_bf16_smem_bytes``)."""
    if op == "fwd":
        try:
            if smem_bytes is None:
                _fwd_bf16_windows_built(c, window_len, step, n)
            else:
                _fwd_bf16_windows(c, window_len, step, n, smem_bytes)
        except ValueError as e:
            return str(e)
        return None
    nbytes = (_bwd_w_bf16_bytes_built(c, window_len) if bwd_w_smem_bytes is None
              else bwd_w_smem_bytes(c, window_len, KERNEL_WIDTH, KERNEL_TAPS))
    if 0 <= nbytes <= MAX_SMEM_BYTES:
        return None
    return (f"B2w-bf16 is not built for C={c} at windows of {window_len}: "
            + ("its weight-gradient tiles exceed the registers" if nbytes < 0
               else f"{nbytes} bytes a block, {MAX_SMEM_BYTES} on the card"))


def _adapted(op: str, launch, g, x, w12, b12, w3, w4, window_len: int, step: int,
             smem_bytes=None, bwd_w_smem_bytes=None, general=None):
    """``op``'s result ("fwd": the features, "bwd_w": ``(dw12, db12, dw3,
    dw4)``, "bwd_x": dx) from ``launch(g, x, w12, b12, w3, w4, window_len,
    step)``, a tuned kernel's launch, given operands of a geometry it is
    built for, and whether the operands had to be adapted to it first. Each
    adaptation is exact (a zero weight or sample adds exact zeros to every
    sum; a window's outputs do not depend on the others):
      O < KERNEL_WIDTH (dim_cnn 8, 16): every zone zero-padded to 32
        channels, the outputs and gradients cut back;
      f32 B2w at C % 8 != 0: x and w12 zero-padded to a multiple of 8
        channels, dw12 cut back;
      bf16 at an odd T: the samples the windows use, in a copy of even
        length, the cotangent padded with zero windows where that adds one;
      B2f-bf16 with more windows than its plan holds (``smem_bytes``, the
        library's by default): groups of windows, each on a copy of its
        samples.
    One adaptation is not exact: a bf16 geometry that B2f-bf16 or B2w-bf16
    takes no plan for (``_bf16_refusal``: B2w-bf16 at C > 64, B2f-bf16 at C >
    104 for windows of 250 or windows past 580 samples at C = 64) runs the
    f32 kernel (``_f32_route``) on the bf16 kernel's operands where that
    kernel's plan fits (B2w at C = 65-72, windows up to 268 samples): x as f32
    (exact), the weights rounded to bf16 and back, b12 and g as they are. It
    differs from the bf16 kernel by the bf16 roundings of h1, h2 and the
    cotangents that the f32 kernel does not make.
    What no tuned plan takes (``general_reason``) goes, unadapted, to
    ``general(op, g, x, ...)``, the general kernel of x's precision
    (``_launch_general`` by default). K1 or K2 != KERNEL_TAPS raises."""
    m, b, c, t, z, o, k1, k2, n = _geometry(x, w12, w3, window_len, step)
    if b == 0:  # a rank's empty share of a batch (parallel.mesh): nothing to launch
        if op == "fwd":
            return x.new_zeros((m, 0, n, z * o), dtype=torch.float32), False
        if op == "bwd_w":
            return tuple(torch.zeros_like(w, dtype=torch.float32)
                         for w in (w12, b12, w3, w4)), False
        return torch.zeros_like(x), False
    if k1 != KERNEL_TAPS or k2 != KERNEL_TAPS:
        raise ValueError(f"the head kernels are built for K1 = K2 = {KERNEL_TAPS}, "
                         f"got K1={k1}, K2={k2}")
    bf16 = x.dtype == torch.bfloat16
    refusal = (_bf16_refusal(op, c, window_len, step, n, smem_bytes, bwd_w_smem_bytes)
               if bf16 and op in ("fwd", "bwd_w") and o <= KERNEL_WIDTH else None)
    if general_reason(op, bf16, c, o, window_len, refusal):
        general = _launch_general if general is None else general
        return general(op, g, x, w12, b12, w3, w4, window_len, step), False
    if refusal:
        return _f32_route(op, launch, g, x, w12, b12, w3, w4, window_len, step), True
    wide = o < KERNEL_WIDTH
    pad_c = (-c) % 8 if op == "bwd_w" and not bf16 else 0
    per = n
    if bf16 and op == "fwd":
        per = (_fwd_bf16_windows_built(c, window_len, step, n) if smem_bytes is None
               else _fwd_bf16_windows(c, window_len, step, n, smem_bytes))
    copies = bf16 and (t % 2 == 1 or per < n)
    if not (wide or pad_c or copies):
        return launch(g, x, w12, b12, w3, w4, window_len, step), False
    if wide:
        w12, b12, w3, w4 = _widen(w12, b12, w3, w4, o)
        g = None if g is None else F.pad(g.reshape(m, b, n, z, o), (0, KERNEL_WIDTH - o)).reshape(
            m, b, n, -1)
    if pad_c:
        x = F.pad(x, (0, 0, 0, pad_c))
        w12 = F.pad(w12.reshape(m, -1, k1, c), (0, pad_c)).reshape(m, -1, k1 * (c + pad_c))
    parts = []
    for n0 in range(0, n, per):
        cnt = min(per, n - n0)
        xg, gg = x, g
        if copies:
            xg = _even_span(x, n0 * step, (cnt - 1) * step + window_len)
            extra = (xg.shape[-1] - window_len) // step + 1 - cnt  # 1 at step 1 and odd spans
            gg = None if g is None else F.pad(g[:, :, n0:n0 + cnt], (0, 0, 0, extra))
        out = launch(gg, xg, w12, b12, w3, w4, window_len, step)
        parts.append(out[:, :, :cnt] if op == "fwd" else out)
    if op == "fwd":
        out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=2)
        out = _narrow(out, o, 1) if wide else out
    elif op == "bwd_w":
        dw12, db12, dw3, dw4 = parts[0]
        if pad_c:
            dw12 = dw12.reshape(m, -1, k1, c + pad_c)[..., :c].reshape(m, -1, k1 * c)
        if wide:
            dw12, db12, dw3, dw4 = (_narrow(dw12, o, 0), _narrow(db12.reshape(m, 1, -1), o, 1)
                                    .reshape(m, -1, 1), _narrow(dw3, o, 2), _narrow(dw4, o, 2))
        out = (dw12, db12, dw3, dw4)
    else:
        out = parts[0]
    return out, True


def f32_plan_fits(op: str, c: int, window_len: int, tiles: bool = True) -> bool:
    """Whether the tuned f32 kernel of ``op`` (B2f, B2w or B2x) has a plan
    for C channels at windows of ``window_len`` that fits a block, after
    ``_adapted``'s padding (O to 32, B2w's C to a multiple of 8), by the
    Python mirrors of the library's plans (the card tests hold them equal).
    B2w's column tiles count only with ``tiles``; without, its whole
    window's plan must fit."""
    if op == "fwd":
        nbytes = fwd_smem_bytes(c, window_len)
    elif op == "bwd_w":
        plan = bwd_w_smem_bytes if tiles else bwd_w_plan_bytes
        nbytes = plan(c + (-c) % 8, window_len)
    else:
        nbytes = bwd_x_smem_bytes(c, window_len)
    return nbytes <= MAX_SMEM_BYTES


def general_reason(op: str, bf16: bool, c: int, o: int, window_len: int, refusal) -> str:
    """Why ``op`` goes to the general kernel of its precision, or "" when a
    tuned kernel takes it: O > KERNEL_WIDTH; a bf16 input gradient (no
    tuned bf16 B2x); or no tuned plan fitting: f32 where the f32 plan (B2w:
    in column tiles past its whole window's) does not fit, bf16 where the
    bf16 kernel refuses (``refusal``) and its f32 route's whole-window plan
    does not fit either."""
    if o > KERNEL_WIDTH:
        return f"O = {o} > {KERNEL_WIDTH}"
    if bf16 and op == "bwd_x":
        return "a bf16 input gradient"
    if (refusal or not bf16) and not f32_plan_fits(op, c, window_len, tiles=not refusal):
        return (f"{refusal}; " if refusal else "") + (
            f"the f32 plan does not fit a block at C={c}, windows of {window_len}")
    return ""


def _f32_route(op: str, launch, g, x, w12, b12, w3, w4, window_len: int, step: int):
    """``op`` of a bf16 x on the f32 kernel (through ``_adapted``'s f32
    adaptations), on the operands the bf16 kernel would read: f32 copies of
    x and of the weights rounded to bf16 (b12 and g are f32 already)."""
    out, _ = _adapted(op, launch, g, x.float(), _bf16(w12), b12, _bf16(w3), _bf16(w4),
                      window_len, step)
    return out


def _check_smem(nbytes: int, what: str) -> None:
    """Raises where a block of ``what`` does not fit the card, or where its
    library size entry says (-1) that the kernel takes no such geometry."""
    if nbytes < 0:
        raise ValueError(f"{what} is not built for this geometry (see its source's header)")
    if nbytes > MAX_SMEM_BYTES:
        raise ValueError(
            f"one {what} block needs {nbytes} bytes of shared memory; "
            f"the card allows {MAX_SMEM_BYTES}"
        )


def _launch_fwd(x, w12, b12, w3, w4, window_len: int, step: int, clk=None):
    """B2f, or B2f-bf16 for a bf16 ``x``. ``clk`` (bf16 only: a CUDA int64
    tensor of ``len(FWD_BF16_PHASES) + 2`` zeros) launches B2f-bf16's debug
    instantiation instead, which adds to it each phase's clock cycles
    summed over warps and blocks, then every block's cycles and
    nanoseconds; such a launch is not counted."""
    m, b, c, t, z, o, k1, k2, n = _check_cuda(x, w12, b12, w3, w4, window_len, step)
    lib = _lib.library()
    bf16 = x.dtype == torch.bfloat16
    if bf16:  # a persistent grid: at most one block per SM, each a run of (model, zone, trial)
        _check_smem(lib.isd_conv4head_fwd_bf16_smem_bytes(c, window_len, step, n, o, k1),
                    "B2f-bf16")
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        s = min(m * z * b, sms)
    else:
        _check_smem(lib.isd_conv4head_smem_bytes(c, window_len, o, k1), "B2f")
        s = _trial_splits(m, b, z, n, x.device)
    x, w3, w4 = (_aligned16(x) if bf16 else x), _aligned16(w3), _aligned16(w4)
    out = torch.empty((m, b, n, z * o), dtype=torch.float32, device=x.device)
    entry = lib.isd_conv4head_fwd_bf16 if bf16 else lib.isd_conv4head_fwd
    extra = ()
    if clk is not None:
        if not bf16:
            raise ValueError("only B2f-bf16 has a debug instantiation with phase counters")
        _lib.require_cuda("clk", clk, torch.int64, (len(FWD_BF16_PHASES) + 2,))
        entry, extra = lib.isd_conv4head_fwd_bf16_phases, (clk.data_ptr(),)
    with torch.cuda.device(x.device):
        code = entry(
            x.data_ptr(), w12.data_ptr(), b12.data_ptr(), w3.data_ptr(), w4.data_ptr(),
            out.data_ptr(), m, b, c, t, z, o, k1, k2, window_len, step, n, s, *extra,
            _lib.stream_of(x),
        )
    _lib.check(code, entry.__name__)
    if clk is None and bf16:
        _lib.count(fused_conv4_head, "launches_bf16")
    elif clk is None:
        _lib.count(fused_conv4_head)
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


# B2w-bf16's shared-memory plan and wgmma descriptors, mirrored from
# csrc/conv4head_bwd_w_bf16.cu (wg_plan, col_tile, conv_issue, dw_issue and
# the tiles' sources) and csrc/wgmma_bf16.cuh for the tests: every time-major buffer is stored in
# chunks of 8 channels, [chunk][row][8] bf16, so the bytes of (row, channel)
# are chunk_offset(cs, row, channel) from the buffer's start.
WG_ROWS = 64  # rows of a wgmma tile: a warpgroup's share of time, or of (tap, channel)
WG_GROUPS = 4  # warpgroups of a B2w-bf16 block (16 warps)
WG_SLOTS = 3  # weight-gradient tiles a warpgroup holds in registers
WG_EDGE_ROWS = 16  # rows of a masked edge chunk (one k16 step over time)
# Column tiles of B2w and B2w-bf16 (csrc/conv4head_common.cuh): a window
# whose plan does not fit a block runs in tiles of at most COL_SPAN conv
# rows (B2w-bf16: WG_GROUPS x WG_ROWS; B2w: 16 warps x 2 tiles of 8).
COL_SPAN = 256  # rows a column tile computes at most
COL_HALO = 8  # rows recomputed at a column tile's interior edge
COL_STEP = COL_SPAN - 2 * COL_HALO  # window columns between two column tiles
F32_ROWS = 8  # B2w's time tile: one mma.sync reduction step over time


def col_tiles(t1: int, w: int, k: int, rows: int) -> list:
    """The column tiles of a window of ``w`` samples (``t1`` conv rows)
    that a kernel computing ``rows`` time rows at a time runs it in (the
    kernels' ``col_tile``: B2w-bf16 ``rows`` = WG_ROWS, B2w F32_ROWS), in
    the tile's own rows (row r is the window's conv row s + r): ``s`` its
    first column, ``nt`` the rows it computes, ``e`` the first row past the
    window's end, ``[lo, hi)`` the rows it owns, ``cols`` the window
    columns it reads, ``left`` / ``right`` whether it has an interior edge
    there. One tile up to t1 = COL_SPAN, else ceil((t1 - 2 COL_HALO) /
    COL_STEP); the owned ranges cover [0, t1) once."""
    span = min(-(-t1 // rows) * rows, COL_SPAN)
    count = 1 if t1 <= COL_SPAN else -(-(t1 - 2 * COL_HALO) // COL_STEP)
    tiles = []
    for j in range(count):
        s = j * COL_STEP
        e = t1 - s
        nt = min(-(-e // rows) * rows, span)
        left, right = j > 0, j + 1 < count
        tiles.append({"s": s, "nt": nt, "e": e, "lo": COL_HALO if left else 0,
                      "hi": span - COL_HALO if right else e,
                      "cols": min(nt + k - 1, w - s), "left": left, "right": right})
    return tiles


def bwd_w_bf16_plan(c: int, w: int, o: int = 32, k: int = KERNEL_TAPS) -> dict:
    """B2w-bf16's plan for C channels and windows of W: the byte offset of
    every shared-memory region, the total, and the geometry:
      cp    channels of the staged window and w12 (C rounded up to 64: one
            dw12 tile is 64 channels of one tap);
      nt    time rows a column tile computes (t1 rounded up to WG_ROWS, at
            most COL_SPAN);
      tiles column tiles of a window (``col_tiles``);
      rows  rows of every time-major buffer (nt + K - 1: the farthest tap);
      cs    bytes between two chunks of 8 channels (rows * 16);
      n34, n12  weight-gradient tiles of dw3 (= of dw4) and of dw12.
    h1 and h2 carry 2*O/8 chunks: O channels, then a copy one row down, so
    one 64-row dw3 / dw4 tile spans two taps at one chunk stride. ``mk``
    (column tiles only) holds the masked edge chunks of dh3c and dh2c,
    [dh3c, dh2c][left, right], each [o chunk][WG_EDGE_ROWS rows][8]."""
    cp = -(-c // WG_ROWS) * WG_ROWS
    t1 = w - k + 1
    nt = min(-(-t1 // WG_ROWS) * WG_ROWS, COL_SPAN)
    tiles = len(col_tiles(t1, w, k, WG_ROWS))
    rows = nt + k - 1
    cs = 16 * rows
    rw = (min(w, rows) + 2) & ~1
    plan = {"c": c, "w": w, "o": o, "k": k, "cp": cp, "t1": t1, "nt": nt, "tiles": tiles,
            "rows": rows, "cs": cs, "rw": rw, "n34": -(-k * o // WG_ROWS),
            "n12": k * cp // WG_ROWS}
    off = 0
    # raw holds C rows, cp in column tiles: every column-tile plan has one layout
    for name, nbytes in (("xs", cp // 8 * cs), ("raw", 2 * (cp if tiles > 1 else c) * rw),
                         ("h1", o // 4 * cs), ("h2", o // 4 * cs),
                         ("d3", o // 8 * cs), ("d2", o // 8 * cs), ("d1", o // 8 * cs),
                         ("w12", 2 * k * cp * o), ("w3", 2 * k * o * o), ("w4", 2 * k * o * o),
                         ("bias", 4 * o), ("gz", 4 * o), ("red", 4 * 4 * WG_GROUPS * o),
                         ("mk", 4 * (o // 8) * 16 * WG_EDGE_ROWS if tiles > 1 else 0)):
        plan[name] = off
        off += -(-nbytes // 16) * 16
    plan["total"] = off
    return plan


def bwd_w_bf16_col_tiles(plan: dict) -> list:
    """B2w-bf16's column tiles of a window (``col_tiles`` in 64-row tiles;
    an interior edge has a masked edge chunk)."""
    return col_tiles(plan["t1"], plan["w"], plan["k"], WG_ROWS)


def bwd_w_bf16_edge(plan: dict, which: str, side: str) -> int:
    """Byte offset of the masked edge chunk of ``which`` ("d3" or "d2") on
    ``side`` ("left" or "right"): [o chunk][WG_EDGE_ROWS rows][8], chunks
    16 * WG_EDGE_ROWS bytes apart."""
    i = 2 * ("d3", "d2").index(which) + ("left", "right").index(side)
    return plan["mk"] + i * (plan["o"] // 8) * 16 * WG_EDGE_ROWS


def bwd_w_bf16_smem_bytes(c: int, w: int, o: int = 32, k: int = KERNEL_TAPS) -> int:
    """The library's ``isd_conv4head_bwd_w_bf16_smem_bytes``: the plan's
    bytes, or -1 where its weight-gradient tiles exceed the registers,
    WG_SLOTS a warpgroup (C > 64)."""
    plan = bwd_w_bf16_plan(c, w, o, k)
    return -1 if len(bwd_w_bf16_tiles(plan)) > WG_SLOTS * WG_GROUPS else plan["total"]


def _stride_4mod8(v: int) -> int:
    return ((v + 3) & ~7) + 4


def _round_up4(v: int) -> int:
    return (v + 3) & ~3


def _tc_strides(ch: int, w: int, o: int, k: int):
    """``isd::tc_strides`` (csrc/conv4head_tc.cuh): ``(nt8, ld, lw1, lw)``."""
    nt8 = (w - k + 1 + 7) & ~7
    return nt8, _stride_4mod8(nt8 + k - 1), _stride_4mod8(k * ch), _stride_4mod8(k * o)


def fwd_smem_bytes(c: int, w: int, o: int = 32, k: int = KERNEL_TAPS) -> int:
    """The library's ``isd_conv4head_smem_bytes`` (B2f's ``fwd_plan``,
    csrc/conv4head.cu)."""
    cp = (c + 7) & ~7
    _, ld, lw1, lw = _tc_strides(cp, w, o, k)
    floats = (_round_up4(cp * ld) + 2 * _round_up4(o * ld) + _round_up4(o * lw1)
              + 2 * _round_up4(o * lw) + _round_up4(o))
    return 4 * floats


def bwd_w_plan_bytes(c: int, w: int, o: int = 32, k: int = KERNEL_TAPS) -> int:
    """B2w's ``tc_plan`` for windows of ``w`` staged whole, in bytes
    (csrc/conv4head_bwd.cu; C a multiple of 8)."""
    _, ld, lw1, lw = _tc_strides(c, w, o, k)
    hsz = _round_up4(max(o * ld, 16 * lw1))
    rsz = _round_up4(max(c * ld, o * ld + hsz))
    return 4 * (2 * rsz + hsz + 2 * _round_up4(o * lw) + 2 * _round_up4(o))


def bwd_w_smem_bytes(c: int, w: int, o: int = 32, k: int = KERNEL_TAPS) -> int:
    """The library's ``isd_conv4head_bwd_w_smem_bytes`` (``w_plan``): the
    whole window's plan where it fits a block, else the column tiles'
    (the plan of windows of COL_SPAN + K - 1, whatever ``w`` is)."""
    whole = bwd_w_plan_bytes(c, w, o, k)
    return whole if whole <= MAX_SMEM_BYTES else bwd_w_plan_bytes(c, COL_SPAN + k - 1, o, k)


def bwd_w_col_tiles(c: int, w: int, o: int = 32, k: int = KERNEL_TAPS) -> list:
    """B2w's units of a window (``col_tiles``' keys; their count is the
    library's ``isd_conv4head_bwd_w_col_tiles``): the whole window where
    its plan fits a block, else ``col_tiles`` in 8-row tiles. The kernel
    reduces over [lo, hi) rounded up to 8 rows (rows from e on are zero)."""
    t1 = w - k + 1
    if bwd_w_plan_bytes(c, w, o, k) <= MAX_SMEM_BYTES:
        return [{"s": 0, "nt": -(-t1 // F32_ROWS) * F32_ROWS, "e": t1, "lo": 0, "hi": t1,
                 "cols": w, "left": False, "right": False}]
    return col_tiles(t1, w, k, F32_ROWS)


def bwd_x_smem_bytes(c: int, w: int, o: int = 32, k: int = KERNEL_TAPS) -> int:
    """The library's ``isd_conv4head_bwd_x_smem_bytes`` (B2x's ``x_plan``,
    csrc/conv4head_bwd.cu: C rounded up to 32)."""
    cp = (c + 31) & ~31
    _, ld, lw1, lw = _tc_strides(cp, w, o, k)
    ldx = _stride_4mod8(((w + 7) & ~7) + k - 1)
    floats = (_round_up4(cp * ld) + _round_up4(max(o * ld, o * ldx)) + _round_up4(o * ld)
              + _round_up4(o * lw1) + 2 * _round_up4(o * lw) + 2 * _round_up4(o))
    return 4 * floats


def chunk_offset(cs: int, row: int, ch: int) -> int:
    """Bytes of (row, channel) from the start of a chunked buffer."""
    return (ch // 8) * cs + 16 * row + 2 * (ch % 8)


def bwd_w_bf16_tiles(plan: dict) -> list:
    """The weight-gradient tiles in the kernel's order, ``(kind, index)``:
    dw4 and dw3 tiles p (taps 2p, 2p + 1), then dw12 tiles (tap, block of
    64 channels). Warpgroup ``i % WG_GROUPS`` holds tile ``i``."""
    blocks = plan["cp"] // WG_ROWS
    return ([("dw4", p) for p in range(plan["n34"])] + [("dw3", p) for p in range(plan["n34"])]
            + [("dw12", (i // blocks, i % blocks)) for i in range(plan["n12"])])


def bwd_w_bf16_conv_descs(plan: dict, src: str, tile: int, transposed: bool) -> list:
    """The k16 steps of one 64-row conv tile in issue order, each
    ``((a_start, k_step, mn_step), (b_start, k_step, mn_step))`` in bytes
    from the start of shared memory. A (time x channels, K-major) is
    ``src`` from row 64 tile + tap (a conv^T reads tap K-1-k); B is w12
    (src ``xs``), w3 (``h1``) or w4 (``h2``; ``d3`` and ``d2`` read w4 and
    w3 transposed, MN-major): staged [chunk of (tap, channel)][o][8]."""
    o, k, cs = plan["o"], plan["k"], plan["cs"]
    ch = plan["cp"] if src == "xs" else o
    w = {"xs": "w12", "h1": "w3", "h2": "w4", "d3": "w4", "d2": "w3"}[src]
    steps = []
    for tap in range(k):
        row = WG_ROWS * tile + (k - 1 - tap if transposed else tap)
        for c0 in range(0, ch, 16):
            a = (plan[src] + chunk_offset(cs, row, c0), cs, 128)
            if transposed:  # B[o'][o] = w[o'][tap * O + o]: N along the chunk, K along the rows
                b = (plan[w] + chunk_offset(16 * o, c0, tap * o), 128, 16 * o)
            else:  # B[(tap, c)][o] = w[o][tap * ch + c]: K along the chunk
                b = (plan[w] + chunk_offset(16 * o, 0, tap * ch + c0), 16 * o, 128)
            steps.append((a, b))
    return steps


def bwd_w_bf16_dw_descs(plan: dict, kind: str, index, tile: dict = None) -> list:
    """The k16 steps (16 time rows each) of one weight-gradient tile over
    column tile ``tile`` (``bwd_w_bf16_col_tiles``; the first by default),
    dw^T[(tap, i), o] = sum_t src[t + tap][i] d[t][o]: A = src (MN-major:
    time along K, channels along M), B = d from row K/2 (MN-major); dw4's
    and dw3's first and last steps read the masked edge chunk of dh3c or
    dh2c where the tile has an interior edge there."""
    k, cs = plan["k"], plan["cs"]
    tile = bwd_w_bf16_col_tiles(plan)[0] if tile is None else tile
    src, d = {"dw4": ("h2", "d3"), "dw3": ("h1", "d2"), "dw12": ("xs", "d1")}[kind]
    if kind == "dw12":
        tap, block = index
        a0 = plan[src] + chunk_offset(cs, tap, WG_ROWS * block)
    else:  # taps 2p (chunks 0..3) and 2p + 1 (the copy one row down, chunks 4..7)
        a0 = plan[src] + chunk_offset(cs, 2 * index, 0)
    b0 = plan[d] + chunk_offset(cs, k // 2, 0)
    steps = []
    for t0 in range(0, tile["nt"], 16):
        b = (b0 + 16 * t0, 128, cs)
        if kind != "dw12" and t0 == 0 and tile["left"]:
            b = (bwd_w_bf16_edge(plan, d, "left"), 128, 16 * WG_EDGE_ROWS)
        elif kind != "dw12" and t0 + 16 == tile["nt"] and tile["right"]:
            b = (bwd_w_bf16_edge(plan, d, "right"), 128, 16 * WG_EDGE_ROWS)
        steps.append(((a0 + 16 * t0, 128, cs), b))
    return steps


# B2f-bf16's shared-memory plan and wgmma descriptors, mirrored from
# csrc/conv4head_fwd_bf16.cu (fwd_plan, the h1 epilogue's window rows and
# the conv tiles' sources) for the tests. One block runs (model, zone,
# trial) items; a trial's first conv runs once over the h1 columns its
# windows use, in sub-blocks of FWD_SB rows (one 64-row tile a warpgroup),
# and each window's two 'same' convs read their own copy of its h1
# columns, stacked window after window with the zero pads between them.
FWD_SB = WG_GROUPS * WG_ROWS


def fwd_bf16_plan(c: int, w: int, step: int, n: int, o: int = 32, k: int = KERNEL_TAPS) -> dict:
    """B2f-bf16's plan for C channels and N windows of W at ``step``: the
    byte offset of every shared-memory region, the total, and the geometry:
      cp    channels of the staged x and w12 (C rounded up to 16);
      t1    a window's conv length; nt  its rows in 64-row tiles;
      lh    h1 columns the windows use, (N - 1) * step + t1; nsb sub-blocks;
      lx    x samples they read, (N - 1) * step + W;
      xr    rows of the staged x sub-block (FWD_SB + K - 1 up to 8s) and
            the raw sub-block's row stride in samples;
      rs    h1 rows a window takes: t1 and K - 1 zero pads; rows_h1, rows_h2;
      cs_x, cs_h1, cs_h2  bytes between two chunks of 8 channels.
    xs holds its chunks up to a multiple of 4 (the transpose stores four at
    a time); h2 has two buffers (a window's h2 is written while the one
    before is read); red two slots of the GELU team's per-warp column sums."""
    cp = -(-c // 16) * 16
    t1 = w - k + 1
    nt = -(-t1 // WG_ROWS) * WG_ROWS
    lh = (n - 1) * step + t1
    xr = -(-(FWD_SB + k - 1) // 8) * 8
    rs = t1 + k - 1
    rows_h1 = (n - 1) * rs + nt + k - 1
    rows_h2 = nt + k - 1
    plan = {"c": c, "w": w, "step": step, "n": n, "o": o, "k": k, "cp": cp, "t1": t1, "nt": nt,
            "lh": lh, "nsb": -(-lh // FWD_SB), "lx": (n - 1) * step + w, "xr": xr, "rs": rs,
            "rows_h1": rows_h1, "rows_h2": rows_h2, "cs_x": 16 * xr, "cs_h1": 16 * rows_h1,
            "cs_h2": 16 * rows_h2}
    off = 0
    for name, nbytes in (("xs", -(-cp // 32) * 4 * 16 * xr), ("raw", 2 * c * xr),
                         ("h1", o // 8 * 16 * rows_h1), ("h2", 2 * o // 8 * 16 * rows_h2),
                         ("w12", 2 * k * cp * o), ("w3", 2 * k * o * o), ("w4", 2 * k * o * o),
                         ("bias", 4 * o), ("red", 2 * 4 * 2 * WG_GROUPS * o)):
        plan[name] = off
        off += -(-nbytes // 16) * 16
    plan["total"] = off
    return plan


def fwd_bf16_h1_rows(plan: dict, u: int) -> list:
    """The h1 rows that column ``u`` of the sequence is stored at, as the
    kernel's epilogue walks them: row i * rs + K/2 + l of every window i
    that holds it at l = u - i * step < t1, from the last such window down."""
    rows, i = [], min(u // plan["step"], plan["n"] - 1)
    while i >= 0 and u - i * plan["step"] < plan["t1"]:
        rows.append(i * plan["rs"] + plan["k"] // 2 + u - i * plan["step"])
        i -= 1
    return rows


def fwd_bf16_conv_descs(plan: dict, conv: str, index: int, tile: int) -> list:
    """The k16 steps of one 64-row conv tile in issue order, each
    ``((a_start, k_step, mn_step), (b_start, k_step, mn_step))`` in bytes
    from the start of shared memory; A K-major (time x channels), B K-major
    (w staged [chunk of (tap, channel)][o][8]):
      "h1": x sub-block ``index``'s tile (rows 64 tile + tap of xs) by w12;
      "h2": window ``index``'s stacked h1 (rows index * rs + 64 tile + tap) by w3;
      "h3": h2's buffer ``index % 2`` (rows 64 tile + tap) by w4."""
    o, k = plan["o"], plan["k"]
    src, cs, row0, ch, w = {
        "h1": ("xs", plan["cs_x"], 0, plan["cp"], "w12"),
        "h2": ("h1", plan["cs_h1"], index * plan["rs"], o, "w3"),
        "h3": ("h2", plan["cs_h2"], 0, o, "w4")}[conv]
    base = plan[src] + (index % 2) * (o // 8) * cs if conv == "h3" else plan[src]
    steps = []
    for tap in range(k):
        for c0 in range(0, ch, 16):
            a = (base + chunk_offset(cs, row0 + WG_ROWS * tile + tap, c0), cs, 128)
            b = (plan[w] + chunk_offset(16 * o, 0, tap * ch + c0), 16 * o, 128)
            steps.append((a, b))
    return steps


# B2f-bf16's GELU, branch-free (a branch while a wgmma is in flight makes
# ptxas serialise every wgmma of the kernel): gelu(v) = max(v, 0) -
# |v| erfc(|v| / sqrt 2) / 2, with erfc(a / sqrt 2) / 2 = 2^(a * P(a) - 1)
# for a = min(|v|, GELU_CLAMP) (P of degree 4, least squares on [0,
# GELU_CLAMP] weighted by gelu's absolute error; past the clamp erfc is held
# at erfc(4) < 2e-8). |error| <= 7.5e-7 in f32, against 1.1e-6 for
# torch.nn.functional.gelu in f32 (tests/test_torch_conv4head_fwd_bf16_wgmma.py).
# The kernel holds the same numbers (csrc/conv4head_fwd_bf16.cu, kGeluP).
GELU_CLAMP = 5.656854152679443  # 4 sqrt 2, in f32
GELU_EXP2_POLY = (-1.1509909629821777, -0.4596169888973236, -0.05213385075330734,
                  0.007197307422757149, -0.0004884926602244377)


def gelu_fit(v: torch.Tensor) -> torch.Tensor:
    """B2f-bf16's GELU on an f32 tensor, in f32 as the kernel computes it
    (Horner from the top coefficient; exp2 exact here, ex2.approx there)."""
    a = v.abs()
    ac = torch.clamp(a, max=GELU_CLAMP)
    p = torch.full_like(v, GELU_EXP2_POLY[-1])
    for c in GELU_EXP2_POLY[-2::-1]:
        p = p * ac + c
    return torch.clamp(v, min=0.0) - a * torch.exp2(p * ac - 1.0)


# B2f-bf16's phases, in the order of the counters that its debug
# instantiation keeps (``_launch_fwd(..., clk=...)``; b2f_timing.py).
FWD_BF16_PHASES = ("stage", "copy", "h1", "h1_epilogue", "issue", "h3_wait", "gelu", "h2_wait",
                   "h2_epilogue", "out", "barrier")
# The debug instantiation's counter slots past the plan (a warp's 8 bytes a
# phase; phase_clock.cuh's clock_bytes), for the tests' fit at full width.
FWD_CLOCK_BYTES = 16 * 8 * len(FWD_BF16_PHASES)


def conv4head_bwd_w(g, x, w12, b12, w3, w4, window_len: int, step: int):
    """B2w: ``(dw12, db12, dw3, dw4)`` of ``<g, fused_conv4_head(x, ...)>``;
    B2w-bf16 for a bf16 ``x`` (C <= 64, any window: column tiles past 260
    samples), B2w for an f32 one (``_adapted`` pads C to a multiple of 8;
    C <= 72, any window: column tiles past its whole window's plan), B2w-g
    where neither plan fits (or O > 32)."""
    if x.device.type == "cpu":
        return conv4head_bwd_plain(g, x, w12, b12, w3, w4, window_len, step)[1:]
    _require_x(x)
    grads, adapted = _adapted("bwd_w", _launch_bwd_w, g, x, w12, b12, w3, w4, window_len, step)
    _lib.count(conv4head_bwd_w, "adapted", adapted)
    return grads


# B2w-bf16's phases, in the order of the counters that its debug
# instantiation keeps (``_launch_bwd_w(..., clk=...)``; b2w_timing.py).
BWD_W_BF16_PHASES = ("wait", "transpose", "conv1", "conv2", "conv3", "conv4T", "dw4", "conv3T",
                     "dw3", "dw12", "db12", "barrier")


def _launch_bwd_w(g, x, w12, b12, w3, w4, window_len: int, step: int, s=None, clk=None):
    """B2w or B2w-bf16 with ``s`` trial ranges per (model, zone, window),
    or ``_trial_splits``'s when None. ``clk`` (bf16 only: a CUDA int64
    tensor of ``len(BWD_W_BF16_PHASES) + 2`` zeros) launches the debug
    instantiation instead, which adds to it each phase's clock cycles
    summed over warps and blocks, then every block's cycles and
    nanoseconds; such a launch is not counted."""
    bf16 = x.dtype == torch.bfloat16
    m, b, c, t, z, o, k1, k2, n = _check_cuda(x, w12, b12, w3, w4, window_len, step, g)
    lib = _lib.library()
    smem = lib.isd_conv4head_bwd_w_bf16_smem_bytes if bf16 else lib.isd_conv4head_bwd_w_smem_bytes
    _check_smem(smem(c, window_len, o, k1), "B2w-bf16" if bf16 else "B2w")
    x = _aligned16(x) if bf16 else x
    w12, w3, w4 = _aligned16(w12), _aligned16(w3), _aligned16(w4)
    s = _trial_splits(m, b, z, n, x.device) if s is None else s
    p = n * s
    grads = [torch.empty((m,) + tuple(w.shape[1:]), dtype=torch.float32, device=x.device)
             for w in (w12, b12, w3, w4)]
    parts = [torch.empty((m, p) + tuple(w.shape[1:]), dtype=torch.float32, device=x.device)
             for w in (w12, b12, w3, w4)]
    entry = lib.isd_conv4head_bwd_w_bf16 if bf16 else lib.isd_conv4head_bwd_w
    extra = ()
    if clk is not None:
        if not bf16:
            raise ValueError("only B2w-bf16 has a debug instantiation with phase counters")
        _lib.require_cuda("clk", clk, torch.int64, (len(BWD_W_BF16_PHASES) + 2,))
        entry, extra = lib.isd_conv4head_bwd_w_bf16_phases, (clk.data_ptr(),)
    with torch.cuda.device(x.device):
        code = entry(
            g.data_ptr(), x.data_ptr(), w12.data_ptr(), b12.data_ptr(), w3.data_ptr(),
            w4.data_ptr(), *(t_.data_ptr() for t_ in grads), *(t_.data_ptr() for t_ in parts),
            m, b, c, t, z, o, k1, k2, window_len, step, n, s, *extra, _lib.stream_of(x),
        )
    _lib.check(code, entry.__name__)
    if clk is None and bf16:
        _lib.count(conv4head_bwd_w, "launches_bf16")
    elif clk is None:
        _lib.count(conv4head_bwd_w)
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
    """B2x: ``dx`` of ``<g, fused_conv4_head(x, ...)>`` in x's dtype; B2x-g
    bf16 for a bf16 ``x``. The kernels write per-window gradients; the
    overlapping windows are added here, in f32 plain PyTorch, as the JAX
    package adds them in XLA."""
    if x.device.type == "cpu":
        return conv4head_bwd_x_plain(g, x, w12, b12, w3, w4, window_len, step)
    _require_x(x)
    dx, adapted = _adapted("bwd_x", _launch_bwd_x, g, x, w12, b12, w3, w4, window_len, step)
    _lib.count(conv4head_bwd_x, "adapted", adapted)
    return dx


def _overlap_add(dxw, x, step: int):
    """dx (x's shape and dtype) from the per-window gradients ``dxw (M, B,
    N, C, W)``, summed in f32 in window order."""
    dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    window_len = dxw.shape[-1]
    for i in range(dxw.shape[2]):
        dx[..., i * step : i * step + window_len] += dxw[:, :, i]
    return dx.to(x.dtype)


def _launch_bwd_x(g, x, w12, b12, w3, w4, window_len: int, step: int, sz=None):
    """B2x with ``sz`` zone ranges per (model, trial, window), or with
    ``_bwd_x_zone_splits``'s when None."""
    m, b, c, t, z, o, k1, k2, n = _check_cuda(x, w12, b12, w3, w4, window_len, step, g)
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
    _lib.count(conv4head_bwd_x)
    return _overlap_add(dxw, x, step)


# The general kernels (csrc/conv4head_general.cu): each block of a
# persistent grid walks units in a workspace slot of buffers of O x t1
# floats (the library's isd_conv4head_general_slot_floats). A unit is a
# (model, trial, window, zone) in B2f-g, a (model, zone, window, trial
# range) in B2w-g and a (model, trial, window) in B2x-g.
GENERAL_OPS = ("fwd", "bwd_w", "bwd_x")


def general_plan(op: str, m: int, b: int, z: int, n: int, slots: int) -> dict:
    """The general kernel's launch for ``slots`` resident blocks: its
    ``units``, ``grid`` (at most one block a slot) and, in B2w-g,
    ``splits`` S, the most trial ranges a (model, zone, window) whose units
    still fit the slots in one wave (at least 1, at most B; S = 1 in the
    others). B2w-g's partials are N * S a model, summed in a fixed order."""
    splits = max(1, min(b, slots // (m * z * n))) if op == "bwd_w" else 1
    units = {"fwd": m * b * n * z, "bwd_w": m * z * n * splits, "bwd_x": m * b * n}[op]
    return {"units": units, "grid": min(units, slots), "splits": splits}


@functools.lru_cache(maxsize=16)
def _general_slots(op: str, bf16: bool, device_index: int) -> int:
    """Resident blocks of the general kernel of ``op`` on the card (the
    library's occupancy query; kept: it does not change)."""
    with torch.cuda.device(device_index):
        slots = _lib.library().isd_conv4head_general_slots(GENERAL_OPS.index(op), int(bf16))
    if slots < 1:
        raise RuntimeError(f"the general {op} kernel's occupancy query failed ({slots})")
    return slots


def _launch_general(op: str, g, x, w12, b12, w3, w4, window_len: int, step: int):
    """B2f-g, B2w-g or B2x-g (``op``) in x's precision on CUDA operands of
    any geometry with K1 = K2 = 5: the features, ``(dw12, db12, dw3, dw4)``
    or dx in x's dtype, as ``_adapted`` returns them. Counts one launch in
    the op's wrapper's ``launches_general`` (f32) or
    ``launches_general_bf16``."""
    m, b, c, t, z, o, k1, k2, n = _check_cuda(x, w12, b12, w3, w4, window_len, step, g)
    bf16 = x.dtype == torch.bfloat16
    lib = _lib.library()
    plan = general_plan(op, m, b, z, n, _general_slots(op, bf16, x.device.index))
    f32 = dict(dtype=torch.float32, device=x.device)
    work = torch.empty(plan["grid"] * lib.isd_conv4head_general_slot_floats(
        GENERAL_OPS.index(op), o, window_len), **f32)
    geo = (m, b, c, t, z, o, k1, k2, window_len, step, n)
    with torch.cuda.device(x.device):
        if op == "fwd":
            out = torch.empty((m, b, n, z * o), **f32)
            code = lib.isd_conv4head_fwd_general(
                x.data_ptr(), w12.data_ptr(), b12.data_ptr(), w3.data_ptr(), w4.data_ptr(),
                out.data_ptr(), work.data_ptr(), *geo, plan["grid"], int(bf16),
                _lib.stream_of(x))
        elif op == "bwd_w":
            p = n * plan["splits"]
            out = tuple(torch.empty(w.shape, **f32) for w in (w12, b12, w3, w4))
            parts = [torch.empty((m, p) + tuple(w.shape[1:]), **f32) for w in (w12, b12, w3, w4)]
            code = lib.isd_conv4head_bwd_w_general(
                g.data_ptr(), x.data_ptr(), w12.data_ptr(), b12.data_ptr(), w3.data_ptr(),
                w4.data_ptr(), *(t_.data_ptr() for t_ in out), *(t_.data_ptr() for t_ in parts),
                work.data_ptr(), *geo, plan["splits"], plan["grid"], int(bf16),
                _lib.stream_of(x))
        else:
            dxw = torch.empty((m, b, n, c, window_len), **f32)
            code = lib.isd_conv4head_bwd_x_general(
                g.data_ptr(), x.data_ptr(), w12.data_ptr(), b12.data_ptr(), w3.data_ptr(),
                w4.data_ptr(), dxw.data_ptr(), work.data_ptr(), *geo, plan["grid"], int(bf16),
                _lib.stream_of(x))
    _lib.check(code, f"isd_conv4head_{op}_general")
    wrapper = {"fwd": fused_conv4_head, "bwd_w": conv4head_bwd_w, "bwd_x": conv4head_bwd_x}[op]
    _lib.count(wrapper, "launches_general_bf16" if bf16 else "launches_general")
    return _overlap_add(dxw, x, step) if op == "bwd_x" else out


class _FusedConv4Head(torch.autograd.Function):
    """B2f forward; B2w / B2x backward, recomputing the forward in-kernel."""

    @staticmethod
    def forward(ctx, x, w12, b12, w3, w4, window_len, step):
        ctx.save_for_backward(x, w12, b12, w3, w4)
        ctx.geometry = (window_len, step)
        return _forward(x, w12, b12, w3, w4, window_len, step)

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
    (or ``(B, C, T)`` -> ``(B, N, Z*O)`` without the model axis). Without a
    gradient to take, a CPU or CUDA x goes through the ``isd::conv4head_fwd``
    operator (``library.py``: the plain version on the CPU, B2f on the card),
    which CUDA graphs and ``torch.export`` capture as one node; any other
    device takes the kernel's route, which raises off the card."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w12, b12, w3, w4)):
        if x.device.type == "cpu":
            return fused_conv4_head_plain(x, w12, b12, w3, w4, window_len, step)
        return _FusedConv4Head.apply(x, w12, b12, w3, w4, window_len, step)
    if x.device.type in ("cpu", "cuda"):
        return torch.ops.isd.conv4head_fwd(x, w12, b12, w3, w4, window_len, step)
    return _forward(x, w12, b12, w3, w4, window_len, step)


def _forward(x, w12, b12, w3, w4, window_len: int, step: int):
    """B2f, B2f-bf16 or B2f-g on CUDA operands of any geometry ``_adapted`` takes."""
    _require_x(x)
    out, adapted = _adapted("fwd", lambda g, *ops: _launch_fwd(*ops), None, x, w12, b12, w3, w4,
                            window_len, step)
    _lib.count(fused_conv4_head, "adapted", adapted)
    return out


fused_conv4_head.launches = 0  # B2f launches; the CPU route does not count
fused_conv4_head.launches_bf16 = 0  # B2f-bf16 launches
conv4head_bwd_w.launches = 0  # B2w launches
conv4head_bwd_w.launches_bf16 = 0  # B2w-bf16 launches
conv4head_bwd_x.launches = 0  # B2x launches
fused_conv4_head.launches_general = fused_conv4_head.launches_general_bf16 = 0  # B2f-g f32, bf16
conv4head_bwd_w.launches_general = conv4head_bwd_w.launches_general_bf16 = 0  # B2w-g
conv4head_bwd_x.launches_general = conv4head_bwd_x.launches_general_bf16 = 0  # B2x-g
# Calls whose operands _adapted zero-padded or split to a geometry the kernels
# are built for (each such call's launches count above as well).
fused_conv4_head.adapted = 0
conv4head_bwd_w.adapted = 0
conv4head_bwd_x.adapted = 0
# Launches recorded into a CUDA graph being captured (counted in none of the
# above: a capture runs nothing; each replay runs them again, uncounted).
fused_conv4_head.captures = conv4head_bwd_w.captures = conv4head_bwd_x.captures = 0

from . import library  # noqa: E402,F401  (registers the isd:: operators; imports this module)
