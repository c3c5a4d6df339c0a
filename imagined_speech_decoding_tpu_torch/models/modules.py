"""Transformer building blocks, written out in plain PyTorch, for one
model or a stack of M models trained together.

Counterparts of ``imagined_speech_decoding_tpu/models/modules.py``:
``linear`` is ``Linear`` (weight ``(out, in)``, the transpose of the JAX
``(d_in, d_out)``), ``layernorm`` is ``LayerNorm``, the torch-semantics
self-attention ``mha`` is ``MultiheadSelfAttention`` and ``dropout`` is
``dropout``. Their arithmetic follows the JAX functions step by step;
none uses a fused PyTorch operator beyond the GEMMs.

The convolutional blocks of the batch-norm heads and of TSception
(``conv2d``, ``temporal_conv``, ``avg_pool``, ``adaptive_avg_pool_1``,
``elu``, ``leaky_relu``) are the JAX functions of the same names over the
JAX layouts (NCHW inputs, OIHW weights). A stack of models, and of zones
within a model, runs as ONE grouped convolution: the ``(M, Z)`` instances
are folded into ``groups`` and the batch stays first, ``(B, M*Z*F, H,
W)``, where the JAX package ``jax.vmap``s over them.

Precision: the parameters stay f32 and each is cast to the input's dtype
where it is used, as the JAX functions do (``.astype(x.dtype)``), so a
bf16 input runs the whole trunk in bf16 (PyTorch's type promotion would
otherwise make a bf16 x f32 parameter f32) while the gradients reach the
f32 parameters as f32, through the casts' backward. In f32 the casts are
no-ops.

The model axis: where the JAX engine ``jax.vmap``s one model's functions
over a stack, every module here takes ``n_models``. With ``n_models=M``
each parameter carries a leading axis of M and every input a leading
model axis; with ``n_models=None`` (serving, checkpoints) the parameters
have the JAX shapes of one model. ``forward`` always takes inputs with
the model axis first: one model runs as M = 1.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


_SQRT_HALF_BF16 = float(torch.tensor(math.sqrt(0.5)).to(torch.bfloat16))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU. In f32, PyTorch's. In bf16, ``jax.nn.gelu(approximate=False)``
    op by op, ``0.5 * x * erfc(-x * sqrt(0.5))`` with ``sqrt(0.5)`` and every
    step rounded to bf16, as JAX computes it (PyTorch's fused GELU rounds
    once and differs in a third of the elements)."""
    if x.dtype != torch.bfloat16:
        return F.gelu(x)
    return 0.5 * x * torch.erfc(-x * _SQRT_HALF_BF16)


class SharedRowsGenerator(torch.Generator):
    """A ``torch.Generator`` whose draws over a stack of models are made as
    the unsharded stack makes them (``draw_rows``).

    ``row_repeats = R``: the draw covers the first ``M / R`` model rows and
    is repeated R times along the model axis, so row ``r*G + g`` shares row
    g's masks (the sweep's R configs of the same folds,
    ``train.engine.make_fit(row_repeats=...)``).

    A shard of the stack (``parallel.mesh``): every draw is made at the
    unsharded shape, so that the stream stays the unsharded run's, and
    this rank's part is kept. ``rows = (m_count, start, stop)``: the draw
    covers the whole stack's ``m_count`` rows (axis 0), padded to the mesh
    with copies of the last row's draws, and rows ``[start, stop)`` of that
    are kept. ``set_batch((b_full, start, stop))``, each step: axis 1 holds
    this rank's trials ``[start, stop)`` of a batch of ``b_full``, each
    trial ``k`` entries long (``k`` windows in a head's ``(M, B*N, ...)``
    layout); the draw covers all ``b_full`` and keeps this rank's. A rank
    with no trials in a step takes each draw's ``k`` from the same draw of
    an earlier step."""

    row_repeats = 1

    def __new__(cls, device=None, rows=None):
        return super().__new__(cls, device=device)

    def __init__(self, device=None, rows=None):
        self.rows = rows
        self.batch = None
        self._draw = 0
        self._per_trial = {}

    def set_batch(self, batch) -> None:
        self.batch, self._draw = batch, 0

    def split(self, shape):
        """``(unsharded shape, cut)`` of a draw whose local shape is
        ``shape``; ``cut(t)`` keeps this rank's part of a draw at the
        unsharded shape."""
        full = list(shape)
        keep = []
        if self.rows is not None:
            m_count, r0, r1 = self.rows
            full[0] = m_count
            idx = torch.arange(r0, r1).clamp_max(m_count - 1)
            keep.append(lambda t: t[idx.to(t.device)])
        if self.batch is not None:
            b_full, c0, c1 = self.batch
            i, self._draw = self._draw, self._draw + 1
            if c1 > c0:
                self._per_trial[i] = shape[1] // (c1 - c0)
            elif i not in self._per_trial:
                raise RuntimeError("a rank with no trials in its first step cannot size the "
                                   "unsharded draw; give every rank a trial of the first batch")
            k = self._per_trial[i]
            full[1] = k * b_full
            keep.append(lambda t: t[:, k * c0:k * c1])

        def cut(t):
            for f in keep:
                t = f(t)
            return t

        return tuple(full), cut


def draw_rows(generator: torch.Generator, shape, sample):
    """``sample(shape)``, a draw from ``generator``, made as the unsharded
    stack makes it (``SharedRowsGenerator``; a plain generator draws
    ``shape``)."""
    shape = tuple(shape)
    cut = None
    if isinstance(generator, SharedRowsGenerator):
        shape, cut = generator.split(shape)
    repeats = getattr(generator, "row_repeats", 1)
    t = sample(shape if repeats == 1 else (shape[0] // repeats,) + shape[1:])
    if repeats > 1:
        t = t.repeat(repeats, *([1] * (t.dim() - 1)))
    return t if cut is None else cut(t)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            train: bool) -> torch.Tensor:
    """Inverted dropout, as ``modules.dropout``: the identity at eval or at
    rate 0; else keep with probability ``1 - rate`` and scale by
    ``1 / (1 - rate)``. ``generator`` lives on ``x``'s device; training
    with dropout and no generator raises, as the JAX model needs an rng.
    ``x``'s first axis is the model axis; the masks are drawn by
    ``draw_rows``."""
    if not train or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError(f"dropout at rate {rate} in training mode needs a torch.Generator")
    keep = draw_rows(generator, x.shape, lambda s: torch.rand(
        s, generator=generator, device=x.device) < 1.0 - rate)
    return x * keep.to(x.dtype) / (1.0 - rate)


def group_dropout(x: torch.Tensor, n_models: int, rate: float,
                  generator: Optional[torch.Generator], train: bool) -> torch.Tensor:
    """``dropout`` of a batch-first ``x (B, M*..., ...)`` whose axis 1 leads
    with the model axis: the masks are drawn model-first, so a
    ``SharedRowsGenerator`` repeats or cuts them by model row. Off without a
    generator, as the JAX heads' dropout is off with ``rng=None``."""
    if not train or rate <= 0.0 or generator is None:
        return x
    rows = x.flatten(1).unflatten(1, (n_models, -1)).transpose(0, 1)  # (M, B, rest)
    return dropout(rows, rate, generator, True).transpose(0, 1).reshape(x.shape)


def _pad_pairs(padding) -> tuple:
    """Explicit lax padding ``[(lo, hi), (lo, hi)]`` (H, W) as ``F.pad``'s
    ``(w_lo, w_hi, h_lo, h_hi)``."""
    (h_lo, h_hi), (w_lo, w_hi) = padding
    return (w_lo, w_hi, h_lo, h_hi)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride=(1, 1), padding=((0, 0), (0, 0)), groups: int = 1) -> torch.Tensor:
    """``modules.conv2d``: ``x (B, C, H, W)`` with an OIHW weight, explicit
    (possibly uneven) padding, stride and groups. The weight and bias are
    cast to x's dtype and the bias is added after the convolution, in x's
    dtype, as the JAX function adds it."""
    pads = _pad_pairs(padding)
    if any(pads):
        x = F.pad(x, pads)
    y = F.conv2d(x, w.to(x.dtype), None, stride=tuple(stride), groups=groups)
    if b is not None:
        y = y + b.to(x.dtype).view(1, -1, 1, 1)
    return y


def temporal_conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                  pad: int = 0) -> torch.Tensor:
    """``modules.temporal_conv`` per group: ``x (B, G, C, T)``, ``w (G, O, C,
    K)``, ``b (G, O)`` -> ``(B, G, O, T + 2*pad - K + 1)`` as K shifted
    GEMMs, each rounded to x's dtype and summed in tap order, as JAX sums
    them."""
    if pad:
        x = F.pad(x, (pad, pad))
    k = w.shape[-1]
    t_out = x.shape[-1] - k + 1
    w = w.to(x.dtype)
    out = None
    for i in range(k):
        term = torch.einsum("bgct,goc->bgot", x[..., i:i + t_out], w[..., i])
        out = term if out is None else out + term
    if b is not None:
        out = out + b.to(x.dtype)[None, :, :, None]
    return out


def avg_pool(x: torch.Tensor, window, stride=None) -> torch.Tensor:
    """Average pool over the trailing two axes of ``(B, C, H, W)``, floor
    semantics (``modules.avg_pool``)."""
    return F.avg_pool2d(x, tuple(window), tuple(stride or window))


def adaptive_avg_pool_1(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool2d((1, 1)): the mean over the trailing two axes."""
    return x.mean(dim=(-2, -1))


def elu(x: torch.Tensor) -> torch.Tensor:
    return F.elu(x)


def leaky_relu(x: torch.Tensor, slope: float = 0.01, inplace: bool = False) -> torch.Tensor:
    return F.leaky_relu(x, slope, inplace=inplace)


class Stacked(nn.Module):
    """A module whose parameters may carry a leading model axis."""

    def __init__(self, n_models: Optional[int]):
        super().__init__()
        self.n_models = n_models

    def _param(self, *shape: int, fill: float = 0.0, device=None) -> nn.Parameter:
        lead = () if self.n_models is None else (self.n_models,)
        return nn.Parameter(torch.full(lead + shape, fill, device=device))

    def per_model(self, p: torch.Tensor) -> torch.Tensor:
        """``p`` with its leading model axis (of 1 without a stack)."""
        return p if self.n_models is not None else p.unsqueeze(0)

    def broadcast(self, p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """A per-model vector ``p (M?, D)`` shaped to broadcast against
        ``x (M, ..., D)``."""
        p = self.per_model(p)
        return p.view(p.shape[0], *([1] * (x.dim() - 2)), p.shape[-1])


class Leaves(Stacked):
    """The parameters of one JAX leaf dict, e.g. ``Leaves(w=(O, I, kh, kw),
    b=(O,))``, each after a leading model axis when stacked; named as the
    JAX keys, so the ``state_dict`` keys are the JAX tree's paths."""

    def __init__(self, n_models: Optional[int] = None, device=None, **shapes):
        super().__init__(n_models)
        for name, shape in shapes.items():
            setattr(self, name, self._param(*shape, device=device))

    def stacked(self, name: str) -> torch.Tensor:
        """Parameter ``name`` with its leading model axis."""
        return self.per_model(getattr(self, name))


class Linear(Stacked):
    """``x (M, ..., d_in) -> (M, ..., d_out)`` with per-model weight and bias."""

    def __init__(self, d_in: int, d_out: int, n_models: Optional[int] = None, device=None):
        super().__init__(n_models)
        self.weight = self._param(d_out, d_in, device=device)
        self.bias = self._param(d_out, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.bfloat16:
            # As JAX linear: the product is rounded to bf16 before the bias
            # is added (addmm would add it in f32 and round once).
            w = self.per_model(self.weight).to(x.dtype)
            y = torch.bmm(x.reshape(x.shape[0], -1, x.shape[-1]), w.transpose(1, 2))
            return y.view(*x.shape[:-1], w.shape[1]) + self.broadcast(self.bias, x).to(x.dtype)
        if self.n_models is None:
            # One model: addmm with the bias in the GEMM. baddbmm would first
            # copy the broadcast bias into its output, one more launch per
            # call (18 per serving decode).
            return F.linear(x, self.weight, self.bias)
        flat = x.reshape(x.shape[0], -1, x.shape[-1])
        y = torch.baddbmm(self.bias.unsqueeze(1), flat, self.weight.transpose(1, 2))
        return y.view(*x.shape[:-1], self.weight.shape[1])


class LayerNorm(Stacked):
    """Layer norm over the last axis: biased variance, eps 1e-5."""

    def __init__(self, dim: int, eps: float = 1e-5, n_models: Optional[int] = None, device=None):
        super().__init__(n_models)
        self.eps = eps
        self.weight = self._param(dim, fill=1.0, device=device)
        self.bias = self._param(dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return (y * self.broadcast(self.weight, x).to(x.dtype)
                + self.broadcast(self.bias, x).to(x.dtype))


class MultiheadSelfAttention(nn.Module):
    """Batch-first self-attention with ``nn.MultiheadAttention``'s packed
    in-projection: ``(M, B, N, D) -> (M, B, N, D)``, as einsum + softmax,
    with dropout on the attention probabilities. As JAX ``mha``: the
    logits and the softmax are f32, the probabilities then cast to x's
    dtype."""

    def __init__(self, embed_dim: int, num_heads: int, n_models: Optional[int] = None,
                 device=None):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj = Linear(embed_dim, 3 * embed_dim, n_models, device=device)
        self.out_proj = Linear(embed_dim, embed_dim, n_models, device=device)

    def forward(self, x: torch.Tensor, rate: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        m, b, n, d = x.shape
        hd = d // self.num_heads

        def heads(t):
            return t.reshape(m, b, n, self.num_heads, hd).transpose(2, 3)  # (M, B, H, N, hd)

        q, k, v = (heads(t) for t in self.in_proj(x).chunk(3, dim=-1))
        logits = torch.einsum("mbhqd,mbhkd->mbhqk", q.float(), k.float()) / math.sqrt(hd)
        attn = dropout(torch.softmax(logits, dim=-1).to(x.dtype), rate, generator, self.training)
        o = torch.einsum("mbhqk,mbhkd->mbhqd", attn, v)
        return self.out_proj(o.transpose(2, 3).reshape(m, b, n, d))
