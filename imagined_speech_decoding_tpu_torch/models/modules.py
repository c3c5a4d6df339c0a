"""Transformer building blocks, written out in plain PyTorch, for one
model or a stack of M models trained together.

Counterparts of ``imagined_speech_decoding_tpu/models/modules.py``:
``linear`` is ``Linear`` (weight ``(out, in)``, the transpose of the JAX
``(d_in, d_out)``), ``layernorm`` is ``LayerNorm``, the torch-semantics
self-attention ``mha`` is ``MultiheadSelfAttention`` and ``dropout`` is
``dropout``. Their arithmetic follows the JAX functions step by step;
none uses a fused PyTorch operator beyond the GEMMs.

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


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            train: bool) -> torch.Tensor:
    """Inverted dropout, as ``modules.dropout``: the identity at eval or at
    rate 0; else keep with probability ``1 - rate`` and scale by
    ``1 / (1 - rate)``. ``generator`` lives on ``x``'s device; training
    with dropout and no generator raises, as the JAX model needs an rng."""
    if not train or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError(f"dropout at rate {rate} in training mode needs a torch.Generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return x * keep.to(x.dtype) / (1.0 - rate)


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


class Linear(Stacked):
    """``x (M, ..., d_in) -> (M, ..., d_out)`` with per-model weight and bias."""

    def __init__(self, d_in: int, d_out: int, n_models: Optional[int] = None, device=None):
        super().__init__(n_models)
        self.weight = self._param(d_out, d_in, device=device)
        self.bias = self._param(d_out, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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
        return y * self.broadcast(self.weight, x) + self.broadcast(self.bias, x)


class MultiheadSelfAttention(nn.Module):
    """Batch-first self-attention with ``nn.MultiheadAttention``'s packed
    in-projection: ``(M, B, N, D) -> (M, B, N, D)``, as einsum + softmax,
    with dropout on the attention probabilities."""

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
        logits = torch.einsum("mbhqd,mbhkd->mbhqk", q, k) / math.sqrt(hd)
        attn = dropout(torch.softmax(logits, dim=-1), rate, generator, self.training)
        o = torch.einsum("mbhqk,mbhkd->mbhqd", attn, v)
        return self.out_proj(o.transpose(2, 3).reshape(m, b, n, d))
