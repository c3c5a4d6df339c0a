"""Transformer building blocks, written out in plain PyTorch.

Counterparts of ``imagined_speech_decoding_tpu/models/modules.py``:
``linear`` is ``nn.Linear`` (weight ``(out, in)``, the transpose of the
JAX ``(d_in, d_out)``), ``layernorm`` is ``LayerNorm`` and the
torch-semantics self-attention ``mha`` is ``MultiheadSelfAttention``.
Both are written out so their arithmetic follows the JAX functions step
by step; neither uses a fused PyTorch operator. Dropout is left out: the
serving path runs at eval, where it is the identity.
"""

from __future__ import annotations

import math

import torch
from torch import nn


class LayerNorm(nn.Module):
    """Layer norm over the last axis: biased variance, eps 1e-5."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class MultiheadSelfAttention(nn.Module):
    """Batch-first self-attention with ``nn.MultiheadAttention``'s packed
    in-projection: ``(B, N, D) -> (B, N, D)``, as einsum + softmax."""

    def __init__(self, embed_dim: int, num_heads: int, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj = nn.Linear(embed_dim, 3 * embed_dim, device=device)
        self.out_proj = nn.Linear(embed_dim, embed_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        hd = d // self.num_heads

        def heads(t):
            return t.reshape(b, n, self.num_heads, hd).transpose(1, 2)  # (B, H, N, hd)

        q, k, v = (heads(t) for t in self.in_proj(x).chunk(3, dim=-1))
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd)
        attn = torch.softmax(logits, dim=-1)
        o = torch.einsum("bhqk,bhkd->bhqd", attn, v)
        return self.out_proj(o.transpose(1, 2).reshape(b, n, d))
