"""FAST — Functional Areas Spatio-Temporal Transformer, in PyTorch.

Counterpart of ``imagined_speech_decoding_tpu/models/fast.py`` at eval:
the Conv4Layers zone head over sliding windows (``fast_forward_head``),
a pre-LN transformer over the window tokens plus a CLS token
(``fast_forward_transformer``), and the CLS classifier — the ``default``
forward mode of ``fast_apply``. Parameters start at zero (layer-norm
scales at one); weights come from a checkpoint through
``transplant.from_jax_params``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import FASTConfig
from ..data.constants import zone_layout
from .heads import Conv4LayersHead
from .modules import LayerNorm, MultiheadSelfAttention


class AttentionBlock(nn.Module):
    """Pre-LN transformer block (``attention_block_apply``, fast.py:73)."""

    def __init__(self, embed_dim: int, hidden_dim: int, num_heads: int, device=None):
        super().__init__()
        self.ln1 = LayerNorm(embed_dim, device=device)
        self.attn = MultiheadSelfAttention(embed_dim, num_heads, device=device)
        self.ln2 = LayerNorm(embed_dim, device=device)
        self.fc1 = nn.Linear(embed_dim, hidden_dim, device=device)
        self.fc2 = nn.Linear(hidden_dim, embed_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.fc2(F.gelu(self.fc1(self.ln2(x))))


class FAST(nn.Module):
    """FAST with the Conv4Layers head: raw ``(B, C, T)`` -> logits ``(B, K)``."""

    def __init__(self, cfg: FASTConfig, device=None):
        super().__init__()
        if cfg.head != "Conv4Layers":
            raise NotImplementedError(
                f"head {cfg.head!r}: the port has only Conv4Layers so far (see ROADMAP.md)"
            )
        self.cfg = cfg
        layout = zone_layout(cfg.electrodes, cfg.zone_dict)
        d = cfg.dim_token
        self.head = Conv4LayersHead(
            layout.indices, layout.mask, cfg.n_channels, cfg.dim_cnn, device=device
        )
        self.input_layer = nn.Linear(cfg.dim_cnn * layout.n_zones, d, device=device)
        self.blocks = nn.ModuleList(
            AttentionBlock(d, 2 * d, cfg.num_heads, device=device)
            for _ in range(cfg.num_layers)
        )
        self.pos_embedding = nn.Parameter(torch.zeros(1, cfg.n_tokens + 1, d, device=device))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d, device=device))
        self.last_layer = nn.Linear(d, cfg.n_classes, device=device)
        with torch.no_grad():
            for name, p in self.named_parameters():
                p.fill_(1.0 if name.endswith(("ln1.weight", "ln2.weight")) else 0.0)

    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        """Tokenize + encode: ``(B, C, T) -> (B, N, Z, F)`` (``fast_forward_head``)."""
        return self.head(x, self.cfg.window_len, self.cfg.slide_step)

    def forward_transformer(self, feat: torch.Tensor) -> torch.Tensor:
        """Transformer trunk + CLS classifier: ``(B, N, Z, F) -> (B, K)``
        (``fast_forward_transformer``). Shorter token sequences use a
        prefix of the positional table."""
        b, n = feat.shape[:2]
        h = F.gelu(self.input_layer(feat.reshape(b, n, -1)))
        cls = self.cls_token.expand(b, 1, h.shape[-1])
        h = torch.cat([cls, h], dim=1) + self.pos_embedding[:, : n + 1]
        for blk in self.blocks:
            h = blk(h)
        return self.last_layer(h[:, 0])

    def forward(self, x: torch.Tensor, forward_mode: str = "default") -> torch.Tensor:
        """Logits in the ``default`` mode of ``fast_apply`` at eval."""
        if forward_mode != "default":
            raise NotImplementedError(
                f"forward_mode {forward_mode!r} comes with the training port (see ROADMAP.md)"
            )
        return self.forward_transformer(self.forward_head(x))
