"""FAST — Functional Areas Spatio-Temporal Transformer, in PyTorch.

Counterpart of ``imagined_speech_decoding_tpu/models/fast.py``: the
Conv4Layers zone head over sliding windows (``fast_forward_head``), a
pre-LN transformer over the window tokens plus a CLS token
(``fast_forward_transformer``), and the CLS classifier — the ``default``
forward mode of ``fast_apply``, at eval and in training. Dropout sits
where the JAX model puts it (attention probabilities, after ``fc1``'s
GELU, after ``fc2``, on the CLS output) and draws from the
``torch.Generator`` passed to ``forward``, on the model's device; the
head has none.

``FAST(cfg)`` is one model with the JAX parameter shapes (serving,
checkpoints); ``FAST(cfg, n_models=M)`` is a stack of M independent
models, every parameter with a leading model axis, taking ``(M, B, C, T)``
and returning ``(M, B, K)`` — the layout the training engine uses where
the JAX engine ``jax.vmap``s. Both run the same code, one model as M = 1.
Parameters start at zero (layer-norm scales at one); weights come from a
JAX-layout tree through ``transplant.from_jax_params``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import FASTConfig
from ..data.constants import zone_layout
from .heads import Conv4LayersHead
from .modules import LayerNorm, Linear, MultiheadSelfAttention, Stacked, dropout


class AttentionBlock(nn.Module):
    """Pre-LN transformer block (``attention_block_apply``, fast.py:73)."""

    def __init__(self, embed_dim: int, hidden_dim: int, num_heads: int,
                 n_models: Optional[int] = None, device=None):
        super().__init__()
        self.ln1 = LayerNorm(embed_dim, n_models=n_models, device=device)
        self.attn = MultiheadSelfAttention(embed_dim, num_heads, n_models, device=device)
        self.ln2 = LayerNorm(embed_dim, n_models=n_models, device=device)
        self.fc1 = Linear(embed_dim, hidden_dim, n_models, device=device)
        self.fc2 = Linear(hidden_dim, embed_dim, n_models, device=device)

    def forward(self, x: torch.Tensor, rate: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), rate, generator)
        h = dropout(F.gelu(self.fc1(self.ln2(x))), rate, generator, self.training)
        return x + dropout(self.fc2(h), rate, generator, self.training)


class FAST(Stacked):
    """FAST with the Conv4Layers head: raw ``(B, C, T)`` -> logits ``(B, K)``,
    or ``(M, B, C, T)`` -> ``(M, B, K)`` with ``n_models=M``."""

    def __init__(self, cfg: FASTConfig, n_models: Optional[int] = None, device=None):
        super().__init__(n_models)
        if cfg.head != "Conv4Layers":
            raise NotImplementedError(
                f"head {cfg.head!r}: the port has only Conv4Layers so far (see ROADMAP.md)"
            )
        self.cfg = cfg
        layout = zone_layout(cfg.electrodes, cfg.zone_dict)
        d = cfg.dim_token
        self.head = Conv4LayersHead(
            layout.indices, layout.mask, cfg.n_channels, cfg.dim_cnn, n_models, device=device
        )
        self.input_layer = Linear(cfg.dim_cnn * layout.n_zones, d, n_models, device=device)
        self.blocks = nn.ModuleList(
            AttentionBlock(d, 2 * d, cfg.num_heads, n_models, device=device)
            for _ in range(cfg.num_layers)
        )
        self.pos_embedding = self._param(1, cfg.n_tokens + 1, d, device=device)
        self.cls_token = self._param(1, 1, d, device=device)
        self.last_layer = Linear(d, cfg.n_classes, n_models, device=device)

    def _own_layout(self, fn, x: torch.Tensor, *args) -> torch.Tensor:
        """Run ``fn`` (model axis first) on ``x`` in the module's layout."""
        if self.n_models is not None:
            return fn(x, *args)
        return fn(x.unsqueeze(0), *args)[0]

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(x, self.cfg.window_len, self.cfg.slide_step)

    def _transformer(self, feat: torch.Tensor,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        m, b, n = feat.shape[:3]
        rate = self.cfg.dropout
        h = F.gelu(self.input_layer(feat.reshape(m, b, n, -1)))
        cls = self.per_model(self.cls_token).expand(m, b, 1, h.shape[-1])
        h = torch.cat([cls, h], dim=2) + self.per_model(self.pos_embedding)[:, :, : n + 1]
        for blk in self.blocks:
            h = blk(h, rate, generator)
        return self.last_layer(dropout(h[:, :, 0], rate, generator, self.training))

    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        """Tokenize + encode: ``([M,] B, C, T) -> ([M,] B, N, Z, F)`` (``fast_forward_head``)."""
        return self._own_layout(self._head, x)

    def forward_transformer(self, feat: torch.Tensor,
                            generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Transformer trunk + CLS classifier: ``([M,] B, N, Z, F) -> ([M,] B, K)``
        (``fast_forward_transformer``). Shorter token sequences use a
        prefix of the positional table."""
        return self._own_layout(self._transformer, feat, generator)

    def forward(self, x: torch.Tensor, forward_mode: str = "default",
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits in the ``default`` mode of ``fast_apply``. Dropout is on in
        training mode (``self.training``), drawing from ``generator``."""
        if forward_mode != "default":
            raise NotImplementedError(
                f"forward_mode {forward_mode!r}: only 'default' is ported; "
                "train_head and train_transformer are queued in ROADMAP.md"
            )
        return self._own_layout(lambda xm: self._transformer(self._head(xm), generator), x)
