"""FAST — Functional Areas Spatio-Temporal Transformer, in PyTorch.

Counterpart of ``imagined_speech_decoding_tpu/models/fast.py``: a zone
head over sliding windows (``fast_forward_head``), a
pre-LN transformer over the window tokens plus a CLS token
(``fast_forward_transformer``), and the CLS classifier, in the three
forward modes of ``fast_apply`` (``FORWARD_MODES``), at eval and in
training: ``default``; ``train_head``, each window token through
``input_layer`` and ``last_layer`` and the logits averaged over the
tokens (no transformer, no CLS); ``train_transformer``, the head's
features taken without a gradient (``stop_gradient``), so the head runs
outside autograd (its batch-norm statistics still move in training
mode). ``FAST(cfg, forward_mode=...)`` binds a mode, which ``forward``
runs unless it is named another; ``models.api.make_fast_model(cfg,
forward_mode)`` builds the engine's stacks so. ``forward_head(x,
step_override)`` tokenizes at another window step (dense tokens), and
``batched_forward_head`` does so in micro-batches, at eval. Dropout sits
where the JAX model puts it (attention probabilities, after ``fc1``'s
GELU, after ``fc2``, on the CLS output) and draws from the
``torch.Generator`` passed to ``forward``, on the model's device, as do
the CVBlock and EEGNet_Encoder heads' (none without a generator).

The head is any of ``models.heads.HEAD_REGISTRY``: Conv4Layers runs its
fused kernels (B2f / B2w / B2x) over the un-gathered input; CVBlock,
EEGNet_Encoder and HeadConv_Paper_Version run on the gathered windows as
grouped convolutions, with their batch-norm running statistics in the
module's buffers (``head.bn1.mean`` ...), written in training mode and
read in eval mode (``model.train()`` / ``model.eval()``).

``FAST(cfg)`` is one model with the JAX parameter shapes (serving,
checkpoints); ``FAST(cfg, n_models=M)`` is a stack of M independent
models, every parameter with a leading model axis, taking ``(M, B, C, T)``
and returning ``(M, B, K)`` — the layout the training engine uses where
the JAX engine ``jax.vmap``s. Both run the same code, one model as M = 1.
Parameters start at zero (layer-norm scales at one); weights come from a
JAX-layout tree through ``transplant.from_jax_params``. The parameters are
f32 and the input's dtype is the compute dtype: a bf16 input runs the JAX
package's ``bf16-mixed`` policy (``make_fast_model(compute_dtype=bfloat16)``),
bf16 activations and operands with f32 accumulation in the head, f32
attention logits and softmax; the loss is taken in f32 (``train.metrics``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import FASTConfig
from ..data.constants import zone_layout
from .heads import Conv4LayersHead, get_head
from .modules import LayerNorm, Linear, MultiheadSelfAttention, Stacked, dropout, gelu

FORWARD_MODES = ("default", "train_head", "train_transformer")


def check_forward_mode(mode: str) -> str:
    """``mode`` if it is one of ``FORWARD_MODES``; JAX's error otherwise."""
    if mode not in FORWARD_MODES:
        raise NotImplementedError(f"unknown forward_mode {mode!r}")
    return mode


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
        h = dropout(gelu(self.fc1(self.ln2(x))), rate, generator, self.training)
        return x + dropout(self.fc2(h), rate, generator, self.training)


class FAST(Stacked):
    """FAST with the head ``cfg.head``: raw ``(B, C, T)`` -> logits ``(B, K)``,
    or ``(M, B, C, T)`` -> ``(M, B, K)`` with ``n_models=M``, in the bound
    ``forward_mode``."""

    def __init__(self, cfg: FASTConfig, n_models: Optional[int] = None, device=None,
                 forward_mode: str = "default"):
        super().__init__(n_models)
        head_cls = get_head(cfg.head)
        self.cfg = cfg
        self.forward_mode = check_forward_mode(forward_mode)
        layout = zone_layout(cfg.electrodes, cfg.zone_dict)
        d = cfg.dim_token
        if head_cls is Conv4LayersHead:
            self.head = Conv4LayersHead(
                layout.indices, layout.mask, cfg.n_channels, cfg.dim_cnn, n_models, device=device
            )
        else:
            self.head = head_cls(layout.indices, layout.mask, cfg.dim_cnn, cfg.window_len,
                                 n_models, device=device)
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

    def _head(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
              step: Optional[int] = None) -> torch.Tensor:
        step = self.cfg.slide_step if step is None else step
        if isinstance(self.head, Conv4LayersHead):
            return self.head(x, self.cfg.window_len, step)
        return self.head(x, self.cfg.window_len, step, generator)

    def _transformer(self, feat: torch.Tensor,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        m, b, n = feat.shape[:3]
        rate = self.cfg.dropout
        h = gelu(self.input_layer(feat.flatten(3)))
        cls = self.per_model(self.cls_token).to(h.dtype).expand(m, b, 1, h.shape[-1])
        pos = self.per_model(self.pos_embedding)[:, :, : n + 1].to(h.dtype)
        h = torch.cat([cls, h], dim=2) + pos
        for blk in self.blocks:
            h = blk(h, rate, generator)
        return self.last_layer(dropout(h[:, :, 0], rate, generator, self.training))

    def _token_logits(self, feat: torch.Tensor) -> torch.Tensor:
        """``train_head``'s classifier: every window token through
        ``input_layer`` (GELU) and ``last_layer``, averaged over the tokens."""
        m, b, n = feat.shape[:3]
        tokens = gelu(self.input_layer(feat.flatten(3)))
        return self.last_layer(tokens).mean(2)

    def _logits(self, xm: torch.Tensor, mode: str,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        if mode == "train_transformer":
            # The head as a frozen feature extractor: no autograd record, so
            # its backward never runs (JAX's stop_gradient).
            with torch.no_grad():
                feat = self._head(xm, generator)
            return self._transformer(feat, generator)
        feat = self._head(xm, generator)
        if mode == "train_head":
            return self._token_logits(feat)
        return self._transformer(feat, generator)

    def forward_head(self, x: torch.Tensor, step_override: Optional[int] = None,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Tokenize + encode: ``([M,] B, C, T) -> ([M,] B, N, Z, F)``
        (``fast_forward_head``); ``step_override`` slides the windows by
        another step than ``cfg.slide_step`` (dense tokens: N = (T - W) //
        step + 1)."""
        return self._own_layout(self._head, x, generator, step_override)

    def batched_forward_head(self, x: torch.Tensor, step: Optional[int] = None,
                             micro_batch: int = 64) -> torch.Tensor:
        """``forward_head`` in eval mode, without a gradient, over the trials
        in chunks of ``micro_batch`` (``fast_batched_forward_head``): the
        memory bound of dense tokenization. A batch that is not a multiple
        of ``micro_batch`` runs as one chunk, as JAX's does."""
        axis = 0 if self.n_models is None else 1
        was_training = self.training
        self.eval()
        try:
            with torch.no_grad():
                b = x.shape[axis]
                if b % micro_batch:
                    return self.forward_head(x, step)
                return torch.cat([self.forward_head(c, step)
                                  for c in x.split(micro_batch, dim=axis)], dim=axis)
        finally:
            self.train(was_training)

    def forward_transformer(self, feat: torch.Tensor,
                            generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Transformer trunk + CLS classifier: ``([M,] B, N, Z, F) -> ([M,] B, K)``
        (``fast_forward_transformer``). Shorter token sequences use a
        prefix of the positional table."""
        return self._own_layout(self._transformer, feat, generator)

    def forward(self, x: torch.Tensor, forward_mode: Optional[str] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits in ``forward_mode`` (the bound ``self.forward_mode`` when
        None) of ``fast_apply``. Dropout is on in training mode
        (``self.training``), drawing from ``generator``."""
        mode = self.forward_mode if forward_mode is None else check_forward_mode(forward_mode)
        return self._own_layout(lambda xm: self._logits(xm, mode, generator), x)
