"""Raw-window CNN + bidirectional LSTM sequence head, stacked.

Counterpart of ``imagined_speech_decoding_tpu/models/rnn.py``
(BASELINE.json config #4): a temporal (1, 15) conv ('same'), the full
(C, 1) spatial conv, batch norm, ELU and a (1, 8) average pool turn a raw
trial into a sequence of T/8 steps of 32 features; a BiLSTM scans it,
and its two final states feed dropout 0.3 and the classifier.

The LSTM follows ``torch.nn.LSTM``'s conventions (gates packed i, f, g,
o; sigmoid / tanh) with JAX's arithmetic: ``lstm_cell`` computes ``x.wi
+ h.wh + bi + bh`` with the weights cast to x's dtype, and carries h and
c in x's dtype. ``nn.LSTM`` and cuDNN's RNN take one weight set, and
these weights differ per model, so the scan is a Python loop of batched
GEMMs over a stack of G independent LSTMs: the input projection of every
step in one ``bmm`` first, then one ``bmm`` a step for the recurrence.
``bilstm`` runs its forward and backward directions as one stack of 2G,
the backward one over the time-reversed sequence, so that a step of both
is one launch of each operation; its final backward state is the state
after trial step 0, as JAX's ``lax.scan(reverse=True)`` leaves it.

``CNNBiLSTM(..., n_models=M)`` keeps the JAX layout after a leading model
axis (``temporal.w (M, 32, 1, 1, 15)``, ``rnn.fwd.wi (M, 32, 256)``,
``bn.mean (M, 32)``). The two convolutions run as grouped convolutions
over the models, batch first, in chunks of whole models of at most
``CHUNK_ELEMS`` elements of the temporal conv's output: at M = 75, B = 64
that output is 7.86e9 elements, past the 2^31 that cuDNN indexes. The
chunks' outputs stay alive for the spatial conv's weight gradient, as in
the JAX model (``--subject_group`` is the memory lever). With bf16 input
the convolutions and the batch statistics run in bf16 and, since the
batch norm's affine promotes to its f32 parameters, the LSTM and the
classifier in f32, as in the JAX model.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.norm import BNState, StackedBatchNorm
from .modules import Leaves, Stacked, avg_pool, conv2d, dropout, elu

CONV_DIM, HIDDEN, POOL, TEMPORAL_K = 32, 64, 8, 15


def lstm_cell(params: dict, carry: Tuple[torch.Tensor, torch.Tensor], x_t: torch.Tensor):
    """One LSTM step of a stack of G: ``params`` ``wi (G, D, 4H)``, ``wh (G,
    H, 4H)``, ``bi`` / ``bh (G, 4H)``; ``carry = (h, c)``, each ``(G, B, H)``;
    ``x_t (G, B, D)``. Returns ``((h, c), h)``."""
    return _cell(torch.bmm(x_t, params["wi"].to(x_t.dtype)), carry, params)


def _cell(gx: torch.Tensor, carry, params: dict):
    """The step given the input projection ``gx = x_t . wi``."""
    h, c = carry
    dt = gx.dtype
    gates = (gx + torch.bmm(h, params["wh"].to(dt)) + params["bi"].to(dt)[:, None]
             + params["bh"].to(dt)[:, None])
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return (h, c), h


def lstm_scan(params: dict, xs: torch.Tensor, reverse: bool = False,
              outputs: bool = True) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Scan a stack of G LSTMs over ``xs (G, B, T, D)`` from zero states:
    ``(outputs (G, B, T, H) or None, final h (G, B, H))``. ``reverse``
    scans from the last step to the first; the outputs keep xs's time
    order."""
    g, b, t, d = xs.shape
    hdim = params["wh"].shape[1]
    if reverse:
        xs = xs.flip(2)
    gx = torch.bmm(xs.reshape(g, b * t, d), params["wi"].to(xs.dtype)).view(g, b, t, -1)
    carry = (xs.new_zeros(g, b, hdim), xs.new_zeros(g, b, hdim))
    hs = []
    for s in range(t):
        carry, h = _cell(gx[:, :, s], carry, params)
        hs.append(h)
    if not outputs:
        return None, carry[0]
    out = torch.stack(hs, dim=2)
    return (out.flip(2) if reverse else out), carry[0]


def bilstm(params: dict, xs: torch.Tensor,
           outputs: bool = True) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """BiLSTM of a stack of G over ``xs (G, B, T, D)``, ``params = {"fwd":
    ..., "bwd": ...}`` (``lstm_cell``'s layout each): ``(the directions'
    outputs concatenated (G, B, T, 2H) or None, their final states
    concatenated (G, B, 2H))``. Both directions run as one stack of 2G."""
    g = xs.shape[0]
    both = {k: torch.cat([params["fwd"][k], params["bwd"][k]]) for k in ("wi", "wh", "bi", "bh")}
    out, final = lstm_scan(both, torch.cat([xs, xs.flip(2)]), outputs=outputs)
    final = torch.cat([final[:g], final[g:]], dim=-1)
    if out is None:
        return None, final
    return torch.cat([out[:g], out[g:].flip(2)], dim=-1), final


def cnn_bilstm_init(rng: np.random.Generator, n_channels: int, n_classes: int = 5,
                    conv_dim: int = CONV_DIM, hidden: int = HIDDEN):
    """One model's ``(params, state)`` in the JAX layout from ``rng``, with
    ``cnn_bilstm_init``'s distributions: bias-free convs U(+-1/sqrt(fan_in));
    every LSTM weight and bias U(+-1/sqrt(hidden)), torch ``nn.LSTM``'s
    rule (``lstm_init``); the classifier as ``linear_init``; the batch norm
    ones / zeros, ``BNState(0, 1)``."""

    def uniform(shape, n):
        bound = 1.0 / math.sqrt(n)
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    def lstm():
        return {"wi": uniform((conv_dim, 4 * hidden), hidden),
                "wh": uniform((hidden, 4 * hidden), hidden),
                "bi": uniform((4 * hidden,), hidden), "bh": uniform((4 * hidden,), hidden)}

    params = {
        "temporal": {"w": uniform((conv_dim, 1, 1, TEMPORAL_K), TEMPORAL_K)},
        "spatial": {"w": uniform((conv_dim, conv_dim, n_channels, 1), conv_dim * n_channels)},
        "rnn": {"fwd": lstm(), "bwd": lstm()},
        "classifier": {"w": uniform((2 * hidden, n_classes), 2 * hidden),
                       "b": uniform((n_classes,), 2 * hidden)},
        "bn": {"scale": np.ones(conv_dim, np.float32), "bias": np.zeros(conv_dim, np.float32)},
    }
    return params, {"bn": BNState(np.zeros(conv_dim, np.float32), np.ones(conv_dim, np.float32))}


class CNNBiLSTM(Stacked):
    """``([M,] B, C, T)`` -> logits ``([M,] B, n_classes)``; the batch norm's
    running statistics are buffers, written in training mode. Dropout
    draws from ``generator`` (none without one)."""

    CHUNK_ELEMS = 1 << 30  # elements of the temporal conv's output per chunk of models

    def __init__(self, n_channels: int, n_classes: int = 5, conv_dim: int = CONV_DIM,
                 hidden: int = HIDDEN, dropout: float = 0.3, n_models: Optional[int] = None,
                 device=None):
        super().__init__(n_models)
        self.conv_dim, self.rate = conv_dim, dropout
        self.temporal = Leaves(n_models, device, w=(conv_dim, 1, 1, TEMPORAL_K))
        self.spatial = Leaves(n_models, device, w=(conv_dim, conv_dim, n_channels, 1))
        self.rnn = nn.Module()
        for direction in ("fwd", "bwd"):
            setattr(self.rnn, direction, Leaves(
                n_models, device, wi=(conv_dim, 4 * hidden), wh=(hidden, 4 * hidden),
                bi=(4 * hidden,), bh=(4 * hidden,)))
        self.classifier = Leaves(n_models, device, w=(2 * hidden, n_classes), b=(n_classes,))
        self.bn = StackedBatchNorm(conv_dim, n_models=n_models, device=device)

    @property
    def models(self) -> int:
        return 1 if self.n_models is None else self.n_models

    def frontend(self, x: torch.Tensor) -> torch.Tensor:
        """The temporal and spatial convs of ``x (M, B, C, T)`` -> ``(B, M*F,
        1, T)``, in chunks of whole models."""
        m, b, c, t = x.shape
        f = self.conv_dim
        wt, ws = self.temporal.stacked("w"), self.spatial.stacked("w")
        wt, ws = wt.reshape(-1, *wt.shape[2:]), ws.reshape(-1, *ws.shape[2:])
        step = max(1, min(m, self.CHUNK_ELEMS // (b * f * c * t)))
        h = x.transpose(0, 1)  # (B, M, C, T): one input channel a model
        outs = []
        for m0 in range(0, m, step):
            sl = slice(m0 * f, min(m0 + step, m) * f)
            mc = min(step, m - m0)
            hc = conv2d(h[:, m0:m0 + mc], wt[sl], padding=((0, 0), (TEMPORAL_K // 2,) * 2),
                        groups=mc)
            outs.append(conv2d(hc, ws[sl], groups=mc))
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)

    def _forward(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        m = x.shape[0]
        h = avg_pool(elu(self.bn(self.frontend(x))), (1, POOL))  # (B, M*F, 1, T/8)
        # (M, B, T/8, F)
        seq = h.flatten(1).unflatten(1, (m, self.conv_dim, -1)).permute(1, 0, 3, 2)
        params = {d: {k: getattr(self.rnn, d).stacked(k) for k in ("wi", "wh", "bi", "bh")}
                  for d in ("fwd", "bwd")}
        _, final = bilstm(params, seq, outputs=False)
        if generator is not None:
            final = dropout(final, self.rate, generator, self.training)
        w, bias = self.classifier.stacked("w"), self.classifier.stacked("b")
        return torch.bmm(final, w.to(final.dtype)) + bias[:, None, :].to(final.dtype)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.n_models is not None:
            return self._forward(x, generator)
        return self._forward(x.unsqueeze(0), generator)[0]
