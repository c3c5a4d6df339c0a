"""TSception: multi-scale temporal and hemisphere-aware spatial CNN, stacked.

Counterpart of ``imagined_speech_decoding_tpu/models/tsception.py``:
three temporal branches (kernels of 0.5, 0.25 and 0.125 x sfreq, 'same'
padding with the extra sample on the right, LeakyReLU, (1, 4) average
pool), ``bn_t``, the full-montage and the hemisphere spatial convs (the
latter strided by half the montage), LeakyReLU, (1, 4) pools, ``bn_s``,
``adaptive_avg_pool_w(., 8)``, then fc1 (ReLU, dropout 0.5) and fc2.

``TSception(..., n_models=M)`` stacks M models on a leading axis of every
parameter and buffer, in the JAX layout (``t1.w (M, 15, 1, 1, 125)``,
``fc1.w (M, 360, 128)``, ``bn_t.mean (M, 45)``), and runs each
convolution as one grouped convolution over the models, batch first
(``(B, M*F, H, W)``). ``TSception(...)`` is one model with the JAX shapes.
The JAX function's ``remat=True`` (``jax.checkpoint``, a lever for a
TPU's memory) is not taken over: the branch activations are kept, each
LeakyReLU in place over its convolution's output so that one tensor a
branch is saved.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.norm import BNState, StackedBatchNorm
from .modules import Leaves, Stacked, avg_pool, conv2d, dropout, leaky_relu


def same_pad(k: int) -> Tuple[int, int]:
    """torch ``padding='same'`` (stride 1): the extra padding goes right."""
    total = k - 1
    return total // 2, total - total // 2


def tsception_meta(n_channels: int, sfreq: float = 250.0, num_t: int = 15,
                   num_s: int = 15) -> dict:
    """The temporal kernel widths and the hemisphere split (``tsception_meta``)."""
    return {"k_t": [int(sfreq * r) for r in (0.5, 0.25, 0.125)],
            "half": int(n_channels * 0.5), "num_t": num_t, "num_s": num_s}


def _spec(n_channels: int, n_classes: int, meta: dict, hidden: int):
    k_t, half, nt, ns = meta["k_t"], meta["half"], meta["num_t"], meta["num_s"]
    convs = [("t1", (nt, 1, 1, k_t[0])), ("t2", (nt, 1, 1, k_t[1])), ("t3", (nt, 1, 1, k_t[2])),
             ("s1", (ns, 3 * nt, n_channels, 1)), ("s2", (ns, 3 * nt, half, 1))]
    linears = [("fc1", ns * 3 * 8, hidden), ("fc2", hidden, n_classes)]
    bns = [("bn_t", 3 * nt), ("bn_s", ns)]
    return convs, linears, bns


def tsception_init(rng: np.random.Generator, n_channels: int, n_classes: int = 5,
                   sfreq: float = 250.0, num_t: int = 15, num_s: int = 15,
                   hidden: int = 128):
    """One model's ``(params, state)`` in the JAX layout, drawn from ``rng``
    with ``tsception_init``'s distributions (U(+-1/sqrt(fan_in)) weights
    and biases, BN ones / zeros, ``BNState(0, 1)``)."""
    meta = tsception_meta(n_channels, sfreq, num_t, num_s)
    convs, linears, bns = _spec(n_channels, n_classes, meta, hidden)

    def fan_in(shape, n):
        bound = 1.0 / math.sqrt(n)
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    params: dict = {}
    for name, shape in convs:
        fan = shape[1] * shape[2] * shape[3]
        params[name] = {"w": fan_in(shape, fan), "b": fan_in((shape[0],), fan)}
    for name, d_in, d_out in linears:
        params[name] = {"w": fan_in((d_in, d_out), d_in), "b": fan_in((d_out,), d_in)}
    state = {}
    for name, f in bns:
        params[name] = {"scale": np.ones(f, np.float32), "bias": np.zeros(f, np.float32)}
        state[name] = BNState(np.zeros(f, np.float32), np.ones(f, np.float32))
    return params, state


def adaptive_avg_pool_w(x: torch.Tensor, out_w: int) -> torch.Tensor:
    """``AdaptiveAvgPool2d((None, out_w))`` over ``(B, F, H, W)``: bin i
    averages ``x[..., floor(i*W/o) : ceil((i+1)*W/o)]``."""
    return F.adaptive_avg_pool2d(x, (x.shape[-2], out_w))


class TSception(Stacked):
    """``([M,] B, C, T)`` -> logits ``([M,] B, n_classes)``; the batch norms'
    running statistics are buffers, written in training mode. Dropout
    draws from ``generator`` (none without one)."""

    def __init__(self, n_channels: int, n_samples: int, n_classes: int = 5,
                 sfreq: float = 250.0, num_t: int = 15, num_s: int = 15, hidden: int = 128,
                 dropout: float = 0.5, n_models: Optional[int] = None, device=None):
        super().__init__(n_models)
        self.meta = tsception_meta(n_channels, sfreq, num_t, num_s)
        self.n_channels, self.n_samples, self.n_classes = n_channels, n_samples, n_classes
        self.rate = dropout
        convs, linears, bns = _spec(n_channels, n_classes, self.meta, hidden)
        for name, shape in convs:
            setattr(self, name, Leaves(n_models, device, w=shape, b=(shape[0],)))
        for name, d_in, d_out in linears:
            setattr(self, name, Leaves(n_models, device, w=(d_in, d_out), b=(d_out,)))
        for name, f in bns:
            setattr(self, name, StackedBatchNorm(f, n_models=n_models, device=device))

    @property
    def models(self) -> int:
        return 1 if self.n_models is None else self.n_models

    def _conv(self, name: str, x: torch.Tensor, **kw) -> torch.Tensor:
        leaves = getattr(self, name)
        w, b = leaves.stacked("w"), leaves.stacked("b")
        return conv2d(x, w.reshape(-1, *w.shape[2:]), b.reshape(-1), groups=self.models, **kw)

    def _linear(self, name: str, z: torch.Tensor) -> torch.Tensor:
        """``z (M, B, d_in)`` -> ``(M, B, d_out)``, as JAX ``linear``."""
        leaves = getattr(self, name)
        w, b = leaves.stacked("w").to(z.dtype), leaves.stacked("b").to(z.dtype)
        return torch.bmm(z, w) + b[:, None, :]

    def _forward(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        m, b = x.shape[:2]
        h = x.transpose(0, 1).contiguous()  # (B, M, C, T): one input channel a model
        branches = []
        for name, k in zip(("t1", "t2", "t3"), self.meta["k_t"]):
            y = self._conv(name, h, padding=((0, 0), same_pad(k)))  # (B, M*num_t, C, T)
            branches.append(avg_pool(leaky_relu(y, 0.01, inplace=True), (1, 4)))
        nt = self.meta["num_t"]
        y = torch.stack([t.reshape(b, m, nt, *t.shape[2:]) for t in branches], dim=2)
        y = self.bn_t(y.reshape(b, m * 3 * nt, *y.shape[-2:]))
        half = self.meta["half"]
        s1 = avg_pool(leaky_relu(self._conv("s1", y), 0.01, inplace=True), (1, 4))
        s2 = avg_pool(leaky_relu(self._conv("s2", y, stride=(half, 1)), 0.01, inplace=True), (1, 4))
        ys = self.bn_s(torch.cat([s1, s2], dim=2))  # (B, M*num_s, 3, T/16)
        z = adaptive_avg_pool_w(ys, 8).flatten(1).unflatten(1, (m, -1))  # (B, M, 360)
        z = z.transpose(0, 1)
        z = torch.relu(self._linear("fc1", z))
        z = dropout(z, self.rate, generator, self.training) if generator is not None else z
        return self._linear("fc2", z)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.n_models is not None:
            return self._forward(x, generator)
        return self._forward(x.unsqueeze(0), generator)[0]
