"""Standalone EEGNet classifier over the full montage, stacked.

Counterpart of ``imagined_speech_decoding_tpu/models/eegnet.py`` (the
"EEGNet-style depthwise-separable CNN" of BASELINE.json config #3):
temporal (1, K) conv ('same', one more output sample for an even K),
batch norm, depthwise spatial (C, 1) conv (x2), batch norm, ELU, (1, 4)
average pool, dropout 0.25, separable conv (depthwise (1, 16) padded 8,
pointwise), batch norm, ELU, (1, 8) pool, dropout, flatten, classifier.
The input is ``(B, C, T)`` raw trials or ``(B, P, C, T')`` planes
(``in_planes = P``: the band-binned STFT images of
``pipelines.stft_image_featurize``).

``EEGNet(..., n_models=M)`` stacks M models in the JAX layout
(``temporal.w (M, 8, P, 1, K)``, ``classifier.w (M, 16 * t_out, K)``,
``bn1.mean (M, 8)``) and runs every convolution as one grouped
convolution over the models, batch first (``(B, M*F, H, W)``), as
``models/tsception.py`` does. The batch norms are ``StackedBatchNorm``s
(``ops/norm.py``), with JAX's bf16 rounding points: a bf16 input runs the
temporal conv and the first batch statistics in bf16 and, since the
affine promotes to the f32 parameters, every layer after the first batch
norm in f32, as in the JAX model.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..ops.norm import BNState, StackedBatchNorm
from .modules import Leaves, Stacked, avg_pool, conv2d, elu, group_dropout

F1, D, KL = 8, 2, 64  # temporal filters, depth multiplier, raw temporal kernel


def t_out(n_samples: int, temporal_kernel: int = KL) -> int:
    """The classifier's input length: the temporal conv 'same' over K (one
    more sample for an even K), (1, 4) pool, the separable (1, 16) conv
    padded 8 (one more), (1, 8) pool. Raises below one sample."""
    pad_t = 1 - temporal_kernel % 2
    t = ((n_samples + pad_t) // 4 + 1) // 8
    if t < 1:
        raise ValueError(f"n_samples={n_samples} too short for EEGNet's /32 pooling")
    return t


def _spec(n_channels: int, n_samples: int, n_classes: int, in_planes: int, kernel: int):
    f2 = F1 * D
    convs = [("temporal", (F1, in_planes, 1, kernel)), ("spatial", (f2, 1, n_channels, 1)),
             ("sep_depth", (f2, 1, 1, 16)), ("sep_point", (f2, f2, 1, 1))]
    return convs, (f2 * t_out(n_samples, kernel), n_classes), (("bn1", F1), ("bn2", f2),
                                                               ("bn3", f2))


def eegnet_init(rng: np.random.Generator, n_channels: int, n_samples: int, n_classes: int = 5,
                in_planes: int = 1, temporal_kernel: int = KL):
    """One model's ``(params, state)`` in the JAX layout from ``rng``, with
    ``eegnet_init``'s distributions: bias-free convs U(+-1/sqrt(fan_in)),
    fan_in the weight's ``in * kh * kw``; the classifier as ``linear_init``;
    batch norms ones / zeros, ``BNState(0, 1)``."""
    convs, (d_in, d_out), bns = _spec(n_channels, n_samples, n_classes, in_planes,
                                      temporal_kernel)

    def fan_in(shape, n):
        bound = 1.0 / math.sqrt(n)
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    params: dict = {name: {"w": fan_in(shape, shape[1] * shape[2] * shape[3])}
                    for name, shape in convs}
    params["classifier"] = {"w": fan_in((d_in, d_out), d_in), "b": fan_in((d_out,), d_in)}
    state = {}
    for name, f in bns:
        params[name] = {"scale": np.ones(f, np.float32), "bias": np.zeros(f, np.float32)}
        state[name] = BNState(np.zeros(f, np.float32), np.ones(f, np.float32))
    return params, state


class EEGNet(Stacked):
    """``([M,] B, [P,] C, T)`` -> logits ``([M,] B, n_classes)``; the batch
    norms' running statistics are buffers, written in training mode.
    Dropout draws from ``generator`` (none without one)."""

    def __init__(self, n_channels: int, n_samples: int, n_classes: int = 5, in_planes: int = 1,
                 temporal_kernel: int = KL, dropout: float = 0.25,
                 n_models: Optional[int] = None, device=None):
        super().__init__(n_models)
        self.in_planes, self.kernel, self.rate = in_planes, temporal_kernel, dropout
        convs, (d_in, d_out), bns = _spec(n_channels, n_samples, n_classes, in_planes,
                                          temporal_kernel)
        for name, shape in convs:
            setattr(self, name, Leaves(n_models, device, w=shape))
        self.classifier = Leaves(n_models, device, w=(d_in, d_out), b=(d_out,))
        for name, f in bns:
            setattr(self, name, StackedBatchNorm(f, n_models=n_models, device=device))

    @property
    def models(self) -> int:
        return 1 if self.n_models is None else self.n_models

    def _w(self, name: str) -> torch.Tensor:
        w = getattr(self, name).stacked("w")
        return w.reshape(-1, *w.shape[2:])

    def _forward(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        m, b = x.shape[:2]
        h = x if x.dim() == 5 else x.unsqueeze(2)  # (M, B, P, C, T)
        h = h.transpose(0, 1).reshape(b, m * self.in_planes, *h.shape[-2:])
        k = self.kernel
        h = conv2d(h, self._w("temporal"), padding=((0, 0), (k // 2, k // 2)), groups=m)
        h = self.bn1(h)
        h = self.bn2(conv2d(h, self._w("spatial"), groups=m * F1))
        h = avg_pool(elu(h), (1, 4))
        h = group_dropout(h, m, self.rate, generator, self.training)
        h = conv2d(h, self._w("sep_depth"), padding=((0, 0), (8, 8)), groups=m * F1 * D)
        h = self.bn3(conv2d(h, self._w("sep_point"), groups=m))
        h = avg_pool(elu(h), (1, 8))
        h = group_dropout(h, m, self.rate, generator, self.training)
        z = h.flatten(1).unflatten(1, (m, -1)).transpose(0, 1)  # (M, B, 16 * t_out)
        w, bias = self.classifier.stacked("w"), self.classifier.stacked("b")
        return torch.bmm(z, w.to(z.dtype)) + bias[:, None, :].to(z.dtype)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.n_models is not None:
            return self._forward(x, generator)
        return self._forward(x.unsqueeze(0), generator)[0]
