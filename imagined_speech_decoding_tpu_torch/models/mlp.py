"""MLP classifier over spectral features, stacked.

Counterpart of ``imagined_speech_decoding_tpu/models/mlp.py``
(BASELINE.json config #1: log-bandpower features -> small MLP): linear
layers ``d_in -> 128 -> 64 -> n_classes``, exact GELU and dropout 0.2
after each hidden layer. The layers are the port's stacked ``Linear``
(weight ``(out, in)``, the transpose of the JAX ``fc{i}.w``;
``transplant.mlp_from_jax`` / ``mlp_to_jax`` move them). The model has
no state.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from .modules import Linear, Stacked, dropout, gelu


def mlp_init(rng: np.random.Generator, d_in: int, n_classes: int = 5,
             hidden: Sequence[int] = (128, 64)):
    """One model's ``(params, state)`` in the JAX layout (``fc{i}: {"w": (d_in,
    d_out), "b": (d_out,)}``, U(+-1/sqrt(d_in)) as ``linear_init``) from
    ``rng``; the state is empty."""
    dims = [d_in, *hidden, n_classes]
    params = {}
    for i in range(len(dims) - 1):
        bound = 1.0 / math.sqrt(dims[i])
        params[f"fc{i}"] = {
            "w": rng.uniform(-bound, bound, (dims[i], dims[i + 1])).astype(np.float32),
            "b": rng.uniform(-bound, bound, (dims[i + 1],)).astype(np.float32),
        }
    return params, {}


class MLP(Stacked):
    """``([M,] B, d_in)`` -> logits ``([M,] B, n_classes)``. Dropout draws
    from ``generator`` in training mode (none without one, as the JAX
    model's dropout is off without an rng)."""

    def __init__(self, d_in: int, n_classes: int = 5, hidden: Sequence[int] = (128, 64),
                 dropout: float = 0.2, n_models: Optional[int] = None, device=None):
        super().__init__(n_models)
        dims = [d_in, *hidden, n_classes]
        self.rate = dropout
        self.fc = nn.ModuleList(Linear(dims[i], dims[i + 1], n_models, device=device)
                                for i in range(len(dims) - 1))

    def _forward(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        h = x
        for layer in self.fc[:-1]:
            h = gelu(layer(h))
            if generator is not None:
                h = dropout(h, self.rate, generator, self.training)
        return self.fc[-1](h)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.n_models is not None:
            return self._forward(x, generator)
        return self._forward(x.unsqueeze(0), generator)[0]
