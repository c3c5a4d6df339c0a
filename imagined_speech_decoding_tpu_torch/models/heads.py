"""The Conv4Layers zone head, zone-stacked.

Counterpart of the Conv4Layers parts of
``imagined_speech_decoding_tpu/models/heads.py``: the parameters keep the
shapes ``conv4layers_init`` stacked by ``head_init`` gives them
(``cnn1.w (Z, O, 1, 1, K)``, ``cnn1.b (Z, O)``, ``cnn2.w (Z, O, O, C_max,
1)``, ``cnn3.w``/``cnn4.w (Z, O, O, 1, K)``), after a leading model axis
when the head is stacked, and ``fused_weights`` turns them into the
operand layouts of the fused head, always with the model axis (``ops.cuda.conv4head``): kernels
B2f/B2w/B2x on a CUDA tensor, their plain version (the semantics of
``conv4layers_fused_all_zones_fullseq``) on a CPU tensor. The prep is
einsums, so autograd carries the fused weights' gradients back to the
head's parameters, as ``jax.grad`` does through
``conv4layers_prepare_fused_weights``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.cuda.conv4head import fused_conv4_head
from .modules import Stacked


def zone_scatter(indices: np.ndarray, mask: np.ndarray, c_full: int) -> np.ndarray:
    """One-hot selection ``(Z, C_max, C_full)``: ``S[z, c, C] = 1`` iff zone
    z's slot c is montage channel C (0 for padded slots)."""
    z, c_max = indices.shape
    s = np.zeros((z, c_max, c_full), np.float32)
    zi, ci = np.nonzero(np.asarray(mask))
    s[zi, ci, np.asarray(indices)[zi, ci]] = 1.0
    return s


class Conv4LayersHead(Stacked):
    """All zones' Conv4Layers encoders over the un-gathered ``(M, B, C_full, T)``
    input: temporal (1, K) conv + bias, spatial (C_max, 1) conv, two
    'same' temporal (1, K) convs, exact GELU, mean over time. The head has
    no dropout."""

    KERNEL = 5  # temporal taps of cnn1, cnn3 and cnn4 (conv4layers_init)

    def __init__(self, indices: np.ndarray, mask: np.ndarray, c_full: int, dim: int,
                 n_models: Optional[int] = None, device=None):
        super().__init__(n_models)
        z, c_max = indices.shape
        k = self.KERNEL
        self.cnn1_weight = self._param(z, dim, 1, 1, k, device=device)
        self.cnn1_bias = self._param(z, dim, device=device)
        self.cnn2_weight = self._param(z, dim, dim, c_max, 1, device=device)
        self.cnn3_weight = self._param(z, dim, dim, 1, k, device=device)
        self.cnn4_weight = self._param(z, dim, dim, 1, k, device=device)
        scatter = torch.as_tensor(zone_scatter(indices, mask, c_full), device=device)
        self.register_buffer("scatter", scatter, persistent=False)
        self.register_buffer(
            "mask", torch.as_tensor(np.asarray(mask, np.float32), device=device),
            persistent=False,
        )

    def fused_weights(self):
        """``(w12 (M, Z*O, K*C_full) tap-major, b12 (M, Z*O, 1), w3 (M, Z, O,
        K*O), w4)``, as ``conv4layers_prepare_fused_weights`` (heads.py:832)
        per model: the temporal conv, its bias and the channel mask fused
        into the spatial conv, scattered to full-montage width."""
        wt = self.per_model(self.cnn1_weight)[:, :, :, 0, 0, :]  # (M, Z, F, K)
        ws = self.per_model(self.cnn2_weight)[..., 0]  # (M, Z, O, F, C_max)
        w12 = torch.einsum("mzofc,mzfk,zcC->mzokC", ws, wt, self.scatter)
        b12 = torch.einsum("mzofc,zc,mzf->mzo", ws, self.mask, self.per_model(self.cnn1_bias))
        m, z, o, k, c = w12.shape

        def tap_major(w):  # (M, Z, O, I, 1, K) -> (M, Z, O, K*I)
            return self.per_model(w)[:, :, :, :, 0, :].permute(0, 1, 2, 4, 3).reshape(m, z, o, -1)

        return (
            w12.reshape(m, z * o, k * c).contiguous(),
            b12.reshape(m, z * o, 1).contiguous(),
            tap_major(self.cnn3_weight).contiguous(),
            tap_major(self.cnn4_weight).contiguous(),
        )

    def forward(self, x: torch.Tensor, window_len: int, step: int) -> torch.Tensor:
        """``x (M, B, C_full, T)`` -> per-window zone features ``(M, B, N, Z, O)``."""
        w12, b12, w3, w4 = self.fused_weights()
        feat = fused_conv4_head(x.contiguous(), w12, b12, w3, w4, window_len, step)
        return feat.view(*feat.shape[:3], w3.shape[1], w3.shape[2])
