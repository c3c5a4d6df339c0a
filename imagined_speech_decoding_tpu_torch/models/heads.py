"""The Conv4Layers zone head, zone-stacked.

Counterpart of the Conv4Layers parts of
``imagined_speech_decoding_tpu/models/heads.py``: the parameters keep the
shapes ``conv4layers_init`` stacked by ``head_init`` gives them
(``cnn1.w (Z, O, 1, 1, K)``, ``cnn1.b (Z, O)``, ``cnn2.w (Z, O, O, C_max,
1)``, ``cnn3.w``/``cnn4.w (Z, O, O, 1, K)``), and ``prepare_fused_weights``
turns them into the operand layouts of the fused head
(``ops.cuda.conv4head``): kernel B2 on a CUDA tensor, its plain version
(the semantics of ``conv4layers_fused_all_zones_fullseq``) on a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.cuda.conv4head import fused_conv4_head


def zone_scatter(indices: np.ndarray, mask: np.ndarray, c_full: int) -> np.ndarray:
    """One-hot selection ``(Z, C_max, C_full)``: ``S[z, c, C] = 1`` iff zone
    z's slot c is montage channel C (0 for padded slots)."""
    z, c_max = indices.shape
    s = np.zeros((z, c_max, c_full), np.float32)
    zi, ci = np.nonzero(np.asarray(mask))
    s[zi, ci, np.asarray(indices)[zi, ci]] = 1.0
    return s


class Conv4LayersHead(nn.Module):
    """All zones' Conv4Layers encoders over the un-gathered ``(B, C_full, T)``
    input: temporal (1, K) conv + bias, spatial (C_max, 1) conv, two
    'same' temporal (1, K) convs, exact GELU, mean over time."""

    KERNEL = 5  # temporal taps of cnn1, cnn3 and cnn4 (conv4layers_init)

    def __init__(self, indices: np.ndarray, mask: np.ndarray, c_full: int, dim: int,
                 device=None):
        super().__init__()
        z, c_max = indices.shape
        k = self.KERNEL

        def param(*shape):
            return nn.Parameter(torch.zeros(shape, device=device))

        self.cnn1_weight = param(z, dim, 1, 1, k)
        self.cnn1_bias = param(z, dim)
        self.cnn2_weight = param(z, dim, dim, c_max, 1)
        self.cnn3_weight = param(z, dim, dim, 1, k)
        self.cnn4_weight = param(z, dim, dim, 1, k)
        scatter = torch.as_tensor(zone_scatter(indices, mask, c_full), device=device)
        self.register_buffer("scatter", scatter, persistent=False)
        self.register_buffer(
            "mask", torch.as_tensor(np.asarray(mask, np.float32), device=device),
            persistent=False,
        )

    def prepare_fused_weights(self):
        """``(w12 (Z*O, K*C_full) tap-major, b12 (Z*O, 1), w3 (Z, O, K*O),
        w4)``, as ``conv4layers_prepare_fused_weights`` (heads.py:832):
        the temporal conv, its bias and the channel mask fused into the
        spatial conv, scattered to full-montage width."""
        wt = self.cnn1_weight[:, :, 0, 0, :]  # (Z, F, K)
        ws = self.cnn2_weight[..., 0]  # (Z, O, F, C_max)
        w12 = torch.einsum("zofc,zfk,zcC->zokC", ws, wt, self.scatter)
        b12 = torch.einsum("zofc,zc,zf->zo", ws, self.mask, self.cnn1_bias)
        z, o, k, c = w12.shape

        def tap_major(w):  # (Z, O, I, 1, K) -> (Z, O, K*I)
            return w[:, :, :, 0, :].permute(0, 1, 3, 2).reshape(z, o, -1).contiguous()

        return (
            w12.reshape(z * o, k * c).contiguous(),
            b12.reshape(z * o, 1).contiguous(),
            tap_major(self.cnn3_weight),
            tap_major(self.cnn4_weight),
        )

    def forward(self, x: torch.Tensor, window_len: int, step: int) -> torch.Tensor:
        """``x (B, C_full, T)`` -> per-window zone features ``(B, N, Z, O)``."""
        w12, b12, w3, w4 = self.prepare_fused_weights()
        feat = fused_conv4_head(x.contiguous(), w12, b12, w3, w4, window_len, step)
        return feat.view(x.shape[0], feat.shape[1], w3.shape[0], w3.shape[1])
