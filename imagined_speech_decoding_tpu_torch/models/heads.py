"""The zone heads, zone-stacked: Conv4Layers, CVBlock, EEGNet_Encoder and
HeadConv_Paper_Version.

Counterpart of ``imagined_speech_decoding_tpu/models/heads.py``.

Conv4Layers: the parameters keep the
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

The batch-norm heads (``ZoneHead``: ``CVBlockHead``, ``EEGNetEncoderHead``,
``HeadConvPaperHead``) run on windows gathered into the zone layout, as
JAX ``fast_forward_head`` runs them (``fast.py:221-259``): the ``(M, B,
C, T)`` input is cut into N windows, flattened into the batch and
gathered to ``(B*N, M*Z, C_max, W)`` with the padded rows zeroed, and
every convolution is one grouped convolution over the M*Z (model, zone)
instances. Their parameters have the JAX tree's names and layouts
(``head.conv1.w (M, Z, O, I, kh, kw)``, ``head.bn1.scale (M, Z, F)``,
``head.projector.w (M, Z, d_in, d_out)``) and their running statistics
are buffers of the same ``(M, Z, F)`` shape (``head.bn1.mean``), so a
JAX-layout ``(params, state)`` maps onto the ``state_dict`` key for key.

Masking, as in the JAX heads (``_mask_rows``, ``_bn_mask``): the first
batch norm takes its statistics over the real channel rows only, and the
padded rows contribute nothing to the spatial convolution after it. The
JAX heads re-zero those rows; here the spatial weights' padded rows are
zero instead (``w * mask``), which adds the same terms and gives the same
gradients without the ``(B*N, M*Z*F, C_max, T)`` re-masked copy. That
first block (temporal conv, batch norm, spatial conv: ``first_block``)
runs in chunks of whole (model, zone) groups, each under
``torch.utils.checkpoint`` in training: its activations are the largest
tensors of the network (5.8e9 elements at M = 75, B = 64; the normalised
one f32, 23 GB, as JAX's bf16 policy promotes the affine to the f32
parameters), past what cuDNN indexes, and the chunks keep one chunk of
them alive. The running statistics are written once, from the forward;
the recompute in backward computes them again and discards them.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..ops.cuda.conv4head import fused_conv4_head
from ..ops.norm import BNState, StackedBatchNorm, batch_norm
from ..ops.windowing import sliding_window, zone_gather
from ..parallel.mesh import group_total
from .modules import (Leaves, Stacked, adaptive_avg_pool_1, avg_pool, conv2d, elu, gelu,
                      group_dropout, temporal_conv)


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
        """``x (M, B, C_full, T)`` -> per-window zone features ``(M, B, N, Z, O)``
        in x's dtype. The fused weights stay f32 (the head rounds them to a
        bf16 x's dtype itself) and the head's f32 features are cast to x's
        dtype, as JAX ``fast_forward_head`` does (``models/fast.py:170-172``)."""
        w12, b12, w3, w4 = self.fused_weights()
        feat = fused_conv4_head(x.contiguous(), w12, b12, w3, w4, window_len, step).to(x.dtype)
        return feat.view(*feat.shape[:3], w3.shape[1], w3.shape[2])


# ---------------------------------------------------------------------------
# Parameter specs: one list per head drives both the module and the draws
# ---------------------------------------------------------------------------

def _conv(name, o, i, kh, kw, bias=False):
    return ("conv", name, (o, i, kh, kw), bias)


def _linear(name, d_in, d_out):
    return ("linear", name, d_in, d_out)


def _bn(name, f):
    return ("bn", name, f)


def _cv_flat_dim(window_len: int) -> int:
    """CVBlock's projector input (heads.py ``_cv_flat_dim``)."""
    t1 = window_len + 2 * (64 // 2) - 64 + 1
    t3 = t1 // 8 + 2 * (16 // 2) - 16 + 1
    return 16 * (t3 // 2)


def head_spec(name: str, c_max: int, dim: int, window_len: int) -> list:
    """One zone's parameters of head ``name``, in ``*_init``'s order."""
    if name == "Conv4Layers":
        k = Conv4LayersHead.KERNEL
        return [_conv("cnn1", dim, 1, 1, k, bias=True), _conv("cnn2", dim, dim, c_max, 1),
                _conv("cnn3", dim, dim, 1, k), _conv("cnn4", dim, dim, 1, k)]
    if name == "CVBlock":
        return [_conv("conv1", 8, 1, 1, 64), _conv("conv2", 16, 1, c_max, 1),
                _conv("conv3", 16, 16, 1, 16), _linear("projector", _cv_flat_dim(window_len), dim),
                _bn("bn1", 8), _bn("bn2", 16), _bn("bn3", 16)]
    if name == "EEGNet_Encoder":
        return [_conv("temporal", 8, 1, 1, 64), _conv("spatial", 16, 1, c_max, 1),
                _conv("sep_depth", 16, 1, 1, 16), _conv("sep_point", 16, 16, 1, 1),
                _linear("projector", 16, dim), _bn("bn1", 8), _bn("bn2", 16), _bn("bn3", 16)]
    if name == "HeadConv_Paper_Version":
        f1, f2, f3, f4 = dim // 2, dim // 3, dim // 3, dim
        return [_conv("cnn1_t", f1, 1, 1, 3, bias=True), _conv("cnn1_s", f1, f1, c_max, 1),
                _conv("cnn2", f2, f1, 1, 3), _conv("cnn3", f3, f2, 1, 3),
                _conv("cnn4", f4, f3, 1, 3)] + [_bn(f"norm{i}", f)
                                                 for i, f in zip(range(1, 5), (f1, f2, f3, f4))]
    raise KeyError(f"unknown head {name!r}; available: {sorted(HEAD_REGISTRY)}")


def head_init(rng: np.random.Generator, head_name: str, n_zones: int, c_max: int,
              feature_dim: int, window_len: int) -> Tuple[dict, dict]:
    """One model's zone-stacked ``(params, state)`` in the JAX layout, drawn
    from ``rng`` with ``head_init``'s distributions: U(+-1/sqrt(fan_in))
    for every conv and linear weight and bias (``conv2d_init``,
    ``linear_init``), ones / zeros for the batch norms' scale / bias, and
    ``BNState(mean=0, var=1)``. The zones are drawn together, leaf by
    leaf."""
    z = n_zones

    def fan_in(shape, n):
        bound = 1.0 / math.sqrt(n)
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    params: dict = {}
    state: dict = {}
    for entry in head_spec(head_name, c_max, feature_dim, window_len):
        kind, name = entry[:2]
        if kind == "conv":
            shape, bias = entry[2], entry[3]
            fan = shape[1] * shape[2] * shape[3]
            params[name] = {"w": fan_in((z,) + shape, fan)}
            if bias:
                params[name]["b"] = fan_in((z, shape[0]), fan)
        elif kind == "linear":
            d_in, d_out = entry[2:]
            params[name] = {"w": fan_in((z, d_in, d_out), d_in),
                            "b": fan_in((z, d_out), d_in)}
        else:
            f = entry[2]
            params[name] = {"scale": np.ones((z, f), np.float32),
                            "bias": np.zeros((z, f), np.float32)}
            state[name] = BNState(np.zeros((z, f), np.float32), np.ones((z, f), np.float32))
    return params, state


# ---------------------------------------------------------------------------
# The batch-norm heads
# ---------------------------------------------------------------------------

def chunk_groups(models: int, zones: int, fit: int) -> int:
    """(model, zone) groups a chunk of the first block, given that ``fit``
    of them fit a chunk: whole models when one fits (the most whose count
    divides the models), else the most zones of a model that divide its
    zones (at least one). Every chunk is the same size, so the card runs
    each with the same convolution algorithms, and a model computes alike
    at any row of the stack: two sweep rows of one configuration stay
    equal bit for bit (on an H100 a smaller last chunk took other
    algorithms, and its rows parted in the last bits)."""
    if fit >= zones:
        return zones * max(k for k in range(1, models + 1) if models % k == 0 and k * zones <= fit)
    return max(d for d in range(1, zones + 1) if zones % d == 0 and d <= max(fit, 1))


class ZoneHead(Stacked):
    """Base of the batch-norm heads: builds the parameters of ``head_spec``
    (each zone-stacked, after a leading model axis when stacked), gathers
    the windows and runs ``encode`` on them.

    ``forward(x (M, B, C_full, T), window_len, step, generator)`` -> per
    window zone features ``(M, B, N, Z, F)``. The features keep the dtype
    the head computes in: a bf16 x runs the first convolution and batch
    statistics in bf16, and every layer after the first batch norm in f32,
    as JAX's promotion of the affine to the f32 parameters makes it."""

    NAME = ""
    CHUNK_ELEMS = 1 << 28  # elements of the temporal conv's output per chunk of the first block

    def __init__(self, indices: np.ndarray, mask: np.ndarray, feature_dim: int,
                 window_len: int, n_models: Optional[int] = None, device=None):
        super().__init__(n_models)
        self.z, self.c_max = indices.shape
        self.feature_dim = feature_dim
        for entry in head_spec(self.NAME, self.c_max, feature_dim, window_len):
            kind, name = entry[:2]
            if kind == "conv":
                shape, bias = entry[2], entry[3]
                leaves = {"w": (self.z,) + shape}
                if bias:
                    leaves["b"] = (self.z, shape[0])
                setattr(self, name, Leaves(n_models, device, **leaves))
            elif kind == "linear":
                d_in, d_out = entry[2:]
                setattr(self, name, Leaves(n_models, device, w=(self.z, d_in, d_out),
                                           b=(self.z, d_out)))
            else:
                setattr(self, name, StackedBatchNorm(self.z, entry[2], n_models=n_models,
                                                     device=device))
        m = np.asarray(mask, np.float32)
        self.register_buffer("zone_mask", torch.as_tensor(m, device=device), persistent=False)
        flat = np.where(m > 0, np.asarray(indices), 0).reshape(-1)
        self.register_buffer("gather_index", torch.as_tensor(flat, device=device),
                             persistent=False)

    @property
    def models(self) -> int:
        return 1 if self.n_models is None else self.n_models

    def w(self, name: str, key: str = "w") -> torch.Tensor:
        """A conv leaf's weight folded over (model, zone): ``(M*Z*O, I, kh, kw)``."""
        p = getattr(self, name).stacked(key)
        return p.reshape(-1, *p.shape[3:])

    def gather(self, x: torch.Tensor, window_len: int, step: int) -> torch.Tensor:
        """``x (M, B, C_full, T)`` -> ``(B*N, M*Z, C_max, W)``: the windows
        (``sliding_window``), trial-major, gathered into the zone layout
        with the padded rows zeroed (``zone_gather``)."""
        m, b = x.shape[:2]
        xz, _ = zone_gather(x, self.gather_index.view(self.z, self.c_max), self.zone_mask)
        w = sliding_window(xz, window_len, step)  # (M, B, Z, C_max, N, W)
        n = w.shape[4]
        w = w.permute(1, 4, 0, 2, 3, 5).reshape(b * n, m * self.z, self.c_max, window_len)
        return w.contiguous()

    def row_mask(self, f: int) -> torch.Tensor:
        """The channel-row mask of a ``(B', M*Z*f, C_max, T)`` activation,
        ``(1, M*Z*f, C_max, 1)``."""
        mask = self.zone_mask[None, :, None, :].expand(self.models, self.z, f, self.c_max)
        return mask.reshape(1, -1, self.c_max, 1)

    def spatial_weight(self, name: str) -> torch.Tensor:
        """The depthwise spatial conv's ``(M*Z*O, 1, C_max, 1)`` weight with
        the padded rows zeroed."""
        w = getattr(self, name).stacked("w")  # (M, Z, O, 1, C_max, 1)
        w = w * self.zone_mask[None, :, None, None, :, None]
        return w.reshape(-1, *w.shape[3:])

    def first_block(self, xz: torch.Tensor, temporal: str, bn: StackedBatchNorm,
                    spatial: str) -> torch.Tensor:
        """The first block of CVBlock and EEGNet_Encoder: the temporal (1, 64)
        conv ``temporal`` of ``xz (B', M*Z, C_max, W)`` (padding 32), ``bn``
        over its ``(B', M*Z*f, C_max, W+1)`` output with the channel-row
        mask, then the depthwise spatial conv ``spatial`` (its padded rows
        zero) -> ``(B', M*Z*O, 1, W+1)``.

        The statistics are per channel, so the block runs in chunks of
        whole (model, zone) groups, each at most ``CHUNK_ELEMS`` elements of
        the temporal conv's output (cuDNN indexes a tensor with 32 bits: the
        whole output is 5.8e9 elements at M = 75, B = 64), all of one size
        (``chunk_groups``). Training with
        gradients, each chunk is checkpointed: the backward keeps only the
        gathered windows and recomputes the chunk. Kept instead, the
        chunks' activations do not fit an 80 GB H100 at that size, in bf16
        or in f32 (``bn_head_memory.py``). The running statistics are
        written once, from the forward. A symbolic batch (an export) runs
        in one piece."""
        groups = self.models * self.z
        w1 = self.w(temporal)
        f = w1.shape[0] // groups
        train = self.training
        checkpointed = train and torch.is_grad_enabled()
        b = xz.shape[0]
        step = groups
        group = bn.sync_group if train else None
        if isinstance(b, int):
            if group is not None:  # the whole batch's chunks, so every rank's collectives pair up
                b = group_total(b, group, xz.device)
            per_group = max(b, 1) * f * self.c_max * (xz.shape[-1] + 1)
            step = chunk_groups(self.models, self.z, self.CHUNK_ELEMS // per_group)
        params, state = bn.flat()
        # The forward's copy: the buffers change in place before the
        # recompute reads its inputs again.
        state = BNState(state.mean.clone(), state.var.clone())
        w2 = self.spatial_weight(spatial)
        o = w2.shape[0] // (groups * f)
        rows = self.row_mask(f)

        def block(xc, w1c, scale, bias, mean, var, mask, w2c):
            h = conv2d(xc, w1c, padding=((0, 0), (32, 32)), groups=xc.shape[1])
            y, new = batch_norm(h, {"scale": scale, "bias": bias}, BNState(mean, var),
                                train=train, mask=mask, group=group)
            return conv2d(y, w2c, groups=h.shape[1]), new.mean, new.var

        cf = step * f
        parts = zip(xz.split(step, 1), w1.split(cf), params["scale"].split(cf),
                    params["bias"].split(cf), state.mean.split(cf), state.var.split(cf),
                    rows.split(cf, 1), w2.split(cf * o))
        outs, means, variances = [], [], []
        for args in parts:
            if checkpointed:
                y, mean, var = checkpoint(block, *args, use_reentrant=False)
            else:
                y, mean, var = block(*args)
            outs.append(y)
            means.append(mean)
            variances.append(var)
        if train:
            bn.update(BNState(torch.cat(means), torch.cat(variances)))
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)

    def project(self, h: torch.Tensor) -> torch.Tensor:
        """The per-(model, zone) projector: ``h (B', M*Z, d_in)`` ->
        ``(B', M*Z, F)``, as JAX ``linear`` (product, then the bias, in
        h's dtype)."""
        w = self.projector.stacked("w")
        b = self.projector.stacked("b")
        g = w.shape[0] * w.shape[1]
        y = torch.bmm(h.transpose(0, 1), w.reshape(g, *w.shape[2:]).to(h.dtype))
        return y.transpose(0, 1) + b.reshape(1, g, -1).to(h.dtype)

    def encode(self, xz: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor, window_len: int, step: int,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        m, b = x.shape[:2]
        xz = self.gather(x, window_len, step)
        feat = self.encode(xz, generator)  # (B*N, M*Z, F)
        n = (x.shape[-1] - window_len) // step + 1
        feat = feat.reshape(b, n, m, self.z, feat.shape[-1])
        return feat.permute(2, 0, 1, 3, 4)


class CVBlockHead(ZoneHead):
    """CVBlock (``cvblock_apply``): temporal (1, 64) conv, masked batch norm,
    depthwise spatial (C_max, 1) conv (x2), batch norm, ELU, (1, 8) average
    pool, dropout 0.5, (1, 16) conv, batch norm, ELU, (1, 2) pool, dropout,
    flatten, projector."""

    NAME = "CVBlock"
    DROPOUT = 0.5

    def encode(self, xz, generator):
        g = self.models * self.z
        h = self.first_block(xz, "conv1", self.bn1, "conv2")  # (B', G*16, 1, T+1)
        h = avg_pool(elu(self.bn2(h)), (1, 8))
        h = group_dropout(h, self.models, self.DROPOUT, generator, self.training)
        h = conv2d(h, self.w("conv3"), padding=((0, 0), (8, 8)), groups=g)
        h = avg_pool(elu(self.bn3(h)), (1, 2))
        h = group_dropout(h, self.models, self.DROPOUT, generator, self.training)
        return self.project(h.flatten(1).unflatten(1, (g, -1)))


class EEGNetEncoderHead(ZoneHead):
    """EEGNet_Encoder (``eegnet_encoder_apply``): temporal (1, 64) conv,
    masked batch norm, depthwise spatial conv (x2), batch norm, ELU,
    (1, 4) pool, dropout 0.25, separable conv (depthwise (1, 16), pointwise),
    batch norm, ELU, (1, 8) pool, dropout, global average, projector."""

    NAME = "EEGNet_Encoder"
    DROPOUT = 0.25

    def encode(self, xz, generator):
        g = self.models * self.z
        h = self.first_block(xz, "temporal", self.bn1, "spatial")  # (B', G*16, 1, T+1)
        h = avg_pool(elu(self.bn2(h)), (1, 4))
        h = group_dropout(h, self.models, self.DROPOUT, generator, self.training)
        h = conv2d(h, self.w("sep_depth"), padding=((0, 0), (8, 8)), groups=g * 16)
        h = conv2d(h, self.w("sep_point"), groups=g)
        h = avg_pool(elu(self.bn3(h)), (1, 8))
        h = group_dropout(h, self.models, self.DROPOUT, generator, self.training)
        h = adaptive_avg_pool_1(h)  # (B', G*16)
        return self.project(h.flatten(1).unflatten(1, (g, -1)))


def fuse_temporal_spatial(w_t: torch.Tensor, b_t: torch.Tensor, w_s: torch.Tensor,
                          mask: torch.Tensor):
    """``_fuse_temporal_spatial`` over leading (model, zone) axes: the
    temporal conv ``w_t (..., F, 1, 1, K)`` with its bias ``b_t (..., F)``,
    the channel mask ``mask (Z, C)`` and the spatial conv ``w_s (..., O, F,
    C, 1)`` composed into one ``(..., O, C, K)`` conv and ``(..., O)`` bias."""
    wt = w_t[..., :, 0, 0, :]  # (M, Z, F, K)
    ws = w_s[..., 0]  # (M, Z, O, F, C)
    w = torch.einsum("mzofc,mzfk->mzock", ws, wt)
    b = torch.einsum("mzofc,zc,mzf->mzo", ws, mask.to(ws.dtype), b_t)
    return w, b


def max_pool_time2(h: torch.Tensor) -> torch.Tensor:
    """Non-overlapping (1, 2) max pool over the last axis, floor semantics
    (``_max_pool_time2``)."""
    t = h.shape[-1] // 2 * 2
    return h[..., :t].reshape(*h.shape[:-1], t // 2, 2).amax(dim=-1)


class HeadConvPaperHead(ZoneHead):
    """HeadConv_Paper_Version (``headconv_paper_apply``): the temporal (1, 3)
    conv with bias, the channel mask and the spatial conv fused into one
    conv, then batch norm, GELU, (1, 2) max pool, and three (1, 3) conv,
    batch norm, GELU, max pool stages; the mean over time. Every conv runs
    as shifted GEMMs (``temporal_conv``), as in JAX; no dropout."""

    NAME = "HeadConv_Paper_Version"

    def _bn(self, h: torch.Tensor, bn: StackedBatchNorm) -> torch.Tensor:
        b, g, f, t = h.shape
        return bn(h.reshape(b, g * f, 1, t)).reshape(b, g, f, t)

    def encode(self, xz, generator):
        g = self.models * self.z
        w12, b12 = fuse_temporal_spatial(self.cnn1_t.stacked("w"), self.cnn1_t.stacked("b"),
                                         self.cnn1_s.stacked("w"), self.zone_mask)
        h = temporal_conv(xz, w12.reshape(g, *w12.shape[2:]), b12.reshape(g, -1))
        h = max_pool_time2(gelu(self._bn(h, self.norm1)))
        for i in (2, 3, 4):
            w = getattr(self, f"cnn{i}").stacked("w")[..., 0, :]  # (M, Z, O, I, K)
            h = temporal_conv(h, w.reshape(g, *w.shape[2:]))
            h = max_pool_time2(gelu(self._bn(h, getattr(self, f"norm{i}"))))
        return h.mean(dim=-1)


HEAD_REGISTRY: Dict[str, type] = {
    "Conv4Layers": Conv4LayersHead,
    "CVBlock": CVBlockHead,
    "EEGNet_Encoder": EEGNetEncoderHead,
    "HeadConv_Paper_Version": HeadConvPaperHead,
}


def get_head(name: str) -> type:
    if name not in HEAD_REGISTRY:
        raise KeyError(f"unknown head {name!r}; available: {sorted(HEAD_REGISTRY)}")
    return HEAD_REGISTRY[name]
