"""Batch normalization with a validity mask, and its stacked module.

Counterpart of ``imagined_speech_decoding_tpu/ops/norm.py``: ``BNState``,
``bn_init``, ``batch_norm`` and ``bn_sample_mask`` as plain tensor
functions, and ``StackedBatchNorm``, the module the zone heads and
TSception hold their statistics in (parameters ``scale`` / ``bias``,
running ``mean`` / ``var`` buffers, each ``([M,] *features)``).

Semantics are ``torch.nn.BatchNorm2d``'s: normalise with the biased batch
variance, update the running statistics with the unbiased one,
``new = (1 - momentum) * old + momentum * batch``, momentum 0.1, eps 1e-5.
A ``mask`` restricts the statistics to the entries where it is 1: the
zero-padded channel rows of the zone layout (the default montage's zones
of 4-15 channels padded to 15) and nothing else. ``F.batch_norm`` would
count those rows, so it is not used.

Rounding follows the JAX function step by step in bf16: the sums run in
f32 and round to x's dtype (``jnp.sum`` / ``jnp.mean`` of a bf16 array),
the count, the division, the variance and the normalisation run in x's
dtype with scalars rounded to it first (JAX's weak types), the running
update runs in the state's dtype (f32), and the affine ``y * scale + bias``
promotes to the parameters' f32, as JAX promotes it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..models.modules import Stacked
from ..parallel.mesh import all_reduce_sum


class BNState(NamedTuple):
    mean: torch.Tensor  # (F,)
    var: torch.Tensor  # (F,)


def bn_init(num_features: int, dtype=torch.float32, device=None) -> Tuple[dict, BNState]:
    params = {"scale": torch.ones(num_features, dtype=dtype, device=device),
              "bias": torch.zeros(num_features, dtype=dtype, device=device)}
    state = BNState(mean=torch.zeros(num_features, dtype=dtype, device=device),
                    var=torch.ones(num_features, dtype=dtype, device=device))
    return params, state


def _scalar(v: float, like: torch.Tensor) -> float:
    """A Python scalar rounded to ``like``'s dtype first, as JAX's weak
    types round it (PyTorch would keep it at f32 inside the operation).
    Rounded on the host: no copy to the device, so a CUDA graph captures
    the ops that use it."""
    return float(torch.tensor(v, dtype=like.dtype))


def _batch_stats(x: torch.Tensor, mask: Optional[torch.Tensor], axes: Sequence[int],
                 group=None):
    """``(mean, var, n)`` over ``axes`` in x's dtype (``n`` a float for no
    mask, else a tensor of x's dtype), each rounding where JAX rounds.

    ``group``: a process group over which x's batch (axis 0) is split
    (``parallel.mesh``'s data axis). The f32 sums and counts are then summed
    over it inside autograd (``all_reduce_sum``: the gradient flows through
    the other ranks' rows too) before the same roundings, which gives the
    statistics of the whole batch, and the gradients through them, as JAX's
    GSPMD program computes them (counts below 2**24 stay exact in f32);
    ``n`` is then an f64 tensor for no mask."""
    xd = x.dtype
    if mask is None:
        m, xm = None, x
        n = 1.0
        for i in axes:
            n *= x.shape[i]
    else:
        m, n = _mask_count(x, mask, axes)
        xm = x * m
    s1 = xm.sum(dim=axes, dtype=torch.float32)
    if group is not None:  # the whole batch's sum and count, in one collective
        count = n.expand(s1.shape) if m is not None else torch.full_like(s1, n)
        s1, count = all_reduce_sum(torch.cat([s1.reshape(-1), count.reshape(-1)]),
                                   group).split(s1.numel())
        s1, n = s1.view(_keep_shape(x, axes)), count.detach().view(_keep_shape(x, axes))

    def total(t):
        return t if group is None else all_reduce_sum(t, group)

    if m is None:
        mean = (s1 / n).to(xd)
        d = x - mean.reshape(_keep(x, axes))
        var = (total((d * d).sum(dim=axes, dtype=torch.float32)) / n).to(xd)
        return mean, var, (n if group is None else n.double())
    n = n.to(xd)
    n1 = n.clamp_min(1.0)
    mean = s1.to(xd) / n1
    d = x - mean.reshape(_keep(x, axes))
    var = total((m * (d * d)).sum(dim=axes, dtype=torch.float32)).to(xd) / n1
    return mean, var, n


def _mask_count(x: torch.Tensor, mask: torch.Tensor, axes: Sequence[int]):
    """``(mask in x's dtype, broadcast to x's rank; its f32 count over axes)``.
    The count is exact (an integer sum); JAX sums the broadcast mask in f32
    and rounds it to x's dtype, as the callers do."""
    m = mask.to(x.dtype)
    m = m.reshape((1,) * (x.dim() - m.dim()) + tuple(m.shape))
    reps = 1
    for i in axes:
        if m.shape[i] == 1:
            reps *= x.shape[i]
    return m, (m.double().sum(dim=axes) * reps).to(torch.float32)


def _keep_shape(x: torch.Tensor, axes: Sequence[int]) -> Tuple[int, ...]:
    """The shape of a sum of x over ``axes``."""
    return tuple(x.shape[i] for i in range(x.dim()) if i not in axes)


def _keep(x: torch.Tensor, axes: Sequence[int]) -> Tuple[int, ...]:
    return tuple(1 if i in axes else x.shape[i] for i in range(x.dim()))


def batch_norm(
    x: torch.Tensor,
    params: dict,
    state: BNState,
    *,
    train: bool,
    mask: Optional[torch.Tensor] = None,
    feature_axis: int = 1,
    momentum: float = 0.1,
    eps: float = 1e-5,
    group=None,
) -> Tuple[torch.Tensor, BNState]:
    """Batch normalization over all axes except ``feature_axis``
    (``ops.norm.batch_norm``). ``mask`` broadcasts against ``x``; entries
    where it is 0 are left out of the statistics (their outputs are still
    normalized: callers re-mask if they need to). ``group``: the process
    group x's batch is split over, in training (``_batch_stats``). Returns
    ``(y, new state)``; ``y`` has the promoted dtype of x and the
    parameters."""
    feature_axis %= x.dim()
    shape = [1] * x.dim()
    shape[feature_axis] = x.shape[feature_axis]
    scale = params["scale"].reshape(shape)
    bias = params["bias"].reshape(shape)
    axes = tuple(i for i in range(x.dim()) if i != feature_axis)
    if train:
        mean, var, n = _batch_stats(x, mask, axes, group)
        if isinstance(n, float):
            factor = _scalar(n / max(n - 1.0, 1.0), var)
        elif n.dtype == torch.float64:  # a float count summed over a group: as above
            factor = (n / (n - 1.0).clamp_min(1.0)).to(var.dtype)
        else:
            factor = n / (n - 1.0).clamp_min(1.0)
        unbiased = var * factor
        new_state = BNState(
            mean=(1 - momentum) * state.mean + momentum * mean.to(state.mean.dtype),
            var=(1 - momentum) * state.var + momentum * unbiased.to(state.var.dtype),
        )
        y = (x - mean.reshape(shape)) * torch.reciprocal(
            torch.sqrt(var.reshape(shape) + _scalar(eps, var)))
    else:
        new_state = state
        m_ = state.mean.reshape(shape).to(x.dtype)
        v_ = state.var.reshape(shape).to(x.dtype)
        y = (x - m_) * torch.reciprocal(torch.sqrt(v_ + _scalar(eps, v_)))
    return y * scale + bias, new_state


def bn_sample_mask(
    x: torch.Tensor,
    sample_weight: Optional[torch.Tensor],
    channel_mask: Optional[torch.Tensor] = None,
) -> Optional[torch.Tensor]:
    """Per-sample weights ``(B,)`` (batch at axis 0 of ``x``) combined with
    an optional pre-broadcast channel mask into one BN mask."""
    if sample_weight is None:
        return channel_mask
    m = sample_weight.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)
    return m if channel_mask is None else m * channel_mask.to(x.dtype)


class StackedBatchNorm(Stacked):
    """Batch norm whose features are ``([M,] *features)``: the parameters
    ``scale`` (ones) and ``bias`` (zeros) and the running-statistics buffers
    ``mean`` (zeros) and ``var`` (ones) carry that shape, the JAX layout of a
    zone-stacked ``bn_init`` after a leading model axis.

    ``forward(x, mask)`` takes ``x (B, M * prod(features), H, W)``, the
    features in the buffers' row-major order on axis 1 (the channel order
    of a grouped convolution over the stacked models and zones), and
    normalises per channel over axes 0, 2 and 3. In training mode it
    uses the batch statistics and writes the new running statistics into
    the buffers in place; in eval mode it uses the buffers. ``sync_group``
    (None, or the process group the batch is split over: set by
    ``train.engine.make_fit`` under a data axis) sums the statistics over
    it."""

    def __init__(self, *features: int, n_models: Optional[int] = None, device=None):
        super().__init__(n_models)
        self.sync_group = None
        self.scale = self._param(*features, fill=1.0, device=device)
        self.bias = self._param(*features, device=device)
        lead = () if n_models is None else (n_models,)
        self.register_buffer("mean", torch.zeros(lead + features, device=device))
        self.register_buffer("var", torch.ones(lead + features, device=device))

    def flat(self):
        """``(params, state)`` flattened to one feature axis, for ``batch_norm``."""
        return ({"scale": self.scale.reshape(-1), "bias": self.bias.reshape(-1)},
                BNState(self.mean.reshape(-1), self.var.reshape(-1)))

    def update(self, new: BNState) -> None:
        """Copy a new running state (flat, from ``batch_norm``) into the buffers."""
        with torch.no_grad():
            self.mean.copy_(new.mean.detach().view_as(self.mean))
            self.var.copy_(new.var.detach().view_as(self.var))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        params, state = self.flat()
        y, new = batch_norm(x, params, state, train=self.training, mask=mask,
                            group=self.sync_group)
        if self.training:
            self.update(new)
        return y
