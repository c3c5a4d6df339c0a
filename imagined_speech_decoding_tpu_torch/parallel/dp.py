"""Data-parallel training of one model: the batch split over a mesh axis,
the gradients all-reduced.

Counterpart of ``imagined_speech_decoding_tpu/parallel/dp.py``
(``shard_map`` + ``psum``). Each rank takes its slice of the batch, runs
the model on it and differentiates its LOCAL weighted NLL sum; the
gradients are then summed over the axis and divided by the summed weight,
outside autograd, so every rank applies the same update to the same
parameters. The weighted-loss contract makes the arithmetic exact under
the split: padding rows carry weight 0. As in the JAX step, each rank's
batch-norm statistics are its shard's, and the running statistics are
averaged over the axis afterwards; dropout draws from a generator seeded
from the step's seed and the rank's index on the axis
(``shard_generator``), as JAX folds the axis index into the key.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..train.metrics import confusion_matrix
from .mesh import Mesh, all_reduce_flat_, shard_leading_axis


class DPTrainState(NamedTuple):
    params: Dict[str, torch.Tensor]  # the module's parameters (trained in place)
    model_state: Dict[str, torch.Tensor]  # its persistent buffers (batch-norm statistics)
    opt_state: torch.optim.Optimizer  # the optimizer over ``params``
    step: int


def shard_generator(seed: int, index: int, device) -> torch.Generator:
    """The dropout generator of shard ``index`` of a step seeded ``seed``:
    one stream a (seed, shard) pair, as ``jax.random.fold_in(rng,
    axis_index)`` gives one key a shard."""
    mixed = int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(mixed % (1 << 63))


def weighted_ce_sums(logits: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor):
    """``(sum of weighted nll, sum of weights)`` of a shard, ready to be
    summed over the ranks."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    w = weights.float()
    return (nll * w).sum(), w.sum()


def make_dp_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                       n_classes: int, mesh: Mesh, axis_name: str = "data") -> Callable:
    """The data-parallel train step of ``model`` (one model, no model axis)
    and ``optimizer`` over its parameters: ``step(state, x (B, ...), y (B,),
    w (B,), seed) -> (state, {"loss", "acc"})``. ``x``, ``y`` and ``w`` are
    the whole batch, the same on every rank, with ``B`` divisible by the
    axis; each rank keeps its slice. ``state`` is a ``DPTrainState`` of the
    module and the optimizer."""
    group = mesh.groups[axis_name]
    k = mesh.size(axis_name)

    def step(state: DPTrainState, x, y, w, seed: int):
        xs, ys, ws = shard_leading_axis(mesh, (x, y, w), axis_name)
        gen = shard_generator(seed, mesh.index(axis_name), xs.device)
        model.train()
        logits = model(xs, generator=gen)
        num, den_local = weighted_ce_sums(logits, ys, ws)
        optimizer.zero_grad(set_to_none=False)
        num.backward()
        sums = torch.stack([num.detach(), den_local])
        dist.all_reduce(sums, group=group)
        den = sums[1].clamp_min(1.0)
        params = [p for p in model.parameters()]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        all_reduce_flat_(grads, group)
        for p, g in zip(params, grads):
            p.grad = g / den
        floats = [b for b in state.model_state.values() if b.is_floating_point()]
        if floats:  # batch-norm running statistics: the mean of the shards' updates
            all_reduce_flat_(floats, group)
            for b in floats:
                b.div_(k)
        optimizer.step()
        cm = confusion_matrix(logits.detach(), ys, n_classes, ws)
        dist.all_reduce(cm, group=group)
        metrics = {"loss": sums[0] / den,
                   "acc": torch.trace(cm) / cm.sum().clamp_min(1.0)}
        return DPTrainState(state.params, state.model_state, state.opt_state,
                            state.step + 1), metrics

    return step


def make_dp_eval_step(model: torch.nn.Module, n_classes: int, mesh: Mesh,
                      axis_name: str = "data") -> Callable:
    """The data-parallel eval step: ``eval(x, y, w) -> (loss_sum,
    weight_sum, confusion)``, each summed over the axis (the whole batch
    on every rank, as ``make_dp_train_step`` takes it)."""
    group = mesh.groups[axis_name]

    def evaluate(x, y, w):
        xs, ys, ws = shard_leading_axis(mesh, (x, y, w), axis_name)
        model.eval()
        with torch.no_grad():
            logits = model(xs)
        num, den = weighted_ce_sums(logits, ys, ws)
        cm = confusion_matrix(logits, ys, n_classes, ws)
        sums = torch.cat([torch.stack([num, den]), cm.reshape(-1)])
        dist.all_reduce(sums, group=group)
        return sums[0], sums[1], sums[2:].view_as(cm)

    return evaluate
