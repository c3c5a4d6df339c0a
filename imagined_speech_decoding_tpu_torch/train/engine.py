"""The training engine: a stack of M models trained together.

Counterpart of ``imagined_speech_decoding_tpu/train/engine.py``
(``make_fit`` / ``fit_many``). Where the JAX engine ``jax.vmap``s one
model's compiled fit over a model axis, the port trains ``FAST(cfg,
n_models=M)``, whose parameters and inputs carry that axis explicitly:
each model gathers its own batch through its own index rows into the
shared corpus, and the per-model losses are summed before ``backward``,
so each model's gradient is its own loss's gradient.

Kept from ``make_fit``: AdamW (betas 0.9/0.999, eps 1e-8, weight decay on
every parameter) with the learning rate set per step from the
warmup-cosine table; the pad-free ragged tail (280 trials at batch 64
run as 4 x 64 + 1 x 24 exact-shape steps); the eval batch rule (70 ->
2 x 35); train and validation history rows, NaN validation rows on the
epochs ``val_every`` skips; the best snapshot on a strictly greater
``val_acc``, per model; segmented execution with checkpoints and resume
(``fit_segmented``); sweep mode (``make_fit(sweep=True)``: a learning
rate and weight decay per model row, ``RowAdamW``). Early stopping is not
ported (ROADMAP.md).

Model state: a model's persistent buffers (the batch-norm heads' and
TSception's running statistics) are its mutable state, the JAX engine's
``mstate``. A train step updates them in the forward (training mode);
``evaluate`` and ``predict`` run in eval mode, on them; the best
snapshot takes them with the parameters, and ``FitResult`` and the
segment carry hold them (``model_state``, ``best_model_state``). The
ragged tail's step is exact-shape, so its batch statistics are taken
over its real rows, as JAX's zero-weight padding rows are masked out of
them.

Augmentation (``make_fit(augment=(noise_sigma, ch_drop))``): each train
step draws the noise and channel keeps from the dropout generator, before
the model's own dropout masks, and applies them to the gathered batch
before it is cast to the compute dtype (``compute_dtype``), as JAX's
augmented model applies them before ``fast_apply`` casts; evaluation sees
the batch as it is.

Randomness: epoch permutations come from a CPU ``torch.Generator``
(``data.arrays.epoch_permutations``), so a seed gives the same batches on
any device; dropout draws from a generator on the training device.
Neither reproduces the JAX package's ``jax.random`` streams. With
``row_repeats=R`` a stack of ``M = R x G`` rows draws both for its first
G rows and repeats them R times, so that row ``r*G + g`` sees row g's
batches and dropout masks (the sweep's configs share each fold's
stream, as the JAX sweep gives them the same keys).

A stack on several ranks (``make_fit(shard=...)``, a
``parallel.mesh.StackShard``): the module is this rank's rows of the stack
and the fit is given the whole stack's index rows, hyperparameters and
carry, of which it keeps its rows. Every draw is made at the unsharded
shape and cut to this rank's part (the epoch permutations of the whole
stack; dropout and augmentation through a ``SharedRowsGenerator``), so the
run is the unsharded one. Under a data axis each model's batch is split
over the ranks (evenly: a short batch leaves ranks empty, which run the
step on no trials and join every collective); each rank differentiates
its local NLL sum over the whole batch's row count, the gradients are
summed in one flat all-reduce before the optimizer step (AdamW and
``RowAdamW`` then move every rank the same way), the batch-norm
statistics are summed across the ranks (``ops.norm``), and the train and
validation sums are all-reduced before any metric is read, so the best
snapshot and the early-stop flags agree on every rank. ``result``,
``FitCarry.arrays`` and the progress callback see the whole stack,
gathered from the ranks' rows.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..data.arrays import epoch_permutations, num_batches
from ..models.modules import SharedRowsGenerator
from ..ops.augment import augment_batch
from ..ops.norm import StackedBatchNorm
from ..parallel.mesh import all_reduce_flat_, any_rank, is_lead
from .metrics import confusion_matrix, f1_from_confusion
from .schedule import lr_at, warmup_cosine_lr

HISTORY_KEYS = ("loss", "acc", "f1", "val_loss", "val_acc", "val_f1")


class FitResult(NamedTuple):
    params: Dict[str, torch.Tensor]  # final parameters, stacked (M, ...)
    best_params: Dict[str, torch.Tensor]  # snapshot at each model's best val_acc
    best_val_acc: np.ndarray  # (M,)
    best_epoch: np.ndarray  # (M,), -1 if no validation epoch ran
    history: Dict[str, np.ndarray]  # each (M, E)
    timings: Dict[str, object]  # host seconds: per-epoch train and validation passes
    model_state: Dict[str, torch.Tensor] = {}  # final persistent buffers (BN statistics)
    best_model_state: Dict[str, torch.Tensor] = {}  # the buffers of each model's best snapshot


def model_buffers(model) -> Dict[str, torch.Tensor]:
    """The module's persistent buffers by ``state_dict`` key: its mutable
    state (the batch-norm running statistics; none for the Conv4Layers FAST)."""
    out = {}
    for mname, mod in model.named_modules():
        for bname, b in mod.named_buffers(recurse=False):
            if b is not None and bname not in mod._non_persistent_buffers_set:
                out[f"{mname}.{bname}" if mname else bname] = b
    return out


def make_optimizer(params, weight_decay: float = 0.01) -> torch.optim.AdamW:
    """AdamW with torch-default betas/eps and decay on every parameter.

    torch's decoupled decay, ``p <- p - lr*wd*p`` then ``p <- p - lr * m_hat
    / (sqrt(v_hat) + eps)``, is optax's ``adamw`` update ``-lr * (m_hat /
    (sqrt(v_hat) + eps) + wd * p)`` with ``p`` the pre-update value, and both
    bias-correct with the 1-based step count (tests/test_torch_train.py
    holds one step against ``optax.adamw``). The learning rate is set per
    step by ``train_step``."""
    return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


class RowAdamW(torch.optim.Optimizer):
    """AdamW over stacked parameters (model axis first) with a learning rate
    and a weight decay per model row: the sweep mode's optimizer.

    ``lr`` and ``weight_decay`` of its group are ``(M,)`` tensors on the
    parameters' device, broadcast along axis 0; ``train_step`` sets ``lr``
    each step. The update is optax ``adamw``'s, row by row::

        m <- b1 m + (1 - b1) g;  v <- b2 v + (1 - b2) g^2   (``make_optimizer``'s moments)
        p <- p - lr * (m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) + wd * p)

    which is the JAX sweep's ``-lr_t (adam_dir + wd' p)`` (JAX
    ``train/engine.py:219-236``). Its state has ``torch.optim.AdamW``'s keys
    and layout (``step`` a CPU f32 scalar, ``exp_avg``, ``exp_avg_sq``), so
    ``FitCarry.arrays`` / ``load_arrays`` carry it unchanged."""

    def __init__(self, params, lr: torch.Tensor, weight_decay: torch.Tensor,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            for p in params:
                if not self.state[p]:
                    self.state[p] = {"step": torch.tensor(0.0),
                                     "exp_avg": torch.zeros_like(p),
                                     "exp_avg_sq": torch.zeros_like(p)}
            states = [self.state[p] for p in params]
            grads = [p.grad for p in params]
            m = [st["exp_avg"] for st in states]
            v = [st["exp_avg_sq"] for st in states]
            torch._foreach_add_([st["step"] for st in states], 1.0)
            # The bias corrections in f32 from the f32 step count, as optax's
            # and torch's AdamW compute them.
            t = states[0]["step"]
            bc1, bc2 = float(1 - b1 ** t), float(1 - b2 ** t)
            torch._foreach_lerp_(m, grads, 1 - b1)
            torch._foreach_mul_(v, b2)
            torch._foreach_addcmul_(v, grads, grads, 1 - b2)
            denom = torch._foreach_div(v, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            upd = torch._foreach_div(m, bc1)
            torch._foreach_div_(upd, denom)
            rows = [(p.shape[0],) + (1,) * (p.dim() - 1) for p in params]
            torch._foreach_addcmul_(upd, params, [group["weight_decay"].view(r) for r in rows])
            torch._foreach_mul_(upd, [group["lr"].view(r) for r in rows])
            torch._foreach_sub_(params, upd)


def _nll_sum(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Each model's NLL summed over its trials, ``(M,)`` (0 for none)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, y.long().unsqueeze(-1)).squeeze(-1).sum(-1)


def train_step(model, opt: torch.optim.Optimizer, x: torch.Tensor, y: torch.Tensor, lr,
               n_classes: int, generator: Optional[torch.Generator] = None,
               augment=None, compute_dtype=None, data=None):
    """One optimizer step of every model on its batch ``x (M, b, C, T)``,
    ``y (M, b)``, at learning rate ``lr`` (a float; a ``(M,)`` tensor for
    ``RowAdamW``). ``augment``: ``(noise_sigma, ch_drop)`` applied to x
    first, from ``generator``; ``compute_dtype``: x's dtype for the model.
    ``data``: ``(group, b_full)`` when x is this rank's share of batches of
    ``b_full`` trials split over ``group`` (see the module docstring).
    Returns ``(loss * b (M,), confusion (M, K, K))``, the sums the epoch
    metrics are made of (over the whole batch under ``data``)."""
    data_group, b_full = data if data is not None else (None, y.shape[-1])
    for group in opt.param_groups:
        group["lr"] = lr
    if augment is not None:
        x = augment_batch(x, augment[0], augment[1], generator)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    logits = model(x, generator=generator)
    opt.zero_grad(set_to_none=True)
    nll = _nll_sum(logits, y)
    # each model's mean loss over the whole batch; the models are
    # independent, so each gets its own loss's gradient
    (nll.sum() / b_full).backward()
    # optax's adamw decays every parameter, one the loss does not reach too
    # (the train_head and train_transformer modes leave whole subtrees
    # out); torch's AdamW and RowAdamW skip a parameter whose .grad is None,
    # so such a parameter takes a zero gradient: its moments stay 0 and it
    # moves by -lr * wd * p, as in JAX.
    for group in opt.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    if data_group is not None:
        all_reduce_flat_([p.grad for g in opt.param_groups for p in g["params"]], data_group)
    opt.step()
    return _sum_metrics(nll.detach(), confusion_matrix(logits.detach(), y, n_classes),
                        data_group)


def _sum_metrics(loss_sum: torch.Tensor, cm: torch.Tensor, group):
    """``(loss_sum, cm)`` summed over ``group`` in one collective (as they
    are for none)."""
    if group is None:
        return loss_sum, cm
    flat = torch.cat([loss_sum, cm.reshape(-1)])
    dist.all_reduce(flat, group=group)
    return flat[: loss_sum.numel()], flat[loss_sum.numel():].view_as(cm)


def _epoch_metrics(loss_sum: torch.Tensor, cm: torch.Tensor):
    total = cm.sum(dim=(-2, -1)).clamp_min(1.0)
    acc = torch.diagonal(cm, dim1=-2, dim2=-1).sum(-1) / total
    return loss_sum / total, acc, f1_from_confusion(cm)


def evaluate(model, X: torch.Tensor, Y: torch.Tensor, idx: torch.Tensor, batch_size: int,
             n_classes: int, compute_dtype=None, shard=None):
    """``(loss, acc, f1)``, each ``(M,)``, of every model on its trials
    ``idx (M, n)`` in sequential batches of ``batch_size``, in eval mode
    (the running statistics); ``compute_dtype``: the batches' dtype for
    the model (default X's). ``shard``: a ``StackShard`` whose data axis
    splits each batch; the sums are then all-reduced over it."""
    was_training = model.training
    model.eval()
    m = idx.shape[0]
    split = shard is not None and shard.split_batch
    group = shard.data_group if split else None
    loss_sum = torch.zeros(m, device=X.device)
    cm = torch.zeros((m, n_classes, n_classes), device=X.device)
    with torch.no_grad():
        for s in range(0, idx.shape[1], batch_size):
            bidx = idx[:, s : s + batch_size]
            if split:
                c0, c1 = shard.batch_cols(bidx.shape[1])
                bidx = bidx[:, c0:c1]
            y = Y[bidx]
            xb = X[bidx]
            logits = model(xb if compute_dtype is None else xb.to(compute_dtype))
            loss_sum += _nll_sum(logits, y)
            cm += confusion_matrix(logits, y, n_classes)
    model.train(was_training)
    return _epoch_metrics(*_sum_metrics(loss_sum, cm, group))


def predict(model, x: torch.Tensor, batch_size: int = 64) -> np.ndarray:
    """Argmax predictions over the trials of ``x`` (``(N, C, T)`` for one
    model), in sequential batches (``engine.predict``)."""
    model.eval()
    with torch.no_grad():
        preds = [model(x[s : s + batch_size]).argmax(dim=-1).cpu()
                 for s in range(0, x.shape[0], batch_size)]
    return torch.cat(preds).numpy()


def predict_proba(model, x: torch.Tensor, batch_size: int = 64) -> np.ndarray:
    """Class posteriors ``(N, K)`` over the trials of ``x`` (``(N, C, T)``
    for one model): an f32 softmax of the logits, upcast from the compute
    dtype first, in sequential batches (``engine.predict_proba``): the unit
    of the seed ensemble's soft vote."""
    model.eval()
    with torch.no_grad():
        probs = [torch.softmax(model(x[s : s + batch_size]).float(), dim=-1).cpu()
                 for s in range(0, x.shape[0], batch_size)]
    return torch.cat(probs).numpy()


def eval_batch_size_for(n_val: int, batch_size: int) -> int:
    """Never more eval steps than the train size would take; among those,
    the fewest padded slots, then the largest batch (70 -> 35, 71 -> 36)."""
    if n_val < 1:
        return batch_size
    return min(
        range(1, min(batch_size, n_val) + 1),
        key=lambda b: (-(-n_val // b), -(-n_val // b) * b, -b),
    )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class FitCarry:
    """Everything a fit carries from one epoch to the next: the model's
    parameters (trained in place), its persistent buffers (the model
    state, updated in place) and its AdamW optimizer (``RowAdamW`` in
    sweep mode), the best snapshot of both with
    ``best_acc`` and ``best_ep``, each model's early-stopped flag
    (``stopped``), the epoch and step counters, the finished segments'
    history rows, and the permutation (CPU) and dropout (the device's)
    generators. ``arrays`` and ``load_arrays`` move it to and
    from numpy for a segment checkpoint. ``shard``: the fit's
    ``StackShard``; the carry then holds this rank's rows, and ``arrays``,
    ``template``, ``load_arrays`` and ``full_histories`` the whole
    stack's."""

    def __init__(self, params, opt, tidx, vidx, perm_gen, drop_gen, best, best_acc, best_ep,
                 buffers=None, shard=None):
        self.params, self.opt = params, opt
        self.shard = shard
        self.buffers = buffers or {}
        self.best_buffers = {k: b.detach().clone() for k, b in self.buffers.items()}
        self.tidx, self.vidx = tidx, vidx
        self.perm_gen, self.drop_gen = perm_gen, drop_gen
        self.best, self.best_acc, self.best_ep = best, best_acc, best_ep
        self.stopped = torch.zeros(best_acc.shape, dtype=torch.bool, device=best_acc.device)
        self.lr_rows = None  # sweep mode: each step's row learning rates, (steps, M)
        self.epoch = 0
        self.step = 0
        self.histories = []  # one dict of (M, epochs) numpy arrays a finished run() call
        self.timings = {"train_s": [], "val_s": []}  # this process's epochs

    def full(self, t):
        """The whole stack's rows of ``t`` (this rank's rows), gathered
        over the shard's stack axis; ``t`` itself without one."""
        return t if self.shard is None else self.shard.gather(t)

    def full_histories(self) -> list:
        """The finished ``run`` calls' history rows, of the whole stack."""
        return [{k: self.full(v) for k, v in h.items()} for h in self.histories]

    def arrays(self) -> dict:
        """The carry as a tree of numpy arrays, copied to the host now: a
        private copy, which later steps do not change (``.cpu()`` of a CPU
        tensor, AdamW's ``step`` among them, would share its memory). Of
        the whole stack: every rank of a shard must call it."""
        opt_state = [self.opt.state[p] for p in self.params.values()]
        if not all(opt_state):
            raise RuntimeError("the carry has no optimizer state before its first step")

        def host(t, rows=True):
            t = self.full(t.detach()) if rows else t.detach()
            return t.to("cpu", copy=True).numpy()

        names = list(self.params)
        return {
            "params": {n: host(p) for n, p in self.params.items()},
            "opt": {key: {n: host(st[key], key != "step") for n, st in zip(names, opt_state)}
                    for key in ("step", "exp_avg", "exp_avg_sq")},
            "best": {n: host(b) for n, b in self.best.items()},
            "buffers": {n: host(b) for n, b in self.buffers.items()},
            "best_buffers": {n: host(b) for n, b in self.best_buffers.items()},
            "best_acc": host(self.best_acc),
            "best_ep": host(self.best_ep),
            "stopped": host(self.stopped),
            "epoch": np.asarray(self.epoch, np.int64),
            "step": np.asarray(self.step, np.int64),
            "perm_rng": self.perm_gen.get_state().numpy(),
            "drop_rng": self.drop_gen.get_state().numpy(),
        }

    def template(self) -> dict:
        """The structure, shapes and dtypes of ``arrays()``, without a step."""
        m = self.best_acc.shape[0] if self.shard is None else self.shard.m_count

        def rows(t):
            return (m,) + tuple(t.shape[1:])

        zeros = {n: np.zeros(rows(p), np.float32) for n, p in self.params.items()}
        bufs = {n: np.zeros(rows(b), np.float32) for n, b in self.buffers.items()}
        return {
            "params": zeros, "opt": {"step": {n: np.zeros((), np.float32) for n in zeros},
                                     "exp_avg": zeros, "exp_avg_sq": zeros},
            "best": zeros, "buffers": bufs, "best_buffers": bufs,
            "best_acc": np.zeros(m, np.float32), "best_ep": np.zeros(m, np.int64),
            "stopped": np.zeros(m, bool), "epoch": np.asarray(0, np.int64),
            "step": np.asarray(0, np.int64), "perm_rng": self.perm_gen.get_state().numpy(),
            "drop_rng": self.drop_gen.get_state().numpy(),
        }

    def load_arrays(self, tree: dict) -> None:
        """Restore the carry in place from ``arrays()``'s tree (of the whole
        stack: a shard keeps its rows)."""
        if self.shard is not None:
            rows, opt = self.shard.rows_of, tree["opt"]
            whole = ("opt", "epoch", "step", "perm_rng", "drop_rng")
            tree = {k: v if k in whole else rows(v) for k, v in tree.items()}
            tree["opt"] = {"step": opt["step"],
                           **rows({k: v for k, v in opt.items() if k != "step"})}
        device = self.best_acc.device
        with torch.no_grad():
            for n, p in self.params.items():
                p.copy_(torch.from_numpy(tree["params"][n]))
                self.best[n] = torch.from_numpy(tree["best"][n]).to(device)
            for n, b in self.buffers.items():
                b.copy_(torch.from_numpy(tree["buffers"][n]))
                self.best_buffers[n] = torch.from_numpy(tree["best_buffers"][n]).to(device)
        sd = self.opt.state_dict()
        sd["state"] = {
            i: {"step": torch.tensor(tree["opt"]["step"][n]),
                "exp_avg": torch.from_numpy(tree["opt"]["exp_avg"][n]),
                "exp_avg_sq": torch.from_numpy(tree["opt"]["exp_avg_sq"][n])}
            for i, n in enumerate(self.params)
        }
        self.opt.load_state_dict(sd)
        self.best_acc = torch.from_numpy(tree["best_acc"]).to(device)
        self.best_ep = torch.from_numpy(tree["best_ep"]).to(device)
        self.stopped = torch.from_numpy(tree["stopped"]).to(device)
        self.epoch, self.step = int(tree["epoch"]), int(tree["step"])
        self.perm_gen.set_state(torch.from_numpy(tree["perm_rng"]))
        self.drop_gen.set_state(torch.from_numpy(tree["drop_rng"]))


def make_fit(
    model,
    n_classes: int,
    *,
    epochs: int,
    batch_size: int,
    n_train: int,
    n_val: int,
    learning_rate: float = 5e-4,
    warmup_epochs: int = 10,
    final_scale: float = 0.1,
    weight_decay: float = 0.01,
    val_every: int = 1,
    total_epochs: Optional[int] = None,
    sweep: bool = False,
    row_repeats: int = 1,
    augment=None,
    compute_dtype=None,
    early_stop_threshold: Optional[float] = None,
    early_stop_patience: Optional[int] = None,
    shard=None,
) -> Callable:
    """Build the fit of a stacked ``model`` (``FAST(cfg, n_models=M)`` with
    its initial parameters loaded). Returned signature::

        fit(train_idx (M, n_train), val_idx (M, n_val), X (N_total, C, T),
            Y (N_total,), *, seed, progress=None) -> FitResult

    trains ``model`` in place. Indices address the trial axis of the
    device-resident corpus ``X``/``Y``; ``seed`` seeds the permutations
    (CPU generator) and dropout (generator on ``X``'s device).
    ``progress(epoch, val_acc (M,))`` is called after each epoch.

    ``fit`` is ``fit.init_carry``, then ``fit.run`` to the budget, then
    ``fit.result``; ``fit_segmented`` calls these itself, one ``epochs``
    segment a ``run``, and checkpoints the carry between segments.

    ``total_epochs`` is the whole run's epoch budget when it is more than
    one call's ``epochs`` (JAX ``make_fit``): the learning-rate table
    spans it, and ``fit`` alone runs ``min(epochs, total_epochs)`` epochs.
    The JAX engine runs a last segment's epochs past the budget and
    discards their updates, because its scanned segments have fixed
    shapes; here they are not run, and the parameters, the best snapshot
    and the history (cut to the budget there) come out the same. This is
    how a ``val_every`` that does not divide the budget runs
    (``train.cv``).

    ``sweep=True`` makes the learning rate and weight decay per model row
    (JAX ``make_fit(sweep=True)``): ``fit`` and ``init_carry`` then take
    ``hyper={"lr_scale": (M,), "wd_scale": (M,)[, "lr_table": (M, steps)]}``
    and row m trains with ``RowAdamW`` at ``lr_t = lr_scale[m] *
    (lr_table[m, min(step, steps - 1)]`` or the built-in table's
    ``lr_t``) and ``weight_decay * wd_scale[m]``. ``row_repeats=R``: the
    stack is R repeats of its first ``M / R`` rows' randomness (see the
    module docstring). The defaults leave the plain path as it was:
    ``torch.optim.AdamW`` and one draw a row. ``augment=(noise_sigma,
    ch_drop)`` augments each train batch, and ``compute_dtype`` is the
    dtype every batch is cast to after that (see the module docstring).

    Early stopping, as JAX ``make_fit`` (``train/engine.py:320-366``): after
    a validation pass a model stops once its ``val_acc >=
    early_stop_threshold`` or once ``epoch - best_epoch >=
    early_stop_patience``. From the next epoch on its epochs still run and
    enter the history, but its parameters, buffers and AdamW moments end
    each one where it began, and its best snapshot no longer moves. The
    flag is sticky and rides in the carry (segments, ``--resume``); with
    ``val_every > 1`` it moves on validation epochs only.

    ``shard``: a ``parallel.mesh.StackShard`` when the stack runs on
    several ranks (see the module docstring). ``model`` is then this rank's
    ``shard.m_local`` rows of the stack; ``fit`` and ``init_carry`` take the
    whole stack's ``train_idx``, ``val_idx`` and ``hyper``, and every rank
    of the mesh must call them together."""
    if val_every < 1 or epochs % val_every != 0:
        raise ValueError(f"val_every must be >= 1 and divide epochs ({epochs}); got {val_every}")
    total = total_epochs or epochs
    spe = num_batches(n_train, batch_size)
    table = warmup_cosine_lr(learning_rate, total, spe, warmup_epochs, final_scale)
    eval_batch_size = eval_batch_size_for(n_val, batch_size)
    split = shard is not None and shard.split_batch
    if split:  # the batch-norm statistics of the whole batch (ops.norm)
        for mod in model.modules():
            if isinstance(mod, StackedBatchNorm):
                mod.sync_group = shard.data_group

    def init_carry(train_idx, val_idx, X, *, seed: int, hyper=None) -> FitCarry:
        device = X.device
        train_idx, val_idx = np.asarray(train_idx), np.asarray(val_idx)
        m_full = train_idx.shape[0]
        if shard is not None:
            if m_full != shard.m_count:
                raise ValueError(f"{m_full} index rows for a shard of {shard.m_count} models")
            train_idx, val_idx, hyper = shard.rows_of((train_idx, val_idx, hyper))
        tidx = torch.as_tensor(train_idx, dtype=torch.long, device=device)
        vidx = torch.as_tensor(val_idx, dtype=torch.long, device=device)
        m = tidx.shape[0]
        if m_full % row_repeats:
            raise ValueError(f"row_repeats={row_repeats} does not divide the {m_full} model rows")
        params = dict(model.named_parameters())
        best = {k: p.detach().clone() for k, p in params.items()}
        if sweep:
            opt, lr_rows = _sweep_optimizer(params, hyper, m, device)
        elif hyper is not None:
            raise ValueError("hyper is for a sweep-mode fit (make_fit(sweep=True))")
        else:
            opt, lr_rows = make_optimizer(params.values(), weight_decay), None
        if shard is None and row_repeats == 1:
            drop_gen = torch.Generator(device=device)
        else:
            stacked = shard is not None and shard.stacked
            drop_gen = SharedRowsGenerator(device,
                                           (shard.m_count, *shard.rows) if stacked else None)
            drop_gen.row_repeats = row_repeats
        carry = FitCarry(params, opt, tidx, vidx, torch.Generator().manual_seed(seed),
                         drop_gen.manual_seed(seed), best,
                         torch.full((m,), -float("inf"), device=device),
                         torch.full((m,), -1, dtype=torch.long, device=device),
                         buffers=model_buffers(model), shard=shard)
        carry.lr_rows = lr_rows
        return carry

    def _sweep_optimizer(params, hyper, m, device):
        """``RowAdamW`` at each row's weight decay, and each step's row
        learning rates as a ``(steps, M)`` f32 table on ``device``."""
        if hyper is None:
            raise ValueError("a sweep-mode fit needs hyper={'lr_scale', 'wd_scale'}")

        def rows(v):
            t = torch.as_tensor(np.asarray(v, np.float32), device=device)
            if t.shape[0] != m:
                raise ValueError(f"hyper has {t.shape[0]} rows for {m} models")
            return t

        lr_scale = rows(hyper["lr_scale"])
        base = (rows(hyper["lr_table"]).T if "lr_table" in hyper
                else torch.as_tensor(table, dtype=torch.float32, device=device)[:, None])
        wd = weight_decay * rows(hyper["wd_scale"])
        return RowAdamW(params.values(), torch.zeros(m, device=device), wd), \
            (base * lr_scale).contiguous()

    def lr_of(carry: FitCarry, step: int):
        if carry.lr_rows is None:
            return lr_at(table, step)
        return carry.lr_rows[min(step, carry.lr_rows.shape[0] - 1)]

    early_stop = early_stop_threshold is not None or early_stop_patience is not None

    def run(carry: FitCarry, X, Y, *, until: int, progress=None) -> FitCarry:
        """Train from ``carry.epoch`` to epoch ``min(until, total)``, in
        place, and append those epochs' history rows to the carry."""
        device = X.device
        m = carry.tidx.shape[0]
        nan = torch.full((m,), float("nan"), device=device)
        rows = {k: [] for k in HISTORY_KEYS}
        model.train()
        for ep in range(carry.epoch, min(until, total)):
            t0 = time.perf_counter()
            halted = carry.stopped.clone()
            frozen = _epoch_start(carry) if early_stop and bool(halted.any()) else None
            m_full = m if shard is None else shard.m_count
            perm = epoch_permutations(carry.perm_gen, m_full // row_repeats, n_train)
            if row_repeats > 1:
                perm = perm.repeat(row_repeats, 1)
            if shard is not None:
                perm = shard.rows_of(perm)
            gidx = torch.gather(carry.tidx, 1, perm.to(device))
            loss_sum = torch.zeros(m, device=device)
            cm = torch.zeros((m, n_classes, n_classes), device=device)
            for i in range(spe):
                bidx = gidx[:, i * batch_size : (i + 1) * batch_size]
                data = None
                if split:
                    b_full = bidx.shape[1]
                    c0, c1 = shard.batch_cols(b_full)
                    carry.drop_gen.set_batch((b_full, c0, c1))
                    bidx, data = bidx[:, c0:c1], (shard.data_group, b_full)
                ls, c = train_step(model, carry.opt, X[bidx], Y[bidx], lr_of(carry, carry.step),
                                   n_classes, carry.drop_gen, augment, compute_dtype, data)
                loss_sum += ls
                cm += c
                carry.step += 1
            if frozen is not None:
                _restore_rows(carry, frozen, halted)
            for k, v in zip(HISTORY_KEYS[:3], _epoch_metrics(loss_sum, cm)):
                rows[k].append(v)
            _sync(device)
            t1 = time.perf_counter()
            if (ep + 1) % val_every == 0:
                va = evaluate(model, X, Y, carry.vidx, eval_batch_size, n_classes, compute_dtype,
                              shard)
                improved = (va[1] > carry.best_acc) & ~halted
                with torch.no_grad():
                    for k, p in carry.params.items():
                        sel = improved.view(-1, *([1] * (p.dim() - 1)))
                        carry.best[k] = torch.where(sel, p.detach(), carry.best[k])
                    for k, b in carry.buffers.items():
                        sel = improved.view(-1, *([1] * (b.dim() - 1)))
                        carry.best_buffers[k] = torch.where(sel, b, carry.best_buffers[k])
                carry.best_acc = torch.where(improved, va[1], carry.best_acc)
                carry.best_ep = torch.where(improved, torch.full_like(carry.best_ep, ep),
                                            carry.best_ep)
                if early_stop_threshold is not None:
                    carry.stopped |= va[1] >= early_stop_threshold
                if early_stop_patience is not None:
                    carry.stopped |= ep - carry.best_ep >= early_stop_patience
            else:
                va = (nan, nan, nan)
            for k, v in zip(HISTORY_KEYS[3:], va):
                rows[k].append(v)
            _sync(device)
            carry.epoch = ep + 1
            carry.timings["train_s"].append(t1 - t0)
            carry.timings["val_s"].append(time.perf_counter() - t1)
            if progress is not None:
                progress(ep + 1, carry.full(va[1]))
        if rows["loss"]:
            carry.histories.append(
                {k: torch.stack(v, dim=1).cpu().numpy() for k, v in rows.items()})
        return carry

    def result(carry: FitCarry) -> FitResult:
        """The fit's result, of the whole stack (gathered from a shard's
        ranks, every one of which must call it)."""
        full = carry.full
        history = {k: np.concatenate([h[k] for h in carry.full_histories()], axis=1)
                   for k in HISTORY_KEYS}
        return FitResult(
            params={k: full(p.detach()).clone() for k, p in carry.params.items()},
            best_params={k: full(b) for k, b in carry.best.items()},
            best_val_acc=full(carry.best_acc).cpu().numpy(),
            best_epoch=full(carry.best_ep).cpu().numpy(),
            history=history,
            timings={**carry.timings, "steps_per_epoch": spe},
            model_state={k: full(b.detach()).clone() for k, b in carry.buffers.items()},
            best_model_state={k: full(b) for k, b in carry.best_buffers.items()},
        )

    def fit(train_idx, val_idx, X, Y, *, seed: int, progress=None, hyper=None) -> FitResult:
        carry = init_carry(train_idx, val_idx, X, seed=seed, hyper=hyper)
        return result(run(carry, X, Y, until=min(epochs, total), progress=progress))

    fit.init_carry, fit.run, fit.result = init_carry, run, result
    fit.lr_table = table
    fit.steps_per_epoch = spe
    fit.epochs_per_call = epochs
    fit.total_epochs = total
    return fit


def _epoch_start(carry: FitCarry):
    """Copies of the parameters, buffers and AdamW moments at an epoch's
    start, for ``_restore_rows``."""
    moments = [carry.opt.state[p] for p in carry.params.values()]
    with torch.no_grad():
        return ({k: p.detach().clone() for k, p in carry.params.items()},
                {k: b.clone() for k, b in carry.buffers.items()},
                {k: (st["exp_avg"].clone(), st["exp_avg_sq"].clone())
                 for k, st in zip(carry.params, moments)})


def _restore_rows(carry: FitCarry, frozen, rows: torch.Tensor) -> None:
    """Put the model rows ``rows`` (a ``(M,)`` mask) of the parameters,
    buffers and AdamW moments back to ``frozen`` (``_epoch_start``): an
    early-stopped model's epoch leaves it where it began.

    One stacked tensor holds every model's row, and the optimizer's
    ``step`` is one count a tensor, so freezing is this per-row restore of
    ``p``, ``exp_avg`` and ``exp_avg_sq``; the count keeps going for every
    row. It would matter to a row's bias correction only if the row
    resumed, and ``stopped`` is sticky: no row resumes."""
    params, buffers, moments = frozen

    def put(t, old):
        t.copy_(torch.where(rows.view(-1, *([1] * (t.dim() - 1))), old, t))

    with torch.no_grad():
        for k, p in carry.params.items():
            put(p, params[k])
            put(carry.opt.state[p]["exp_avg"], moments[k][0])
            put(carry.opt.state[p]["exp_avg_sq"], moments[k][1])
        for k, b in carry.buffers.items():
            put(b, buffers[k])


def fit_segmented(
    fit: Callable,
    train_idx,
    val_idx,
    X: torch.Tensor,
    Y: torch.Tensor,
    *,
    seed: int,
    progress=None,
    checkpoint_dir: Optional[str] = None,
    resume: bool = True,
    checkpoint_every: int = 1,
    hyper=None,
) -> FitResult:
    """The whole run of ``fit`` (``make_fit(epochs=<segment>,
    total_epochs=<budget>)``) in segments of ``fit.epochs_per_call``
    epochs: the counterpart of JAX ``fit_many_segmented``.

    ``checkpoint_dir``: the carry (parameters, AdamW state, best snapshot,
    counters, history, both generators' states) is written to
    ``<checkpoint_dir>/segment_carry.npz`` at segment boundaries, every
    ``checkpoint_every``-th one and always after the last; with
    ``resume`` a run restarts from that file's boundary and continues the
    same generator streams and learning-rate table, so it ends as the
    uninterrupted run does, bit for bit. ``hyper``: a sweep-mode fit's
    per-row hyperparameters (``make_fit(sweep=True)``), the same for every
    segment; a resumed sweep is given them again.

    Writes run on one background thread, so the next segment trains
    while the disk is written; the carry is copied to the host first, and
    the thread writes that private copy. A failed write re-raises as
    ``RuntimeError`` at the next boundary or at the end, and no segment
    runs after it.

    A fit on several ranks (``make_fit(shard=...)``): rank 0 writes the
    file that the unsharded run writes, from the carry gathered from every
    rank, and on ``resume`` each rank reads it and keeps its rows. Every
    rank waits for that write before the next segment (the write then
    overlaps no training), and if it failed, all raise there together."""
    import os
    import threading

    from . import checkpoint

    seg, total = fit.epochs_per_call, fit.total_epochs
    n_segments = -(-total // seg)
    carry = fit.init_carry(train_idx, val_idx, X, seed=seed, hyper=hyper)
    start_seg = 0
    path = os.path.join(checkpoint_dir, "segment_carry.npz") if checkpoint_dir else None
    if path and resume and os.path.exists(path):
        tree, histories, start_seg = checkpoint.load_segment_checkpoint(path, carry.template())
        carry.load_arrays(tree)
        carry.histories = (histories if carry.shard is None else
                           [carry.shard.rows_of(h) for h in histories])
    shard = carry.shard
    writes = shard is None or is_lead()

    writer: Optional[threading.Thread] = None
    writer_err: list = []
    carry.timings["checkpoint_write_s"] = []

    def save(tree, histories, next_segment):
        try:
            t0 = time.perf_counter()
            checkpoint.save_segment_checkpoint(path, tree, histories, next_segment)
            carry.timings["checkpoint_write_s"].append(time.perf_counter() - t0)
        except BaseException as e:  # noqa: BLE001 -- re-raised at join
            writer_err.append(e)

    def join_writer():
        if writer is not None:
            writer.join()
        failed = bool(writer_err)
        if shard is not None:  # rank 0's write: every rank stops with it
            failed = any_rank(failed, shard.mesh.group, shard.mesh.device)
        if failed:
            raise RuntimeError(f"segment-checkpoint write to {path} failed"
                               + ("" if writer_err else " on rank 0")) from (
                writer_err[0] if writer_err else None)

    try:
        for s in range(start_seg, n_segments):
            # no further segment after a failed write (on several ranks,
            # each waits for the last write to know)
            if writer_err or (path and shard is not None and s > start_seg):
                join_writer()
            fit.run(carry, X, Y, until=(s + 1) * seg, progress=progress)
            if path and ((s + 1) % max(checkpoint_every, 1) == 0 or s + 1 == n_segments):
                tree, histories = carry.arrays(), carry.full_histories()
                join_writer()
                carry.timings["checkpoint_bytes"] = sum(
                    a.nbytes for a in checkpoint._flatten(tree).values())
                if writes:
                    writer = threading.Thread(target=save, args=(tree, histories, s + 1),
                                              daemon=True)
                    writer.start()
        join_writer()
    finally:
        if writer is not None:
            writer.join()
    return fit.result(carry)
