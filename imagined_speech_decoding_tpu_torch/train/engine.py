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
``val_acc``, per model. Sweep mode, early stopping and segmented
execution (checkpoints and resume) are not ported (ROADMAP.md).

Randomness: epoch permutations come from a CPU ``torch.Generator``
(``data.arrays.epoch_permutations``), so a seed gives the same batches on
any device; dropout draws from a generator on the training device.
Neither reproduces the JAX package's ``jax.random`` streams.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..data.arrays import epoch_permutations, num_batches
from .metrics import confusion_matrix, cross_entropy, f1_from_confusion
from .schedule import lr_at, warmup_cosine_lr

HISTORY_KEYS = ("loss", "acc", "f1", "val_loss", "val_acc", "val_f1")


class FitResult(NamedTuple):
    params: Dict[str, torch.Tensor]  # final parameters, stacked (M, ...)
    best_params: Dict[str, torch.Tensor]  # snapshot at each model's best val_acc
    best_val_acc: np.ndarray  # (M,)
    best_epoch: np.ndarray  # (M,), -1 if no validation epoch ran
    history: Dict[str, np.ndarray]  # each (M, E)
    timings: Dict[str, object]  # host seconds: per-epoch train and validation passes


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


def train_step(model, opt: torch.optim.Optimizer, x: torch.Tensor, y: torch.Tensor, lr: float,
               n_classes: int, generator: Optional[torch.Generator] = None):
    """One optimizer step of every model on its batch ``x (M, b, C, T)``,
    ``y (M, b)``. Returns ``(loss * b (M,), confusion (M, K, K))``, the
    sums the epoch metrics are made of."""
    for group in opt.param_groups:
        group["lr"] = lr
    logits = model(x, generator=generator)
    loss = cross_entropy(logits, y)
    opt.zero_grad(set_to_none=True)
    loss.sum().backward()  # models are independent: each gets its own loss's gradient
    opt.step()
    logits = logits.detach()
    return loss.detach() * y.shape[-1], confusion_matrix(logits, y, n_classes)


def _epoch_metrics(loss_sum: torch.Tensor, cm: torch.Tensor):
    total = cm.sum(dim=(-2, -1)).clamp_min(1.0)
    acc = torch.diagonal(cm, dim1=-2, dim2=-1).sum(-1) / total
    return loss_sum / total, acc, f1_from_confusion(cm)


def evaluate(model, X: torch.Tensor, Y: torch.Tensor, idx: torch.Tensor, batch_size: int,
             n_classes: int):
    """``(loss, acc, f1)``, each ``(M,)``, of every model on its trials
    ``idx (M, n)`` in sequential batches of ``batch_size``."""
    was_training = model.training
    model.eval()
    m = idx.shape[0]
    loss_sum = torch.zeros(m, device=X.device)
    cm = torch.zeros((m, n_classes, n_classes), device=X.device)
    with torch.no_grad():
        for s in range(0, idx.shape[1], batch_size):
            bidx = idx[:, s : s + batch_size]
            y = Y[bidx]
            logits = model(X[bidx])
            loss_sum += cross_entropy(logits, y) * bidx.shape[1]
            cm += confusion_matrix(logits, y, n_classes)
    model.train(was_training)
    return _epoch_metrics(loss_sum, cm)


def predict(model, x: torch.Tensor, batch_size: int = 64) -> np.ndarray:
    """Argmax predictions over the trials of ``x`` (``(N, C, T)`` for one
    model), in sequential batches (``engine.predict``)."""
    model.eval()
    with torch.no_grad():
        preds = [model(x[s : s + batch_size]).argmax(dim=-1).cpu()
                 for s in range(0, x.shape[0], batch_size)]
    return torch.cat(preds).numpy()


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
) -> Callable:
    """Build the fit of a stacked ``model`` (``FAST(cfg, n_models=M)`` with
    its initial parameters loaded). Returned signature::

        fit(train_idx (M, n_train), val_idx (M, n_val), X (N_total, C, T),
            Y (N_total,), *, seed, progress=None) -> FitResult

    trains ``model`` in place. Indices address the trial axis of the
    device-resident corpus ``X``/``Y``; ``seed`` seeds the permutations
    (CPU generator) and dropout (generator on ``X``'s device).
    ``progress(epoch, val_acc (M,))`` is called after each epoch.

    ``total_epochs`` is the epoch budget when it is less than ``epochs``
    (JAX ``make_fit``): the learning-rate table spans the budget and only
    the budget's epochs run. The JAX engine runs the epochs past it and
    discards their updates, because its scanned segments have fixed
    shapes; the parameters, the best snapshot and the history (cut to the
    budget there) come out the same. This is how a ``val_every`` that does
    not divide the budget runs (``train.cv``)."""
    if val_every < 1 or epochs % val_every != 0:
        raise ValueError(f"val_every must be >= 1 and divide epochs ({epochs}); got {val_every}")
    budget = min(epochs, total_epochs or epochs)
    spe = num_batches(n_train, batch_size)
    table = warmup_cosine_lr(learning_rate, total_epochs or epochs, spe, warmup_epochs,
                             final_scale)
    eval_batch_size = eval_batch_size_for(n_val, batch_size)

    def fit(train_idx, val_idx, X, Y, *, seed: int, progress=None) -> FitResult:
        device = X.device
        tidx = torch.as_tensor(np.asarray(train_idx), dtype=torch.long, device=device)
        vidx = torch.as_tensor(np.asarray(val_idx), dtype=torch.long, device=device)
        m = tidx.shape[0]
        perm_gen = torch.Generator().manual_seed(seed)
        drop_gen = torch.Generator(device=device).manual_seed(seed)
        opt = make_optimizer(model.parameters(), weight_decay)
        params = dict(model.named_parameters())
        best = {k: p.detach().clone() for k, p in params.items()}
        best_acc = torch.full((m,), -float("inf"), device=device)
        best_ep = torch.full((m,), -1, dtype=torch.long, device=device)
        nan = torch.full((m,), float("nan"), device=device)
        rows = {k: [] for k in HISTORY_KEYS}
        train_s, val_s = [], []
        step = 0
        model.train()
        for ep in range(budget):
            t0 = time.perf_counter()
            gidx = torch.gather(tidx, 1, epoch_permutations(perm_gen, m, n_train).to(device))
            loss_sum = torch.zeros(m, device=device)
            cm = torch.zeros((m, n_classes, n_classes), device=device)
            for i in range(spe):
                bidx = gidx[:, i * batch_size : (i + 1) * batch_size]
                ls, c = train_step(model, opt, X[bidx], Y[bidx], lr_at(table, step), n_classes,
                                   drop_gen)
                loss_sum += ls
                cm += c
                step += 1
            for k, v in zip(HISTORY_KEYS[:3], _epoch_metrics(loss_sum, cm)):
                rows[k].append(v)
            _sync(device)
            t1 = time.perf_counter()
            if (ep + 1) % val_every == 0:
                va = evaluate(model, X, Y, vidx, eval_batch_size, n_classes)
                improved = va[1] > best_acc
                with torch.no_grad():
                    for k, p in params.items():
                        sel = improved.view(-1, *([1] * (p.dim() - 1)))
                        best[k] = torch.where(sel, p.detach(), best[k])
                best_acc = torch.where(improved, va[1], best_acc)
                best_ep = torch.where(improved, torch.full_like(best_ep, ep), best_ep)
            else:
                va = (nan, nan, nan)
            for k, v in zip(HISTORY_KEYS[3:], va):
                rows[k].append(v)
            _sync(device)
            train_s.append(t1 - t0)
            val_s.append(time.perf_counter() - t1)
            if progress is not None:
                progress(ep + 1, va[1])
        history = {k: torch.stack(v, dim=1).cpu().numpy() for k, v in rows.items()}
        return FitResult(
            params={k: p.detach().clone() for k, p in params.items()},
            best_params=best,
            best_val_acc=best_acc.cpu().numpy(),
            best_epoch=best_ep.cpu().numpy(),
            history=history,
            timings={"train_s": train_s, "val_s": val_s, "steps_per_epoch": spe},
        )

    fit.lr_table = table
    fit.steps_per_epoch = spe
    return fit
