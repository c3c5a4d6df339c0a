"""Hyperparameter search as one stacked fit.

Counterpart of ``imagined_speech_decoding_tpu/train/sweep.py``. The JAX
sweep ``jax.vmap``s a sweep-mode fit over a (config x fold) model axis
(``sweep_many``), its inits and keys tiled over the configs
(``_tile_models``). Here the same grid is one ``FAST(cfg, n_models=H*F)``
stack trained by ``engine.make_fit(sweep=True, row_repeats=H)``: row
``h*F + f`` is config h on fold f (config-major, as JAX lays it out), with
its own learning rate and weight decay (``engine.RowAdamW``). ``tile_rows``
tiles the F per-fold initial weights over the H configs, and
``row_repeats`` gives every config the same fold's permutations and
dropout masks, so a grid row differs from another of the same fold only
in its optimizer arithmetic, as in JAX.

Runtime-sweepable: the learning rate, the weight decay and the whole
learning-rate schedule (each row may carry its own per-step table, as the
warmup axis does). Batch size, epochs, dropout and the architecture are
fixed for one stack.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import FASTConfig
from ..devices import require_device
from ..models.fast import FAST
from ..transplant import from_jax_params
from . import cv
from .engine import FitResult, fit_segmented, make_fit
from .schedule import cosine_scheduler


def hyper_grid(
    lr_scales: Sequence[float],
    wd_scales: Sequence[float],
    warmup_epochs_list: Optional[Sequence[int]] = None,
    *,
    lr_tables: Optional[np.ndarray] = None,
) -> Tuple[Dict[str, np.ndarray], List[Tuple]]:
    """The cross product of the runtime hyperparameters, as JAX
    ``hyper_grid``: ``({'lr_scale': (H,), 'wd_scale': (H,)}, meta)`` with
    ``meta[h] = (lr_scale, wd_scale)`` in lr-outer order; with
    ``warmup_epochs_list`` a third, innermost warmup axis, ``meta[h] =
    (lr_scale, wd_scale, warmup_epochs)`` and ``hyper['lr_table']`` each
    row's absolute per-step table (``lr_tables[w_index]``). f32 numpy."""
    if warmup_epochs_list is None:
        meta = [(float(a), float(b)) for a in lr_scales for b in wd_scales]
        return {
            "lr_scale": np.asarray([m[0] for m in meta], np.float32),
            "wd_scale": np.asarray([m[1] for m in meta], np.float32),
        }, meta
    if lr_tables is None or len(lr_tables) != len(warmup_epochs_list):
        raise ValueError("warmup sweep needs one lr_table row per warmup value")
    meta = [(float(a), float(b), int(w))
            for a in lr_scales for b in wd_scales for w in warmup_epochs_list]
    w_index = {int(w): i for i, w in enumerate(warmup_epochs_list)}
    return {
        "lr_scale": np.asarray([m[0] for m in meta], np.float32),
        "wd_scale": np.asarray([m[1] for m in meta], np.float32),
        "lr_table": np.asarray(np.stack([lr_tables[w_index[m[2]]] for m in meta]), np.float32),
    }, meta


def tile_rows(tree, reps: int):
    """Repeat a stacked tree's model axis ``reps`` times, config axis outer
    (row ``h * F + f`` is config h, fold f): JAX ``_tile_models``."""
    if isinstance(tree, dict):
        return {k: tile_rows(v, reps) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tile_rows(v, reps) for v in tree]
    return np.tile(tree, (reps,) + (1,) * (np.ndim(tree) - 1))


@dataclass
class SweepReport:
    """Result of ``cv_sweep`` over an (lr x wd [x warmup]) grid with F folds."""

    lr: np.ndarray  # (H,) absolute learning rates
    wd: np.ndarray  # (H,) absolute weight decays
    fold_val_acc: np.ndarray  # (H, F) best val acc per fold
    mean_val_acc: np.ndarray  # (H,)
    std_val_acc: np.ndarray  # (H,)
    best_index: int  # argmax of mean_val_acc
    history: Dict[str, np.ndarray]  # each (H, F, E)
    meta: List[Tuple]  # (lr_scale, wd_scale[, warmup_epochs]) per row
    warmup: Optional[np.ndarray] = None  # (H,) warmup epochs, if swept
    fit: Optional[FitResult] = None  # the stacked fit, rows config-major (the port's addition)

    @property
    def best(self) -> Dict[str, float]:
        h = self.best_index
        out = {
            "learning_rate": float(self.lr[h]),
            "weight_decay": float(self.wd[h]),
            "mean_val_acc": float(self.mean_val_acc[h]),
            "std_val_acc": float(self.std_val_acc[h]),
        }
        if self.warmup is not None:
            out["warmup_epochs"] = int(self.warmup[h])
        return out

    def rows(self) -> List[Dict[str, float]]:
        """Flat per-config records, in ``sweep_results.csv``'s column order."""
        out = []
        for h in range(len(self.lr)):
            row = {
                "learning_rate": float(self.lr[h]),
                "weight_decay": float(self.wd[h]),
                "mean_val_acc": float(self.mean_val_acc[h]),
                "std_val_acc": float(self.std_val_acc[h]),
            }
            if self.warmup is not None:
                row["warmup_epochs"] = int(self.warmup[h])
            for f in range(self.fold_val_acc.shape[1]):
                row[f"fold{f}_val_acc"] = float(self.fold_val_acc[h, f])
            out.append(row)
        return out


def cv_sweep(
    cfg: FASTConfig,
    n_classes: int,
    X,
    Y,
    *,
    n_trials: int,
    lr_scales: Sequence[float],
    wd_scales: Sequence[float] = (1.0,),
    n_folds: int = 5,
    epochs: int = 30,
    batch_size: int = 64,
    base_learning_rate: float = 5e-4,
    base_weight_decay: float = 0.01,
    warmup_epochs: int = 10,
    warmup_epochs_list: Optional[Sequence[int]] = None,
    final_lr_scale: float = 0.1,
    seed: int = 42,
    data_dtype: Optional[torch.dtype] = None,
    segment_epochs: Optional[int] = None,
    device="cuda",
) -> SweepReport:
    """K-fold CV over an (lr x wd [x warmup]) grid as one stacked fit of
    H x F models (JAX ``cv_sweep``).

    ``X (n_trials, C, T)`` / ``Y (n_trials,)`` is one subject's corpus
    (numpy or tensors); it goes to ``device`` in ``data_dtype`` (f32 when
    None), which is the compute dtype, as in ``train.cv``. Folds are
    ``cv.build_cv_index_stack(1, n_trials, n_folds, seed)``'s; the F
    per-fold initial weights are ``cv.stacked_init(cfg, seed, F)``, tiled
    over the configs; the fit's streams are seeded with ``seed + 1``.
    Absolute hyperparameters are ``base_* x scale``; ``warmup_epochs_list``
    sweeps the warmup length through per-row learning-rate tables from
    ``schedule.cosine_scheduler``. ``segment_epochs`` runs the fit through
    ``engine.fit_segmented`` in segments of that many epochs (the same
    trajectory). Runs on ``device``: CUDA unless the caller names another,
    and CUDA without a card raises."""
    if cfg.head != "Conv4Layers":
        raise NotImplementedError(
            f"the hyperparameter sweep of the {cfg.head} head (batch-norm state) is not ported yet "
            "(see ROADMAP.md, Queue 1)")
    device = require_device(device)
    tr, va, _ = cv.build_cv_index_stack(1, n_trials, n_folds, seed)
    n_train, n_val = tr.shape[1], va.shape[1]
    if warmup_epochs_list is None:
        hyper1, meta = hyper_grid(lr_scales, wd_scales)
        warmups = None
    else:
        spe = -(-n_train // batch_size)
        tables = np.stack([
            base_learning_rate * cosine_scheduler(1.0, final_lr_scale, epochs, spe, warmup_epochs=w)
            for w in warmup_epochs_list
        ])
        hyper1, meta = hyper_grid(lr_scales, wd_scales, warmup_epochs_list, lr_tables=tables)
        warmups = np.asarray([m[2] for m in meta])
    h_count, f_count = len(meta), n_folds

    # One init and one permutation / dropout stream per FOLD, shared by the configs.
    params0 = tile_rows(cv.stacked_init(cfg, seed, f_count), h_count)
    hyper = {k: np.repeat(v, f_count, axis=0) for k, v in hyper1.items()}
    tidx, vidx = np.tile(tr, (h_count, 1)), np.tile(va, (h_count, 1))
    model = FAST(cfg, n_models=h_count * f_count, device=device)
    model.load_state_dict(from_jax_params(params0))
    x = torch.as_tensor(X, dtype=data_dtype or torch.float32, device=device)
    y = torch.as_tensor(Y, dtype=torch.long, device=device)
    fit = make_fit(
        model, n_classes, epochs=segment_epochs or epochs, batch_size=batch_size,
        n_train=n_train, n_val=n_val, learning_rate=base_learning_rate,
        warmup_epochs=warmup_epochs, final_scale=final_lr_scale,
        weight_decay=base_weight_decay, total_epochs=epochs if segment_epochs else None,
        sweep=True, row_repeats=h_count,
    )
    if segment_epochs:
        res = fit_segmented(fit, tidx, vidx, x, y, seed=seed + 1, hyper=hyper)
    else:
        res = fit(tidx, vidx, x, y, seed=seed + 1, hyper=hyper)

    acc = np.asarray(res.best_val_acc, np.float64).reshape(h_count, f_count)
    history = {k: np.asarray(v, np.float32).reshape(h_count, f_count, -1)
               for k, v in res.history.items()}
    mean = acc.mean(1)
    return SweepReport(
        lr=np.asarray([base_learning_rate * m[0] for m in meta]),
        wd=np.asarray([base_weight_decay * m[1] for m in meta]),
        fold_val_acc=acc,
        mean_val_acc=mean,
        std_val_acc=acc.std(1),
        best_index=int(np.argmax(mean)),
        history=history,
        meta=meta,
        warmup=warmups,
        fit=res,
    )
