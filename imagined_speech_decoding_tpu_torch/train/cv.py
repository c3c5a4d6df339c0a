"""Per-subject K-fold cross-validation over a stack of models.

Counterpart of ``imagined_speech_decoding_tpu/train/cv.py``: every
(subject, fold) pair is one model of a ``FAST(cfg, n_models=S*K)`` stack,
and all of them train together (``engine.make_fit``). Then, per subject,
the fold with the best validation accuracy is selected (ties to the
lowest fold), its best snapshot is saved as ``best_subject.npz`` with the
JAX package's ``.npz`` key rules (so ``isd-serve`` of either package
loads it), evaluated on the test split, and the result tree is written
(``train.artifacts``).

Not ported (ROADMAP.md): ``_train_grouped`` (subject groups), the device
mesh strategies, segmented checkpoints and resume, and the plots.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import FASTConfig, TrainConfig
from ..devices import require_device
from ..models.fast import FAST
from ..transplant import from_jax_params, init_jax_layout_params, to_jax_params
from . import artifacts
from .checkpoint import save_model_npz, select_model
from .engine import FitResult, make_fit, predict
from .metrics import confusion_matrix, f1_from_confusion


def kfold_indices(n: int, n_folds: int, seed: int,
                  shuffle: bool = True) -> List[Tuple[np.ndarray, np.ndarray]]:
    """sklearn ``KFold(n_folds, shuffle, random_state=seed)`` splits of
    ``range(n)``, restated: ``RandomState(seed)`` shuffles the indices, the
    first ``n % n_folds`` folds get one more, and both index sets come out
    ascending (sklearn selects them through a boolean mask)."""
    if not 2 <= n_folds <= n:
        raise ValueError(f"need 2 <= n_folds <= n, got n_folds={n_folds}, n={n}")
    order = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    sizes = np.full(n_folds, n // n_folds, dtype=int)
    sizes[: n % n_folds] += 1
    splits, start = [], 0
    for size in sizes:
        test = np.zeros(n, dtype=bool)
        test[order[start : start + size]] = True
        splits.append((np.flatnonzero(~test), np.flatnonzero(test)))
        start += size
    return splits


def build_cv_index_stack(n_subjects: int, n_trials: int, n_folds: int, seed: int,
                         shuffle: bool = True):
    """Global ``(train_idx (M, n_train), val_idx (M, n_val), meta)`` for the
    (subject x fold) stack, ``M = n_subjects * n_folds``, ``meta[m] =
    (subject, fold)``; indices address the flattened ``S * n_trials`` axis.
    Folds must be uniform (``n_trials % n_folds == 0``; 350 = 5 x 70)."""
    if n_trials % n_folds != 0:
        raise ValueError(
            f"n_trials={n_trials} not divisible by n_folds={n_folds}; "
            "ragged folds are not supported by the stacked engine"
        )
    train_rows, val_rows, meta = [], [], []
    folds = kfold_indices(n_trials, n_folds, seed, shuffle)
    for s in range(n_subjects):
        for k, (tr, va) in enumerate(folds):
            train_rows.append(s * n_trials + tr)
            val_rows.append(s * n_trials + va)
            meta.append((s, k))
    return np.stack(train_rows), np.stack(val_rows), meta


def stacked_init(cfg: FASTConfig, seed: int, n_models: int) -> dict:
    """Initial weights of ``n_models`` independent models, stacked on a
    leading axis in the JAX layout, from a numpy seed (the JAX package
    draws them from ``jax.random``, which torch cannot reproduce)."""
    return init_jax_layout_params(cfg, seed, n_models)


@dataclass
class CVRunResult:
    summary: List[Dict[str, object]]  # Subject, Best_Val_Acc, Test_Acc, Test_F1 per subject
    fit: FitResult  # stacked over (S*K) models
    meta: List[Tuple[int, int]]
    best_fold_per_subject: Dict[str, int]
    timings: Dict[str, object] = field(default_factory=dict)


SUMMARY_COLUMNS = ("Subject", "Best_Val_Acc", "Test_Acc", "Test_F1")


def train_per_subject_cv(
    cfg: FASTConfig,
    tc: TrainConfig,
    X: np.ndarray,  # (S, N, C, T) train+val pool per subject
    Y: np.ndarray,  # (S, N)
    subjects: Sequence[str],
    n_classes: int,
    test_per_subject: Optional[Dict[str, Tuple[np.ndarray, np.ndarray]]] = None,
    save_dir: Optional[str] = None,
    warm_start: Optional[dict] = None,  # JAX-layout params stacked over S*K
    device="cuda",
    verbose: bool = True,
    model_seed: Optional[int] = None,
) -> CVRunResult:
    """Train S*K models at once, select the best fold per subject,
    evaluate it on the test split and write the result tree under
    ``save_dir``. Folds come from ``tc.seed``; the initial weights and the
    fit's permutations and dropout from ``model_seed`` (default
    ``tc.seed``), as in the JAX function. Runs on ``device``: CUDA unless
    the caller names another, and CUDA without a card raises."""
    device = require_device(device)
    s_count, n_trials = X.shape[:2]
    assert s_count == len(subjects)
    k = tc.n_folds
    m_count = s_count * k
    m_seed = tc.seed if model_seed is None else model_seed

    x_flat = torch.as_tensor(X.reshape((-1,) + X.shape[2:]), dtype=tc.compute_dtype, device=device)
    y_flat = torch.as_tensor(Y.reshape(-1).astype(np.int64), device=device)
    train_idx, val_idx, meta = build_cv_index_stack(s_count, n_trials, k, tc.seed,
                                                    tc.shuffle_folds)
    params0 = warm_start if warm_start is not None else stacked_init(cfg, m_seed, m_count)
    model = FAST(cfg, n_models=m_count, device=device)
    model.load_state_dict(from_jax_params(params0))

    # A val_every that does not divide the budget runs whole blocks of
    # val_every epochs, of which make_fit runs those within the budget (the
    # JAX package's train_per_subject_cv rounds its segments the same way).
    val_every = tc.val_every or 1
    fit = make_fit(
        model, n_classes, epochs=-(-tc.max_epochs // val_every) * val_every,
        batch_size=tc.batch_size, n_train=train_idx.shape[1], n_val=val_idx.shape[1],
        learning_rate=tc.learning_rate, warmup_epochs=tc.warmup_epochs,
        final_scale=tc.final_lr_scale, weight_decay=tc.weight_decay,
        val_every=val_every, total_epochs=tc.max_epochs,
    )

    def progress(done, val_acc):
        if verbose and not torch.isnan(val_acc).all():
            print(f"  epoch {done}/{tc.max_epochs}: mean val_acc "
                  f"{float(val_acc.mean()):.4f}", flush=True)

    t_fit0 = time.perf_counter()
    res = fit(train_idx, val_idx, x_flat, y_flat, seed=m_seed + 1, progress=progress)
    t_fit = time.perf_counter() - t_fit0

    t_art0 = time.perf_counter()
    best_val = res.best_val_acc
    best_tree = to_jax_params(res.best_params)
    single = FAST(cfg, device=device)
    summary, global_pred, global_true = [], [], []
    best_fold_per_subject: Dict[str, int] = {}
    for si, sid in enumerate(subjects):
        fold_ms = [si * k + ki for ki in range(k)]
        fold_accs = best_val[fold_ms]
        best_k = int(np.argmax(fold_accs))  # ties -> lowest fold
        best_m = fold_ms[best_k]
        best_fold_per_subject[sid] = best_k
        sub_dir = os.path.join(save_dir, f"sub-{sid}") if save_dir else None
        if sub_dir:
            for ki, mi in enumerate(fold_ms):
                h = {name: res.history[name][mi] for name in ("loss", "acc", "val_loss", "val_acc")}
                artifacts.save_history_csv(os.path.join(sub_dir, f"fold-{ki}_history.csv"), h)
            artifacts.write_csv(os.path.join(sub_dir, "fold_metrics.csv"),
                                ["Fold", "Best_Val_Acc"], list(enumerate(fold_accs)))

        best_params = select_model(best_tree, best_m)
        if sub_dir:
            save_model_npz(os.path.join(sub_dir, "best_subject.npz"), best_params, {"head": {}})

        test_acc, test_f1 = np.nan, np.nan
        if test_per_subject and sid in test_per_subject:
            x_test, y_test = test_per_subject[sid]
            single.load_state_dict(from_jax_params(best_params))
            y_pred = predict(single, torch.as_tensor(x_test, dtype=tc.compute_dtype, device=device),
                             tc.batch_size)
            y_true = y_test.astype(int)
            cm = confusion_matrix(torch.as_tensor(y_pred), torch.as_tensor(y_true), n_classes)
            test_acc = float(np.trace(cm.numpy()) / max(len(y_true), 1))
            test_f1 = float(f1_from_confusion(cm))
            global_pred.append(y_pred)
            global_true.append(y_true)
            if sub_dir:
                artifacts.save_predictions_csv(os.path.join(sub_dir, "test_predictions.csv"),
                                               y_pred, y_true)
        if verbose:
            print(f"Subject {sid}: best fold {best_k + 1} val_acc={fold_accs[best_k]:.4f}"
                  + (f" | test acc={test_acc:.4f} f1={test_f1:.4f}"
                     if not np.isnan(test_acc) else ""), flush=True)
        summary.append(dict(zip(SUMMARY_COLUMNS,
                                (sid, float(fold_accs[best_k]), test_acc, test_f1))))

    t_art = time.perf_counter() - t_art0
    if verbose:
        print(f"  phases: fit {t_fit:.1f}s | per-subject artifacts+eval {t_art:.1f}s", flush=True)
    if save_dir:
        artifacts.write_csv(os.path.join(save_dir, "summary_per_subject.csv"), SUMMARY_COLUMNS,
                            [[row[c] for c in SUMMARY_COLUMNS] for row in summary])
        if global_pred:
            artifacts.save_predictions_csv(
                os.path.join(save_dir, "global_test_predictions.csv"),
                np.concatenate(global_pred), np.concatenate(global_true),
            )
    return CVRunResult(summary=summary, fit=res, meta=meta,
                       best_fold_per_subject=best_fold_per_subject,
                       timings={"fit_s": t_fit, "artifacts_s": t_art, **res.timings})
