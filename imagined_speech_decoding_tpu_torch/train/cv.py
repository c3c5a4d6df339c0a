"""Per-subject K-fold cross-validation over a stack of models.

Counterpart of ``imagined_speech_decoding_tpu/train/cv.py``: every
(subject, fold) pair is one model of a stack of S*K (``FAST(cfg,
n_models=S*K)``, or any ``models.api.ModelDef``'s module), and all of
them train together (``engine.make_fit``). Then, per subject, the fold
with the best validation accuracy is selected (ties to the lowest fold),
its best snapshot (parameters and model state, the batch-norm running
statistics) is saved as ``best_subject.npz`` with the JAX package's
``.npz`` key rules (so either package loads it), evaluated on the test
split with that state, and the result tree is written
(``train.artifacts``).

The fit runs in segments of ``epochs_per_segment`` epochs
(``engine.fit_segmented``), with the carry checkpointed at segment
boundaries under ``checkpoint_dir`` and a run resumed from the newest
one, as the JAX function runs.

``subject_group_size`` trains the subjects in sequential groups
(``_train_grouped``), each group's stack starting from the weights the
ungrouped run would give its models.

``mesh_axis`` runs the stack on the run's ranks (``parallel.mesh``):
'model' splits the stack over them, 'data' every model's batch, '2d'
both; each gives the unsharded result. Rank 0 alone writes the result
tree and prints. Not drawn: the JAX function's learning curves and
accuracy bar.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import TrainConfig
from ..devices import require_device
from ..models.api import ModelDef, make_fast_model
from ..parallel.mesh import StackShard, fail_together, is_lead, mesh_strategy
from . import artifacts
from .checkpoint import save_model_npz, select_model
from .engine import FitResult, fit_segmented, make_fit, predict
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


def _segment_length(total_epochs: int, preferred: int) -> int:
    """Segment length for ``fit_segmented``: the largest divisor of
    ``total_epochs`` that is at most ``preferred``, so that no segment runs
    past the budget; ``preferred`` itself when that divisor is below half
    of it (JAX ``train.cv._segment_length``)."""
    total = max(int(total_epochs), 1)
    preferred = max(min(preferred, total), 1)
    best = max((d for d in range(1, preferred + 1) if total % d == 0), default=1)
    return best if best >= max(preferred // 2, 1) else preferred


def stacked_init(model, seed: int, n_models: int, *, total: Optional[int] = None,
                 offset: int = 0):
    """``(params, state)``: the initial weights and model state (the
    batch-norm running statistics; ``{"head": {}}`` for Conv4Layers) of
    ``n_models`` independent models, stacked on a leading axis in the JAX
    layout, from a numpy seed (the JAX package draws them from
    ``jax.random``, which torch cannot reproduce). ``model``: a
    ``FASTConfig`` or a ``models.api.ModelDef``; ``total`` / ``offset``: the
    block of models ``offset ..`` of a ``total``-model draw (JAX
    ``stacked_init``)."""
    mdef = model if isinstance(model, ModelDef) else make_fast_model(model)
    return mdef.init(seed, n_models, total=total, offset=offset)


@dataclass
class CVRunResult:
    summary: List[Dict[str, object]]  # Subject, Best_Val_Acc, Test_Acc, Test_F1 per subject
    fit: FitResult  # stacked over (S*K) models
    meta: List[Tuple[int, int]]
    best_fold_per_subject: Dict[str, int]
    timings: Dict[str, object] = field(default_factory=dict)


SUMMARY_COLUMNS = ("Subject", "Best_Val_Acc", "Test_Acc", "Test_F1")


def _slice_models(tree, start: int, stop: int):
    """Models ``start:stop`` of a stacked JAX-layout tree (a subject
    group's block of a warm start)."""
    if hasattr(tree, "_fields"):
        return type(tree)(*(_slice_models(v, start, stop) for v in tree))
    if isinstance(tree, dict):
        return {k: _slice_models(v, start, stop) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_slice_models(v, start, stop) for v in tree)
    return tree[start:stop]


def train_per_subject_cv(
    model,
    tc: TrainConfig,
    X: np.ndarray,  # (S, N, C, T) train+val pool per subject
    Y: np.ndarray,  # (S, N)
    subjects: Sequence[str],
    n_classes: int,
    test_per_subject: Optional[Dict[str, Tuple[np.ndarray, np.ndarray]]] = None,
    save_dir: Optional[str] = None,
    warm_start=None,  # JAX-layout params, or (params, state), stacked over S*K
    epochs_per_segment: int = 25,
    device="cuda",
    verbose: bool = True,
    checkpoint_dir: Optional[str] = None,
    resume: bool = True,
    checkpoint_every: int = 1,
    model_seed: Optional[int] = None,
    subject_group_size: Optional[int] = None,
    mesh_axis: Optional[str] = None,
    _key_block: Optional[Tuple[int, int]] = None,
) -> CVRunResult:
    """Train S*K models at once, select the best fold per subject,
    evaluate it on the test split and write the result tree under
    ``save_dir``. ``model`` is a ``FASTConfig`` (FAST with its head) or a
    ``models.api.ModelDef`` (its module stacked for the fit and single for
    the test split, its initial ``(params, state)``). Folds come from
    ``tc.seed``; the initial weights and the fit's permutations, dropout
    and augmentation from ``model_seed`` (default ``tc.seed``), as in the
    JAX function. Runs on ``device``: CUDA unless the caller names
    another, and CUDA without a card raises.

    The fit runs in segments of ``_segment_length(tc.max_epochs,
    epochs_per_segment)`` epochs, rounded down to whole ``val_every``
    blocks (at least one); ``checkpoint_dir``, ``resume`` and
    ``checkpoint_every`` go to ``engine.fit_segmented``.

    ``subject_group_size``: train the subjects in sequential groups of at
    most this many (``_train_grouped``), each group's S_g*K models at
    once: the memory lever for models whose activations do not fit a
    whole stack. A group's models start from the weights of the same
    models of the ungrouped run (``_key_block = (offset, total)``); its
    permutations, dropout and augmentation come from its own generators,
    seeded ``model_seed + 1 + offset``.

    ``mesh_axis`` ('model', 'data' or '2d'; JAX's mesh strategies): the
    stack trains on the ranks of the run (``parallel.mesh.init_world``:
    ``torchrun``'s, or this process alone), every rank calling this with
    the same arguments; the fit's result is the whole stack's on every
    rank, and only rank 0 writes files and prints. A rank that an odd
    count leaves out of a '2d' grid trains nothing and returns None."""
    device = require_device(device)
    mesh = stack_axis = data_axis = None
    if mesh_axis:
        mesh, stack_axis, data_axis = mesh_strategy(mesh_axis, device)
        if not mesh.member:
            return None
        device = mesh.device
        if not is_lead():
            save_dir, verbose = None, False
    s_count = X.shape[0]
    if subject_group_size and s_count > subject_group_size:
        return _train_grouped(
            model, tc, X, Y, subjects, n_classes, test_per_subject, save_dir, warm_start,
            epochs_per_segment, device, verbose, checkpoint_dir, resume, checkpoint_every,
            model_seed, subject_group_size, mesh_axis)
    mdef = model if isinstance(model, ModelDef) else make_fast_model(model)
    if device.type == "cuda":
        # The JAX trunk accumulates bf16 products in f32; cuBLAS may reduce
        # in bf16 unless told not to (a no-op in f32).
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    s_count, n_trials = X.shape[:2]
    assert s_count == len(subjects)
    k = tc.n_folds
    m_count = s_count * k
    m_seed = tc.seed if model_seed is None else model_seed

    # Augmentation runs on the f32 batch before the cast to the compute
    # dtype (JAX augments before fast_apply casts), so the corpus stays f32.
    data_dtype = torch.float32 if mdef.augment else tc.compute_dtype
    x_flat = torch.as_tensor(X.reshape((-1,) + X.shape[2:]), dtype=data_dtype, device=device)
    y_flat = torch.as_tensor(Y.reshape(-1).astype(np.int64), device=device)
    train_idx, val_idx, meta = build_cv_index_stack(s_count, n_trials, k, tc.seed,
                                                    tc.shuffle_folds)
    key_off, key_total = _key_block if _key_block else (0, m_count)
    if isinstance(warm_start, tuple):
        params0, state0 = warm_start
    elif warm_start is not None:
        params0, state0 = warm_start, None
    else:
        params0, state0 = mdef.init(m_seed, m_count, total=key_total, offset=key_off)
    shard = None
    if mesh is not None:
        shard = StackShard(mesh, m_count, stack_axis, data_axis)
        params0, state0 = shard.rows_of((params0, state0))
    stack = mdef.build(m_count if shard is None else shard.m_local, device)
    mdef.load(stack, params0, state0)

    # Segments hold whole blocks of val_every epochs (make_fit requires
    # it); a val_every that does not divide the budget runs whole blocks, of
    # which make_fit runs those within the budget.
    seg = _segment_length(tc.max_epochs, epochs_per_segment)
    val_every = tc.val_every or 1
    if val_every > 1:
        seg = max((seg // val_every) * val_every, val_every)
    fit = make_fit(
        stack, n_classes, epochs=seg, batch_size=tc.batch_size, n_train=train_idx.shape[1],
        n_val=val_idx.shape[1], learning_rate=tc.learning_rate, warmup_epochs=tc.warmup_epochs,
        final_scale=tc.final_lr_scale, weight_decay=tc.weight_decay,
        val_every=val_every, total_epochs=tc.max_epochs,
        augment=mdef.augment, compute_dtype=tc.compute_dtype, shard=shard,
    )

    def progress(done, val_acc):
        if verbose and not torch.isnan(val_acc).all():
            print(f"  epoch {done}/{tc.max_epochs}: mean val_acc "
                  f"{float(val_acc.mean()):.4f}", flush=True)

    t_fit0 = time.perf_counter()
    res = fit_segmented(fit, train_idx, val_idx, x_flat, y_flat, seed=m_seed + 1 + key_off,
                        progress=progress, checkpoint_dir=checkpoint_dir, resume=resume,
                        checkpoint_every=checkpoint_every)
    t_fit = time.perf_counter() - t_fit0
    writes = res.timings.get("checkpoint_write_s")
    if verbose and writes:
        print(f"  segment checkpoints: {res.timings['checkpoint_bytes'] / 1e6:.1f} MB carry, "
              f"{len(writes)} written in " + ", ".join(f"{w:.2f}" for w in writes) + " s",
              flush=True)

    # rank 0 writes the tree: every rank leaves together, failed or not
    with fail_together(mesh):
        t_art0 = time.perf_counter()
        best_val = res.best_val_acc
        best_tree, best_state = mdef.dump({**res.best_params, **res.best_model_state})
        single = mdef.build(None, device)
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
                    h = {name: res.history[name][mi]
                         for name in ("loss", "acc", "val_loss", "val_acc")}
                    artifacts.save_history_csv(os.path.join(sub_dir, f"fold-{ki}_history.csv"), h)
                artifacts.write_csv(os.path.join(sub_dir, "fold_metrics.csv"),
                                    ["Fold", "Best_Val_Acc"], list(enumerate(fold_accs)))

            best_params = select_model(best_tree, best_m)
            best_mstate = select_model(best_state, best_m)
            if sub_dir:
                # params + mutable state (BN running statistics), as a torch
                # state_dict carries its buffers with the weights
                save_model_npz(os.path.join(sub_dir, "best_subject.npz"), best_params, best_mstate)

            test_acc, test_f1 = np.nan, np.nan
            if test_per_subject and sid in test_per_subject:
                x_test, y_test = test_per_subject[sid]
                mdef.load(single, best_params, best_mstate)
                y_pred = predict(
                    single, torch.as_tensor(x_test, dtype=tc.compute_dtype, device=device),
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
            print(f"  phases: fit {t_fit:.1f}s | per-subject artifacts+eval {t_art:.1f}s",
                  flush=True)
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


def _train_grouped(model, tc, X, Y, subjects, n_classes, test_per_subject, save_dir,
                   warm_start, epochs_per_segment, device, verbose, checkpoint_dir, resume,
                   checkpoint_every, model_seed, group: int, mesh_axis=None) -> CVRunResult:
    """Sequential subject groups for ``train_per_subject_cv`` (JAX
    ``_train_grouped``): each group runs the stacked engine over its own
    S_g*K models, with the key block (model offset, total) of its models
    in the ungrouped run and a checkpoint directory ``group-<i>`` of its
    own; the per-subject artifacts land in the shared tree, and the
    summary and the global predictions are rewritten from the groups'."""
    k = tc.n_folds
    s_total = len(subjects)
    summaries, fits, best_folds, timings = [], [], {}, {}
    for g0 in range(0, s_total, group):
        gsl = slice(g0, g0 + group)
        ws = None
        if warm_start is not None:
            parts = warm_start if isinstance(warm_start, tuple) else (warm_start,)
            ws = tuple(_slice_models(p, g0 * k, (g0 + group) * k) for p in parts)
            ws = ws if isinstance(warm_start, tuple) else ws[0]
        res = train_per_subject_cv(
            model, tc, X[gsl], Y[gsl], list(subjects[gsl]), n_classes,
            test_per_subject=test_per_subject, save_dir=save_dir, warm_start=ws,
            epochs_per_segment=epochs_per_segment, device=device, verbose=verbose,
            checkpoint_dir=(os.path.join(checkpoint_dir, f"group-{g0 // group}")
                            if checkpoint_dir else None),
            resume=resume, checkpoint_every=checkpoint_every, model_seed=model_seed,
            mesh_axis=mesh_axis, _key_block=(g0 * k, s_total * k),
        )
        if res is None:  # a rank outside the mesh
            return None
        summaries.extend(res.summary)
        fits.append(res.fit)
        best_folds.update(res.best_fold_per_subject)
        for name in ("fit_s", "artifacts_s"):
            timings[name] = timings.get(name, 0.0) + res.timings[name]

    def cat(*vs):
        if isinstance(vs[0], dict):
            return {key: cat(*(v[key] for v in vs)) for key in vs[0]}
        if isinstance(vs[0], torch.Tensor):
            return torch.cat(vs)
        return np.concatenate(vs)

    fit = FitResult(
        params=cat(*(f.params for f in fits)), best_params=cat(*(f.best_params for f in fits)),
        best_val_acc=cat(*(f.best_val_acc for f in fits)),
        best_epoch=cat(*(f.best_epoch for f in fits)), history=cat(*(f.history for f in fits)),
        timings={"groups": [f.timings for f in fits]},
        model_state=cat(*(f.model_state for f in fits)),
        best_model_state=cat(*(f.best_model_state for f in fits)),
    )
    meta = [(si, ki) for si in range(s_total) for ki in range(k)]
    if save_dir:
        artifacts.write_csv(os.path.join(save_dir, "summary_per_subject.csv"), SUMMARY_COLUMNS,
                            [[row[c] for c in SUMMARY_COLUMNS] for row in summaries])
        # The global predictions from the per-subject files this run wrote
        # (a stale file of an earlier run is not read).
        preds, trues = [], []
        for sid in subjects:
            if not (test_per_subject and sid in test_per_subject):
                continue
            p = os.path.join(save_dir, f"sub-{sid}", "test_predictions.csv")
            if os.path.exists(p):
                y_pred, y_true = artifacts.load_predictions_csv(p)
                preds.append(y_pred)
                trues.append(y_true)
        if preds:
            artifacts.save_predictions_csv(os.path.join(save_dir, "global_test_predictions.csv"),
                                           np.concatenate(preds), np.concatenate(trues))
    return CVRunResult(summary=summaries, fit=fit, meta=meta, best_fold_per_subject=best_folds,
                       timings=timings)
