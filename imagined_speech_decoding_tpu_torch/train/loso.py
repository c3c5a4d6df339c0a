"""LOSO (leave-one-subject-out) cross-subject pretraining and the CV warm start.

Counterpart of ``imagined_speech_decoding_tpu/train/loso.py``. For each
target subject the other subjects' trials are pooled, a stratified 10%
validation split is held out, and a model is trained and kept at its best
validation accuracy (``Pretrain_excludes_sub{sid}.npz``, its parameters
in the JAX key layout, so either package reads the other's files). All S
exclusions train at once as one stack of the model (``FAST(cfg,
n_models=S)``, or a ``models.api.ModelDef``'s module: a batch-norm head,
an augmented model) through the CV engine; each row's index vectors leave
its subject out. If every subject's file exists, they are loaded and
nothing trains.

The stratified split is sklearn's ``train_test_split(stratify=...)``,
restated with ``np.random.RandomState`` (the card's machine has no
sklearn): ``StratifiedShuffleSplit._iter_indices`` and
``utils.extmath._approximate_mode`` of sklearn 1.9, the same draws in the
same order, so the indices equal the JAX package's.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..devices import require_device
from ..models.api import ModelDef, make_fast_model
from ..parallel.mesh import StackShard, any_rank, fail_together, is_lead, mesh_strategy
from ..transplant import stack_trees
from . import cv
from .checkpoint import load_state_dict, save_state_dict, select_model
from .engine import FitResult, fit_segmented, make_fit


def _approximate_mode(class_counts: np.ndarray, n_draws: int,
                      rng: np.random.RandomState) -> np.ndarray:
    """sklearn ``_approximate_mode``: the per-class counts of ``n_draws``
    draws nearest the multivariate hypergeometric mode, remainders' ties
    broken by ``rng.choice``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def stratified_split(labels: np.ndarray, n_test: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Positions ``(train, test)`` into ``labels`` that sklearn's
    ``train_test_split(range(n), test_size=n_test, random_state=seed,
    stratify=labels)`` returns (``StratifiedShuffleSplit``'s first split)."""
    n = len(labels)
    n_train = n - n_test
    classes, y_indices, class_counts = np.unique(labels, return_inverse=True, return_counts=True)
    if class_counts.min() < 2:
        raise ValueError("every class needs at least 2 members for a stratified split")
    if n_train < len(classes) or n_test < len(classes):
        raise ValueError(f"train ({n_train}) and test ({n_test}) sizes must each hold every "
                         f"one of the {len(classes)} classes")
    class_indices = np.split(np.argsort(y_indices, kind="stable"), np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(seed)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(len(classes)):
        perm = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(perm[: n_i[i]])
        test.extend(perm[n_i[i] : n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def build_loso_index_stack(y: np.ndarray, val_frac: float = 0.1,
                           seed: int = 42) -> Tuple[np.ndarray, np.ndarray]:
    """``(train_idx (S, n_tr), val_idx (S, n_val))`` into the flattened
    ``S * N`` trial axis: row s pools every subject but s and holds out a
    stratified ``val_frac`` of it (at least one trial a class), both
    sorted. ``y (S, N)`` are the labels."""
    s_count, n = y.shape
    train_rows, val_rows = [], []
    for s in range(s_count):
        pool = np.concatenate([np.arange(o * n, (o + 1) * n) for o in range(s_count) if o != s])
        labels = y.reshape(-1)[pool]
        n_val = max(int(round(val_frac * len(pool))), len(np.unique(labels)))
        tr, va = stratified_split(labels, n_val, seed)
        train_rows.append(np.sort(pool[tr]))
        val_rows.append(np.sort(pool[va]))
    return np.stack(train_rows), np.stack(val_rows)


def _ckpt_path(save_dir: str, sid: str) -> str:
    return os.path.join(save_dir, f"Pretrain_excludes_sub{sid}.npz")


def pretrain_loso(
    model,
    X: np.ndarray,  # (S, N, C, T)
    Y: np.ndarray,  # (S, N)
    subjects: List[str],
    n_classes: int,
    save_dir: str,
    epochs: int = 100,
    batch_size: int = 64,
    learning_rate: float = 5e-4,
    warmup_epochs: int = 10,
    seed: int = 42,
    data_dtype: Optional[torch.dtype] = None,
    verbose: bool = True,
    checkpoint_dir: Optional[str] = None,
    resume: bool = True,
    return_result: bool = False,
    device="cuda",
    mesh_axis: Optional[str] = None,
) -> List:
    """Train the S LOSO models at once and save each one's best parameters;
    returns their JAX-layout parameter trees (numpy leaves), one per
    excluded subject.

    ``model``: a ``FASTConfig`` or a ``models.api.ModelDef``, as
    ``cv.train_per_subject_cv`` takes it; an augmented model
    (``make_augmented_model``) trains on augmented batches. As JAX
    ``pretrain_loso``: weight decay 0.01, final lr scale 0.1, a validation
    pass every epoch, initial weights and state ``cv.stacked_init(model,
    seed, S)``, the fit seeded with ``seed + 1``, in segments of
    ``cv._segment_length(epochs, 25)`` epochs (``checkpoint_dir`` and
    ``resume`` go to ``engine.fit_segmented``). Each file holds the
    parameters only, as JAX's does: a batch-norm head's running
    statistics stay in the ``FitResult``. ``data_dtype`` is the compute
    dtype (f32 when None); the corpus is held in it on the device, or in
    f32 for an augmented model, which augments before the cast.
    Idempotent: when every subject's file exists they are loaded and
    nothing trains. ``return_result=True`` returns ``(trees, FitResult)``
    (``None`` on that path; its ``model_state`` / ``best_model_state`` hold
    the statistics). Runs on ``device``: CUDA unless the caller names
    another, and CUDA without a card raises. ``mesh_axis``: the stack on
    the run's ranks, as ``cv.train_per_subject_cv`` runs it; rank 0 alone
    writes the files and prints."""
    mdef = model if isinstance(model, ModelDef) else make_fast_model(model)
    device = require_device(device)
    mesh = stack_axis = data_axis = None
    if mesh_axis:
        mesh, stack_axis, data_axis = mesh_strategy(mesh_axis, device)
        if not mesh.member:
            return (None, None) if return_result else None
        device = mesh.device
    lead = mesh is None or is_lead()
    verbose = verbose and lead
    os.makedirs(save_dir, exist_ok=True)
    s_count = len(subjects)
    done = all(os.path.exists(_ckpt_path(save_dir, sid)) for sid in subjects)
    if mesh is not None:  # one branch on every rank: skip only where all have the files
        done = not any_rank(not done, mesh.group, mesh.device)
    if done:
        if verbose:
            print(f"LOSO: all {s_count} checkpoints exist; skipping pretraining", flush=True)
        template, _ = mdef.init(0, None)
        loaded = [load_state_dict(_ckpt_path(save_dir, sid), template) for sid in subjects]
        return (loaded, None) if return_result else loaded

    train_idx, val_idx = build_loso_index_stack(Y, val_frac=0.1, seed=seed)
    compute = data_dtype or torch.float32
    x_flat = torch.as_tensor(X.reshape((-1,) + X.shape[2:]),
                             dtype=torch.float32 if mdef.augment else compute, device=device)
    y_flat = torch.as_tensor(Y.reshape(-1).astype(np.int64), device=device)
    params0, state0 = cv.stacked_init(model, seed, s_count)
    shard = None
    if mesh is not None:
        shard = StackShard(mesh, s_count, stack_axis, data_axis)
        params0, state0 = shard.rows_of((params0, state0))
    stack = mdef.build(s_count if shard is None else shard.m_local, device)
    mdef.load(stack, params0, state0)
    fit = make_fit(stack, n_classes, epochs=cv._segment_length(epochs, 25), batch_size=batch_size,
                   n_train=train_idx.shape[1], n_val=val_idx.shape[1],
                   learning_rate=learning_rate, warmup_epochs=warmup_epochs,
                   total_epochs=epochs, augment=mdef.augment, compute_dtype=compute, shard=shard)
    res: FitResult = fit_segmented(fit, train_idx, val_idx, x_flat, y_flat, seed=seed + 1,
                                   checkpoint_dir=checkpoint_dir, resume=resume)

    best_tree, _ = mdef.dump(res.best_params)
    best = [select_model(best_tree, si) for si in range(s_count)]
    with fail_together(mesh):  # rank 0 writes: every rank returns once the files are there
        for si, sid in enumerate(subjects):
            if lead:
                save_state_dict(_ckpt_path(save_dir, sid), best[si])
            if verbose:
                print(f"LOSO pretrain (excl. {sid}): best val_acc={res.best_val_acc[si]:.4f}",
                      flush=True)
    return (best, res) if return_result else best


def stack_pretrained_for_cv(pretrained: List, n_folds: int) -> dict:
    """Each subject's pretrained tree repeated over its folds, stacked in
    the CV stack's (subject, fold) order: ``[S trees] -> (S*K)`` rows, the
    ``warm_start`` of ``cv.train_per_subject_cv``."""
    return stack_trees([p for p in pretrained for _ in range(n_folds)])
