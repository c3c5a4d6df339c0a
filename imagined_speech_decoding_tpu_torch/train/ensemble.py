"""Seed ensembles: posterior soft voting over independent CV runs.

Counterpart of ``imagined_speech_decoding_tpu/train/ensemble.py``. Each of
E members is one ``cv.train_per_subject_cv`` run of the (subject x fold)
stack with ``model_seed = member_seed(seed, e)``: the folds stay those of
``tc.seed``; the initial weights, permutations and dropout differ. Member
0 keeps the seed, so ``member-0/`` is a plain run's tree. Per subject,
each member's best fold gives f32 posteriors on the test split
(``engine.predict_proba``); their mean's argmax is the ensemble's
decision.

The root of ``save_dir`` holds the ensemble's tree in the reference
layout (``sub-XX/test_predictions.csv``, ``summary_per_subject.csv`` with
a ``Member_Mean_Test_Acc`` column, ``global_test_predictions.csv``, and
``global_subject_accuracy.png`` when matplotlib imports); each member's
own tree is under ``member-{e}/``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import FASTConfig, TrainConfig
from ..devices import require_device
from ..models.api import ModelDef
from ..models.fast import FAST
from . import artifacts
from ..parallel.mesh import fail_together, is_lead, mesh_strategy
from .cv import CVRunResult, train_per_subject_cv
from .engine import predict_proba
from .metrics import confusion_matrix, f1_from_confusion

SUMMARY_COLUMNS = ("Subject", "Best_Val_Acc", "Test_Acc", "Test_F1", "Member_Mean_Test_Acc")


def member_seed(base_seed: int, member: int) -> int:
    """Member e's model seed: ``base_seed`` for member 0 (a one-member
    ensemble is the plain run), then strides of the prime 7919."""
    return base_seed + 7919 * member


@dataclass
class EnsembleResult:
    summary: List[Dict[str, object]]  # one row a subject, SUMMARY_COLUMNS
    members: List[CVRunResult]
    proba_per_subject: Dict[str, np.ndarray]  # sid -> (n_test, n_classes) mean posterior
    timings: Dict[str, object] = field(default_factory=dict)


def _best_fold_proba(single, member: CVRunResult, row: int, x: torch.Tensor,
                     batch_size: int) -> np.ndarray:
    """Posteriors of ``member``'s stack row ``row`` (its best snapshot: the
    parameters and the model state), through the one-model ``single``."""
    best = {**member.fit.best_params, **member.fit.best_model_state}
    single.load_state_dict({n: v[row] for n, v in best.items()})
    return predict_proba(single, x, batch_size)


def soft_vote(cfg, tc: TrainConfig, members: Sequence[CVRunResult],
              subjects: Sequence[str], n_classes: int,
              test_per_subject: Optional[Dict[str, Tuple[np.ndarray, np.ndarray]]],
              save_dir: Optional[str], device, verbose: bool = True):
    """The ensemble's decision from trained ``members``: per subject, the mean
    over members of their best fold's posteriors on the test split. Writes
    the root tree under ``save_dir``; returns ``(summary rows,
    proba_per_subject)``. ``cfg``: a ``FASTConfig`` or a ``models.api.ModelDef``."""
    k = tc.n_folds
    single = cfg.build(None, device) if isinstance(cfg, ModelDef) else FAST(cfg, device=device)
    rows, proba_per_subject = [], {}
    global_pred, global_true = [], []
    for si, sid in enumerate(subjects):
        # the mean over members of each member's own best-fold val accuracy
        best_val = float(np.mean([m.fit.best_val_acc[si * k + m.best_fold_per_subject[sid]]
                                  for m in members]))
        test_acc, test_f1 = np.nan, np.nan
        member_accs: List[float] = []
        if test_per_subject and sid in test_per_subject:
            x_test, y_test = test_per_subject[sid]
            y_true = y_test.astype(int)
            x_dev = torch.as_tensor(x_test, dtype=tc.compute_dtype, device=device)
            probs = []
            for m in members:
                p = _best_fold_proba(single, m, si * k + m.best_fold_per_subject[sid], x_dev,
                                     tc.batch_size)
                probs.append(p)
                member_accs.append(float(np.mean(p.argmax(-1) == y_true)))
            mean_proba = np.mean(np.stack(probs), axis=0)
            proba_per_subject[sid] = mean_proba
            y_pred = mean_proba.argmax(-1)
            cm = confusion_matrix(torch.as_tensor(y_pred), torch.as_tensor(y_true), n_classes)
            test_acc = float(np.trace(cm.numpy()) / max(len(y_true), 1))
            test_f1 = float(f1_from_confusion(cm))
            global_pred.append(y_pred)
            global_true.append(y_true)
            if save_dir:
                artifacts.save_predictions_csv(
                    os.path.join(save_dir, f"sub-{sid}", "test_predictions.csv"), y_pred, y_true)
        if verbose and not np.isnan(test_acc):
            print(f"Subject {sid}: ensemble test acc={test_acc:.4f} f1={test_f1:.4f} (members: "
                  + " ".join(f"{a:.4f}" for a in member_accs) + ")", flush=True)
        rows.append(dict(zip(SUMMARY_COLUMNS, (
            sid, best_val, test_acc, test_f1,
            float(np.mean(member_accs)) if member_accs else np.nan))))

    if save_dir:
        artifacts.write_csv(os.path.join(save_dir, "summary_per_subject.csv"), SUMMARY_COLUMNS,
                            [[r[c] for c in SUMMARY_COLUMNS] for r in rows])
        if global_pred:
            artifacts.save_predictions_csv(
                os.path.join(save_dir, "global_test_predictions.csv"),
                np.concatenate(global_pred), np.concatenate(global_true))
        if rows:
            artifacts.plot_subject_accuracy_bar(
                os.path.join(save_dir, "global_subject_accuracy.png"),
                [r["Subject"] for r in rows], [r["Test_Acc"] for r in rows])
    if verbose and global_pred:
        ens = float(np.nanmean([r["Test_Acc"] for r in rows]))
        mem = float(np.nanmean([r["Member_Mean_Test_Acc"] for r in rows]))
        print(f"ensemble mean test acc {ens:.4f} vs member mean {mem:.4f} "
              f"({len(members)} members)", flush=True)
    return rows, proba_per_subject


def train_seed_ensemble(
    cfg,
    tc: TrainConfig,
    X: np.ndarray,
    Y: np.ndarray,
    subjects: Sequence[str],
    n_classes: int,
    test_per_subject: Optional[Dict[str, Tuple[np.ndarray, np.ndarray]]] = None,
    save_dir: Optional[str] = None,
    n_members: int = 3,
    checkpoint_dir: Optional[str] = None,
    verbose: bool = True,
    device="cuda",
    **cv_kwargs,
) -> EnsembleResult:
    """Train ``n_members`` per-subject CV runs of ``cfg`` (a ``FASTConfig`` or
    a ``models.api.ModelDef``) and soft-vote them (JAX ``train_seed_ensemble``). ``cv_kwargs`` go to ``train_per_subject_cv``
    (``resume``, ``checkpoint_every``, ...); ``save_dir`` and
    ``checkpoint_dir`` get a ``member-{e}/`` each (``mesh_axis``: each
    member's stack on the run's ranks, rank 0 alone writing the trees).
    Runs on ``device``: CUDA unless the caller names another, and CUDA
    without a card raises."""
    if n_members < 1:
        raise ValueError(f"n_members must be >= 1, got {n_members}")
    device = require_device(device)
    mesh = mesh_strategy(cv_kwargs.get("mesh_axis"), device)[0]
    if mesh is not None:
        if not mesh.member:  # a rank that an odd count leaves out of a '2d' grid
            return None
        device = mesh.device
    lead = mesh is None or is_lead()
    verbose = verbose and lead
    members: List[CVRunResult] = []
    for e in range(n_members):
        if verbose:
            print(f"=== ensemble member {e + 1}/{n_members} "
                  f"(model_seed {member_seed(tc.seed, e)}) ===", flush=True)
        members.append(train_per_subject_cv(
            cfg, tc, X, Y, subjects, n_classes, test_per_subject=test_per_subject,
            save_dir=os.path.join(save_dir, f"member-{e}") if save_dir else None,
            checkpoint_dir=os.path.join(checkpoint_dir, f"member-{e}") if checkpoint_dir else None,
            verbose=verbose, model_seed=member_seed(tc.seed, e), device=device, **cv_kwargs,
        ))
    with fail_together(mesh):  # rank 0 writes the vote's tree
        summary, proba = soft_vote(cfg, tc, members, subjects, n_classes, test_per_subject,
                                   save_dir if lead else None, device, verbose)
    return EnsembleResult(summary=summary, members=members, proba_per_subject=proba)
