"""TSception baseline CLI: per-subject 5-fold CV, stacked, plus test evaluation.

Counterpart of ``imagined_speech_decoding_tpu/cli/train_tsception.py``
with the same parser and behaviour, on the port's engine: per subject,
the CV folds of ``train.cv`` (``KFold(5, shuffle=True,
random_state=seed)``, the same as the FAST CLI's), f32, plain Adam
(AdamW at weight decay 0), no warmup and a constant learning rate
(``--lr``, 1e-3), batch 32, the best fold's model evaluated on the test
split, the FAST CLI's result tree (``best_subject.npz`` with the batch
norms' running statistics). The subjects train in sequential groups of
``--subject_group`` (default 1: 5 models at once), each group's folds
stacked. The device is the GPU: without one the run raises
``RuntimeError`` before it loads data; ``main(argv, device="cpu")`` trains
on the CPU.

    python -m imagined_speech_decoding_tpu_torch.cli.train_tsception \\
        --synthetic 2 --synthetic_trials 60 --epochs 2 --output_dir out/

Data: ``--synthetic N`` (each subject's first 20 trials as its test
split), ``--cache`` / ``--test_cache`` (HDF5 caches of ``cli.preprocess``;
h5py), or the raw folder (``--data_folder``; strict schema checks unless
``--no-strict``). ``--subjects`` selects subjects by position (``0-15``
or ``0,3,7``). ``--augment`` adds per-trial noise and channel dropout in
the train step.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="TSception LOFO benchmark (PyTorch port)")
    p.add_argument("--cache", type=str, default=None, help="per-subject HDF5 cache")
    p.add_argument("--test_cache", type=str, default=None, help="official-test HDF5 cache")
    p.add_argument("--data_folder", type=str, default="BCIC2020Track3")
    p.add_argument("--excel_path", type=str, default=None)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--subjects", type=str, default=None, help="e.g. 0-15 or 0,3,7")
    p.add_argument("--output_dir", type=str, default="results/Results_TSception_LOFO")
    p.add_argument("--synthetic", type=int, default=0, metavar="N_SUBJECTS")
    p.add_argument("--synthetic_trials", type=int, default=60)
    p.add_argument("--augment", action="store_true",
                   help="train-time noise + channel dropout in the train step (eval untouched)")
    p.add_argument("--noise_sigma", type=float, default=0.1)
    p.add_argument("--ch_drop", type=float, default=0.1)
    p.add_argument("--subject_group", type=int, default=1,
                   help="subjects trained per stacked group (each group of "
                   "subject_group*n_folds models trains at once)")
    p.add_argument("--no-strict", action="store_true",
                   help="disable strict schema validation of raw dataset files")
    return p


def parse_subjects(spec: Optional[str], n: int):
    """Subject positions: all, ``a-b`` (``range(a, min(b, n))``) or ``a,b,c``."""
    if not spec:
        return list(range(n))
    if "-" in spec:
        a, b = map(int, spec.split("-"))
        return list(range(a, min(b, n)))
    return [int(s) for s in spec.split(",")]


def load_data(args):
    """``(X (S, N, 64, 800), Y (S, N), subjects, test)`` as the JAX CLI
    loads them."""
    from ..data.constants import SUBJECTS

    if args.synthetic:
        from ..data.synthetic import synthetic_corpus

        s = args.synthetic
        subjects = [f"{i + 1:02d}" for i in range(s)]
        X, Y = synthetic_corpus(1, s, args.synthetic_trials, 64, 800)
        test = {sid: (X[i, :20], Y[i, :20]) for i, sid in enumerate(subjects)}
        return X, Y, subjects, test

    from ..data.ingest import (
        load_subject_train_val,
        load_test_set_per_subject,
        resolve_data_folder,
        resolve_excel_path,
    )

    strict = not args.no_strict
    if args.cache:
        from ..data.cache import load_standardized_h5

        X, Y = load_standardized_h5(args.cache)
        subjects = list(SUBJECTS)[: X.shape[0]]
    else:
        base = resolve_data_folder(args.data_folder)
        xs, ys = [], []
        for sid in SUBJECTS:
            x, y = load_subject_train_val(base, sid, strict=strict)
            xs.append(x)
            ys.append(y)
        X, Y = np.stack(xs), np.stack(ys)
        subjects = list(SUBJECTS)

    if args.test_cache:
        from ..data.cache import load_standardized_h5

        XT, YT = load_standardized_h5(args.test_cache)
        test = {sid: (XT[i], YT[i]) for i, sid in enumerate(subjects)}
    elif not args.cache:
        base = resolve_data_folder(args.data_folder)
        excel = resolve_excel_path(base, args.excel_path)
        test = load_test_set_per_subject(base, excel, strict=strict)
    else:
        test = {}
    return X, Y, subjects, test


def main(argv=None, device="cuda"):
    args = build_parser().parse_args(argv)

    from ..config import TrainConfig
    from ..devices import require_device
    from ..models.api import make_augmented_model, make_tsception_model
    from ..train.cv import train_per_subject_cv
    from ..utils import seed_all
    from .train_fast import format_summary

    device = require_device(device)
    seed_all(args.seed)
    X, Y, subjects, test = load_data(args)
    sel = parse_subjects(args.subjects, len(subjects))
    X, Y = X[sel], Y[sel]
    subjects = [subjects[i] for i in sel]
    test = {sid: test[sid] for sid in subjects if sid in test}

    n_ch, n_t = X.shape[2], X.shape[3]
    model = make_tsception_model(n_ch, n_t, n_classes=5)
    if args.augment:
        model = make_augmented_model(model, args.noise_sigma, args.ch_drop)
        print(f"augment: noise_sigma={args.noise_sigma} ch_drop={args.ch_drop} "
              "(train step only)", flush=True)
    tc = TrainConfig(
        max_epochs=args.epochs, batch_size=args.batch_size,
        learning_rate=args.lr, warmup_epochs=0, final_lr_scale=1.0,
        weight_decay=0.0,  # the reference trains with plain Adam
        seed=args.seed, n_folds=5, precision="f32",
    )
    os.makedirs(args.output_dir, exist_ok=True)
    result = train_per_subject_cv(
        model, tc, X, Y, subjects, n_classes=5,
        test_per_subject=test, save_dir=args.output_dir,
        subject_group_size=args.subject_group, device=device,
    )
    print(format_summary(result.summary))
    mean_acc = float(np.mean([r["Test_Acc"] for r in result.summary]))
    print(f"\n=== BENCHMARK COMPLETE ===\nTSception mean accuracy: {mean_acc:.4f}", flush=True)
    return result


if __name__ == "__main__":
    main()
