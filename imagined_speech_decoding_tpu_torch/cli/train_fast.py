"""Training CLI: per-subject 5-fold CV of FAST, stacked, plus test evaluation.

Counterpart of ``imagined_speech_decoding_tpu/cli/train_fast.py`` with the
same parser, on the port's engine (``train.cv``): all subject x fold
models train together on one device and the run writes the same result
tree, without the plots. The device is the GPU: without one the run
raises ``RuntimeError`` before it generates data. A Python caller trains
on the CPU with ``main(argv, device="cpu")``; the parser has no device
flag, as the JAX CLI has none.

    python -m imagined_speech_decoding_tpu_torch.cli.train_fast \\
        --synthetic 2 --synthetic_trials 60 --epochs 2 --precision f32 --output_dir out/

What this slice of the port runs is ``--synthetic`` data, the
Conv4Layers head and ``--precision f32``; the other options raise
``NotImplementedError`` naming their ROADMAP.md item. ``--config`` reads
YAML with PyYAML, imported only then; without PyYAML the default
``configs/default.yaml`` falls back to the built-in defaults, which equal
that file's values.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

DEFAULT_CONFIG = "configs/default.yaml"
_ROADMAP = "is not ported yet (see ROADMAP.md, Queue 1)"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train FAST on BCI Competition 2020 Track #3 (PyTorch port)"
    )
    p.add_argument("--config", type=str, default=DEFAULT_CONFIG)
    p.add_argument("--epochs", type=int, default=None, help="Max training epochs")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--n_folds", type=int, default=None)
    p.add_argument("--precision", type=str, default=None, choices=["bf16", "f32"])
    p.add_argument("--val_every", type=int, default=None, metavar="K",
                   help="run the validation pass every K-th epoch only")
    p.add_argument("--head", type=str, default=None)
    p.add_argument("--learning_rate", type=float, default=None)
    p.add_argument("--weight_decay", type=float, default=None)
    p.add_argument("--hyperparams", type=str, default=None, metavar="BEST_JSON",
                   help="best.json from isd-sweep (not ported)")
    p.add_argument("--data_folder", type=str, default="BCIC2020Track3")
    p.add_argument("--excel_path", type=str, default=None)
    p.add_argument("--output_dir", type=str, default="results/finetune_official/FAST")
    p.add_argument("--loso-pretrain", action="store_true", dest="loso_pretrain")
    p.add_argument("--loso-epochs", type=int, default=100)
    p.add_argument("--remat", action="store_true", help="(not ported)")
    p.add_argument("--head_chunk", type=int, default=None, metavar="N_WINDOWS",
                   help="(not ported)")
    p.add_argument("--resume", action="store_true", help="(not ported)")
    p.add_argument("--profile", type=str, default=None, metavar="LOGDIR", help="(not ported)")
    p.add_argument("--checkpoint_every", type=int, default=1, metavar="K",
                   help="segment checkpoints (not ported; only 1 is accepted)")
    p.add_argument("--mesh", type=str, default="none", choices=["none", "model", "data", "2d"])
    p.add_argument("--augment", action="store_true", help="(not ported)")
    p.add_argument("--noise_sigma", type=float, default=0.1)
    p.add_argument("--ch_drop", type=float, default=0.1)
    p.add_argument("--ensemble", type=int, default=1, metavar="N_MEMBERS")
    p.add_argument("--synthetic", type=int, default=0, metavar="N_SUBJECTS",
                   help="run on synthetic data with N subjects (no dataset needed)")
    p.add_argument("--synthetic_trials", type=int, default=60)
    p.add_argument("--label_noise", type=float, default=0.0,
                   help="synthetic mode: fraction of labels re-drawn uniformly")
    p.add_argument("--no-strict", action="store_true")
    return p


def build_overrides(args) -> dict:
    """Flat config overrides from the CLI flags (``--hyperparams`` aside,
    which the port refuses)."""
    return {
        k: v
        for k, v in {
            "max_epochs": args.epochs,
            "batch_size": args.batch_size,
            "seed": args.seed,
            "n_folds": args.n_folds,
            "precision": args.precision,
            "val_every": args.val_every,
            "head": args.head,
            "learning_rate": args.learning_rate,
            "weight_decay": args.weight_decay,
        }.items()
        if v is not None
    }


def refuse_unported(args) -> None:
    """Raise ``NotImplementedError`` for what this slice does not run."""
    unported = [
        ("real (non-synthetic) data", not args.synthetic),
        ("--loso-pretrain", args.loso_pretrain),
        ("--ensemble > 1", args.ensemble > 1),
        ("--augment", args.augment),
        ("--mesh other than none", args.mesh != "none"),
        ("--resume", args.resume),
        ("--checkpoint_every other than 1", args.checkpoint_every != 1),
        ("--hyperparams", args.hyperparams),
        ("--profile", args.profile),
        ("--remat", args.remat),
        ("--head_chunk", args.head_chunk),
        ("a --head other than Conv4Layers", args.head not in (None, "Conv4Layers")),
    ]
    for what, used in unported:
        if used:
            raise NotImplementedError(f"{what} {_ROADMAP}")


def resolve_config(args, overrides: dict):
    """``load_config`` of ``--config``. Without PyYAML an explicit
    ``--config`` raises, and the default path falls back to the built-in
    defaults (equal to ``configs/default.yaml``; a test holds them)."""
    from ..config import load_config

    path = args.config if os.path.exists(args.config) else None
    if path is not None:
        try:
            import yaml  # noqa: F401
        except ImportError:
            if args.config != DEFAULT_CONFIG:
                raise
            print(f"PyYAML is not installed: using the built-in defaults, which equal "
                  f"{DEFAULT_CONFIG}", flush=True)
            path = None
    return load_config(path, overrides)


def load_data(args):
    """The ``--synthetic`` corpus: ``(X (S, N, 64, 800), Y (S, N), subjects,
    test)`` with the first third of each subject's trials as its test
    split, and ``--label_noise`` label flips, as the JAX CLI makes them."""
    from ..data.synthetic import synthetic_corpus

    s = args.synthetic
    subjects = [f"{i + 1:02d}" for i in range(s)]
    X, Y = synthetic_corpus(0, s, args.synthetic_trials, 64, 800)
    if args.label_noise:
        rng = np.random.default_rng(12345)
        flip = rng.random(Y.shape) < args.label_noise
        Y = np.where(flip, rng.integers(0, 5, Y.shape), Y).astype(Y.dtype)
    test = {
        sid: (X[i, : args.synthetic_trials // 3], Y[i, : args.synthetic_trials // 3])
        for i, sid in enumerate(subjects)
    }
    return X, Y, subjects, test


def format_summary(rows) -> str:
    from ..train.cv import SUMMARY_COLUMNS

    lines = ["  ".join(f"{c:>12}" for c in SUMMARY_COLUMNS)]
    for row in rows:
        lines.append("  ".join(
            f"{row[c]:>12}" if isinstance(row[c], str) else f"{row[c]:>12.4f}"
            for c in SUMMARY_COLUMNS))
    return "\n".join(lines)


def main(argv=None, device="cuda"):
    args = build_parser().parse_args(argv)
    refuse_unported(args)
    cfg = resolve_config(args, build_overrides(args))
    if cfg.model.head != "Conv4Layers":
        raise NotImplementedError(f"head {cfg.model.head!r} {_ROADMAP}")
    cfg.train.compute_dtype  # raises for bf16: the port trains in f32 only

    from ..devices import require_device
    from ..train.cv import train_per_subject_cv

    device = require_device(device)
    os.makedirs(args.output_dir, exist_ok=True)
    t0 = time.perf_counter()
    X, Y, subjects, test = load_data(args)
    data_s = time.perf_counter() - t0
    result = train_per_subject_cv(
        cfg.model, cfg.train, X, Y, subjects, cfg.model.n_classes,
        test_per_subject=test, save_dir=args.output_dir, device=device,
    )
    result.timings["data_s"] = data_s

    print("\n" + "=" * 60)
    print("FINETUNE COMPLETE")
    print(f"Summary saved to {args.output_dir}/summary_per_subject.csv")
    print(format_summary(result.summary))
    print("=" * 60, flush=True)
    return result


if __name__ == "__main__":
    main()
