"""Training CLI: per-subject 5-fold CV of FAST, stacked, plus test evaluation.

Counterpart of ``imagined_speech_decoding_tpu/cli/train_fast.py`` with the
same parser, on the port's engine (``train.cv``): all subject x fold
models train together on one device and the run writes the same result
tree, without the plots. The device is the GPU: without one the run
raises ``RuntimeError`` before it loads data. A Python caller trains
on the CPU with ``main(argv, device="cpu")``; the parser has no device
flag, as the JAX CLI has none.

    python -m imagined_speech_decoding_tpu_torch.cli.train_fast \\
        --synthetic 2 --synthetic_trials 60 --epochs 2 --output_dir out/

    python -m imagined_speech_decoding_tpu_torch.cli.train_fast \\
        --data_folder BCIC2020Track3 --epochs 200 --output_dir out/ [--resume]

What this slice of the port runs is the dataset's raw folder (the
training and validation ``.mat`` files of all 15 subjects merged into
each subject's CV pool; the v7.3 test split with the answer sheet's
labels, ``data.ingest``) or ``--synthetic`` data, and every ``--head``
(Conv4Layers, CVBlock, EEGNet_Encoder, HeadConv_Paper_Version; the
batch-norm heads' running statistics are saved in ``best_subject.npz``
with the weights), in either ``--precision``: bf16 (the default, the JAX package's
``bf16-mixed``: bf16 activations and head operands, f32 parameters,
optimizer state and loss) or f32. The fit runs in segments of 25 epochs
and writes its carry to ``<output_dir>/checkpoints/segment_carry.npz``
every ``--checkpoint_every``-th segment and after the last; ``--resume``
restarts from it, and the run ends as an uninterrupted one would.
``--hyperparams best.json`` (from ``cli.sweep``) sets the learning rate,
weight decay and warmup, explicit flags winning; ``--loso-pretrain``
pretrains the leave-one-subject-out stack (``train.loso``) and starts each
subject's folds from its model; ``--ensemble N`` trains an N-member seed
ensemble (``train.ensemble``), the root tree holding its soft vote;
``--augment`` adds per-trial noise (``--noise_sigma``) and channel dropout
(``--ch_drop``) to every training batch (``models.api.make_augmented_model``),
in LOSO pretraining too, which trains the model the CV trains; ``--profile
LOGDIR`` traces the CV or ensemble fit (not the data loading, not LOSO)
into ``LOGDIR/trace.json`` (``profiling.trace``), a Chrome trace for
Perfetto or ``chrome://tracing``, with the fit as the annotated range
``cli.train_fast: fit``. ``--mesh``, ``--remat`` and ``--head_chunk``
raise ``NotImplementedError`` naming ROADMAP.md.
``--config`` reads YAML with PyYAML, imported only then; without PyYAML
the default ``configs/default.yaml`` falls back to the built-in defaults,
which equal that file's values.
"""

from __future__ import annotations

import argparse
import contextlib
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
                   help="best.json from cli.sweep: its learning_rate / weight_decay / "
                   "warmup_epochs (explicit flags win)")
    p.add_argument("--data_folder", type=str, default="BCIC2020Track3")
    p.add_argument("--excel_path", type=str, default=None)
    p.add_argument("--output_dir", type=str, default="results/finetune_official/FAST")
    p.add_argument("--loso-pretrain", action="store_true", dest="loso_pretrain")
    p.add_argument("--loso-epochs", type=int, default=100)
    p.add_argument("--remat", action="store_true", help="(not ported)")
    p.add_argument("--head_chunk", type=int, default=None, metavar="N_WINDOWS",
                   help="(not ported)")
    p.add_argument("--resume", action="store_true",
                   help="restart from <output_dir>/checkpoints/segment_carry.npz")
    p.add_argument("--profile", type=str, default=None, metavar="LOGDIR",
                   help="write a Chrome trace of the fit to LOGDIR/trace.json")
    p.add_argument("--checkpoint_every", type=int, default=1, metavar="K",
                   help="write the segment checkpoint every K-th segment (the last always)")
    p.add_argument("--mesh", type=str, default="none", choices=["none", "model", "data", "2d"])
    p.add_argument("--augment", action="store_true",
                   help="train-time noise + channel dropout in the train step (eval untouched)")
    p.add_argument("--noise_sigma", type=float, default=0.1)
    p.add_argument("--ch_drop", type=float, default=0.1)
    p.add_argument("--ensemble", type=int, default=1, metavar="N_MEMBERS",
                   help="train an N-member seed ensemble and soft-vote its test posteriors")
    p.add_argument("--synthetic", type=int, default=0, metavar="N_SUBJECTS",
                   help="run on synthetic data with N subjects (no dataset needed)")
    p.add_argument("--synthetic_trials", type=int, default=60)
    p.add_argument("--label_noise", type=float, default=0.0,
                   help="synthetic mode: fraction of labels re-drawn uniformly")
    p.add_argument("--no-strict", action="store_true")
    return p


def build_overrides(args) -> dict:
    """Flat config overrides from the CLI flags; ``--hyperparams best.json``
    applies its ``learning_rate``, ``weight_decay`` and ``warmup_epochs``,
    explicit ``--learning_rate`` / ``--weight_decay`` flags winning."""
    sweep_hp = {}
    if args.hyperparams:
        import json

        with open(args.hyperparams) as f:
            best = json.load(f)
        sweep_hp = {k: best[k] for k in ("learning_rate", "weight_decay", "warmup_epochs")
                    if k in best}
        print(f"hyperparams from {args.hyperparams}: {sweep_hp}")
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
            "learning_rate": (args.learning_rate if args.learning_rate is not None
                              else sweep_hp.get("learning_rate")),
            "weight_decay": (args.weight_decay if args.weight_decay is not None
                             else sweep_hp.get("weight_decay")),
            "warmup_epochs": sweep_hp.get("warmup_epochs"),
        }.items()
        if v is not None
    }


def refuse_unported(args) -> None:
    """Raise ``NotImplementedError`` for what this slice does not run."""
    unported = [
        ("--mesh other than none", args.mesh != "none"),
        ("--remat", args.remat),
        ("--head_chunk", args.head_chunk),
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
    """``(X (S, N, 64, 800), Y (S, N), subjects, test)``, as the JAX CLI
    loads them. Real data: every subject's training and validation trials
    merged (``load_subject_train_val``) and the test split with the answer
    sheet's labels, strict unless ``--no-strict``. ``--synthetic``: the
    first third of each subject's trials as its test split, and
    ``--label_noise`` label flips. ``cli.train_baselines`` shares it; its
    parser has neither ``--no-strict`` nor ``--label_noise``."""
    if not args.synthetic:
        from ..data.constants import SUBJECTS
        from ..data.ingest import (
            load_subject_train_val,
            load_test_set_per_subject,
            resolve_data_folder,
            resolve_excel_path,
        )

        strict = not getattr(args, "no_strict", False)  # the baselines' parser has none
        base = resolve_data_folder(args.data_folder)
        excel = resolve_excel_path(base, args.excel_path)
        test = load_test_set_per_subject(base, excel, strict=strict)
        xs, ys = [], []
        for sid in SUBJECTS:
            x, y = load_subject_train_val(base, sid, strict=strict)
            xs.append(x)
            ys.append(y)
        return np.stack(xs), np.stack(ys), list(SUBJECTS), test

    from ..data.synthetic import synthetic_corpus

    s = args.synthetic
    subjects = [f"{i + 1:02d}" for i in range(s)]
    X, Y = synthetic_corpus(0, s, args.synthetic_trials, 64, 800)
    if getattr(args, "label_noise", 0.0):
        rng = np.random.default_rng(12345)
        flip = rng.random(Y.shape) < args.label_noise
        Y = np.where(flip, rng.integers(0, 5, Y.shape), Y).astype(Y.dtype)
    test = {
        sid: (X[i, : args.synthetic_trials // 3], Y[i, : args.synthetic_trials // 3])
        for i, sid in enumerate(subjects)
    }
    return X, Y, subjects, test


def format_summary(rows) -> str:
    columns = list(rows[0]) if rows else []
    lines = ["  ".join(f"{c:>12}" for c in columns)]
    for row in rows:
        lines.append("  ".join(
            f"{row[c]:>12}" if isinstance(row[c], str) else f"{row[c]:>12.4f}"
            for c in columns))
    return "\n".join(lines)


def loso_warm_start(args, cfg, model, X, Y, subjects, device):
    """``--loso-pretrain``: the LOSO stack of ``model`` (the model the CV
    trains, augmented or not) pretrained (or loaded) under
    ``<output_dir>/loso_pretrain``; returns the CV's ``(params, state)``, as
    the JAX CLI builds them: each subject's parameters repeated over its
    folds, and the initial model state of a fresh ``cv.stacked_init`` of
    the S*K stack (LOSO's running statistics are not carried over)."""
    from ..train.cv import stacked_init
    from ..train.loso import pretrain_loso, stack_pretrained_for_cv

    save_dir = os.path.join(args.output_dir, "loso_pretrain")
    pretrained = pretrain_loso(
        model, X, Y, subjects, cfg.model.n_classes, save_dir=save_dir,
        epochs=args.loso_epochs, batch_size=cfg.train.batch_size,
        learning_rate=cfg.train.learning_rate, seed=cfg.train.seed,
        data_dtype=cfg.train.compute_dtype, checkpoint_dir=os.path.join(save_dir, "checkpoints"),
        resume=args.resume, device=device,
    )
    _, state0 = stacked_init(model, cfg.train.seed, len(subjects) * cfg.train.n_folds)
    return stack_pretrained_for_cv(pretrained, cfg.train.n_folds), state0


def main(argv=None, device="cuda"):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.ensemble > 1 and args.loso_pretrain:
        # A shared warm start would collapse the members' init diversity.
        parser.error("--ensemble is incompatible with --loso-pretrain")
    refuse_unported(args)
    cfg = resolve_config(args, build_overrides(args))

    from ..devices import require_device
    from ..models.api import make_augmented_model, make_fast_model
    from ..models.heads import get_head
    from ..profiling import TRACE_FILE, annotate, trace
    from ..train.cv import train_per_subject_cv
    from ..utils import seed_all

    get_head(cfg.model.head)  # an unknown head fails before the data loads
    model = cfg.model
    if args.augment:
        model = make_augmented_model(make_fast_model(cfg.model), args.noise_sigma, args.ch_drop)
        print(f"augment: noise_sigma={args.noise_sigma} ch_drop={args.ch_drop} "
              "(train step only)", flush=True)

    device = require_device(device)
    seed_all(cfg.train.seed)
    os.makedirs(args.output_dir, exist_ok=True)
    t0 = time.perf_counter()
    X, Y, subjects, test = load_data(args)
    data_s = time.perf_counter() - t0
    common = dict(test_per_subject=test, save_dir=args.output_dir, device=device,
                  checkpoint_dir=os.path.join(args.output_dir, "checkpoints"),
                  resume=args.resume, checkpoint_every=args.checkpoint_every)
    warm = loso_warm_start(args, cfg, model, X, Y, subjects, device) if args.loso_pretrain else None
    with (trace(args.profile) if args.profile else contextlib.nullcontext()), \
            annotate("cli.train_fast: fit"):
        if args.ensemble > 1:
            from ..train.ensemble import train_seed_ensemble

            result = train_seed_ensemble(model, cfg.train, X, Y, subjects, cfg.model.n_classes,
                                         n_members=args.ensemble, **common)
        else:
            result = train_per_subject_cv(model, cfg.train, X, Y, subjects,
                                          cfg.model.n_classes, warm_start=warm, **common)
    result.timings["data_s"] = data_s
    if args.profile:
        print(f"trace of the fit written to {os.path.join(args.profile, TRACE_FILE)} (open it "
              "in https://ui.perfetto.dev or chrome://tracing)", flush=True)

    print("\n" + "=" * 60)
    print("FINETUNE COMPLETE")
    print(f"Summary saved to {args.output_dir}/summary_per_subject.csv")
    print(format_summary(result.summary))
    print("=" * 60, flush=True)
    return result


if __name__ == "__main__":
    main()
