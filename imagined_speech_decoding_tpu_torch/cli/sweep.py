"""Hyperparameter sweep CLI: an (lr x wd [x warmup]) grid x K folds as one
stacked fit.

Counterpart of ``imagined_speech_decoding_tpu/cli/sweep.py`` with the same
parser, on the port's sweep (``train.sweep.cv_sweep``): every (config,
fold) pair is one model of a ``FAST(cfg, n_models=H*F)`` stack, trained
together on the card. It writes::

    <out>/sweep_results.csv     one row per config: lr, wd[, warmup], mean/std
                                and per-fold best val accuracy
    <out>/best.json             the winning configuration (``train_fast --hyperparams``)
    <out>/sweep_heatmap.png     lr x wd mean-val-acc matrix, when matplotlib imports

    python -m imagined_speech_decoding_tpu_torch.cli.sweep --synthetic 350 --epochs 30

The model is FAST with the head of ``--config`` (Conv4Layers,
CVBlock, EEGNet_Encoder or HeadConv_Paper_Version; a batch-norm head's
running statistics ride in each row), as the JAX CLI builds it.

Data: one subject of the raw dataset (``--subject``, ``--data_folder``)
or ``--synthetic N`` trials. Trailing trials that would make the folds
uneven are dropped, as the JAX CLI drops them. The device is the GPU:
without one the run raises ``RuntimeError``; a Python caller runs on the
CPU with ``main(argv, device="cpu")``.
"""

from __future__ import annotations

import argparse
import json
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="CV hyperparameter sweep (one stacked fit)")
    p.add_argument("--config", type=str, default="configs/default.yaml")
    p.add_argument("--data_folder", type=str, default="BCIC2020Track3")
    p.add_argument("--subject", type=str, default="01")
    p.add_argument("--lr_scales", type=str, default="0.25,0.5,1,2,4",
                   help="comma-separated multipliers of the base learning rate")
    p.add_argument("--wd_scales", type=str, default="0,1,10",
                   help="comma-separated multipliers of the base weight decay")
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--n_folds", type=int, default=5)
    p.add_argument("--base_lr", type=float, default=5e-4)
    p.add_argument("--base_wd", type=float, default=0.01)
    p.add_argument("--warmup_epochs", type=int, default=10)
    p.add_argument("--warmup_grid", type=str, default="",
                   help="comma-separated warmup-epoch values to sweep as a third grid axis "
                   "(each row carries its own per-step lr table; empty = fixed --warmup_epochs)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--precision", type=str, default="bf16", choices=["bf16", "f32"])
    p.add_argument("--segment_epochs", type=int, default=0,
                   help="train in segments of this many epochs (0 = one run)")
    p.add_argument("--output_dir", type=str, default="results/sweep")
    p.add_argument("--synthetic", type=int, default=0, metavar="N_TRIALS",
                   help="use a synthetic corpus of N trials instead of the dataset")
    p.add_argument("--no-strict", action="store_true",
                   help="disable strict schema validation of raw dataset files")
    return p


def _parse_scales(spec: str):
    vals = [float(v) for v in spec.split(",") if v.strip() != ""]
    if not vals:
        raise ValueError(f"empty scale list: {spec!r}")
    return vals


def _plot_heatmap(path, report, lr_scales, wd_scales, n_w) -> bool:
    """The lr x wd heatmap of the JAX CLI, best over warmups per cell; False
    (nothing written) without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    import numpy as np

    mat = np.asarray(report.mean_val_acc).reshape(len(lr_scales), len(wd_scales), n_w).max(-1)
    fig, ax = plt.subplots(figsize=(1.2 + 1.1 * len(wd_scales), 1.0 + 0.8 * len(lr_scales)))
    im = ax.imshow(mat, cmap="viridis")
    ax.set_xticks(range(len(wd_scales)), [f"{report.wd[j * n_w]:g}" for j in range(len(wd_scales))])
    ax.set_yticks(range(len(lr_scales)),
                  [f"{report.lr[i * len(wd_scales) * n_w]:g}" for i in range(len(lr_scales))])
    ax.set_xlabel("weight decay")
    ax.set_ylabel("learning rate")
    ax.set_title("mean best val accuracy" + (f" (max over {n_w} warmups)" if n_w > 1 else ""))
    for i in range(mat.shape[0]):
        for j in range(mat.shape[1]):
            ax.text(j, i, f"{mat[i, j]:.3f}", ha="center", va="center",
                    color="w" if mat[i, j] < mat.max() * 0.85 else "k", fontsize=8)
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return True


def save_artifacts(out_dir, report, lr_scales, wd_scales, warmup_grid=None):
    """``sweep_results.csv`` (pandas' header and row order), ``best.json``
    and, when matplotlib imports, ``sweep_heatmap.png``. Returns the three
    paths, the heatmap's None when it was not written."""
    from ..train.artifacts import write_csv

    os.makedirs(out_dir, exist_ok=True)
    rows = report.rows()
    csv_path = write_csv(os.path.join(out_dir, "sweep_results.csv"), list(rows[0]),
                         [list(r.values()) for r in rows])
    best_path = os.path.join(out_dir, "best.json")
    with open(best_path, "w") as f:
        json.dump(report.best, f, indent=2)
    png_path = os.path.join(out_dir, "sweep_heatmap.png")
    n_w = len(warmup_grid) if warmup_grid else 1
    if not _plot_heatmap(png_path, report, lr_scales, wd_scales, n_w):
        png_path = None
    return csv_path, png_path, best_path


def main(argv=None, device="cuda"):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from ..devices import require_device
    from ..train.sweep import cv_sweep
    from .train_fast import resolve_config

    device = require_device(device)
    lr_scales = _parse_scales(args.lr_scales)
    wd_scales = _parse_scales(args.wd_scales)
    warmup_grid = ([int(v) for v in args.warmup_grid.split(",") if v.strip() != ""]
                   if args.warmup_grid else None)

    mcfg = resolve_config(args, {}).model
    if args.synthetic:
        from ..data.synthetic import synthetic_trials

        x, y = synthetic_trials(args.seed, args.synthetic, mcfg.n_channels, mcfg.seq_len,
                                mcfg.n_classes)
        label = f"synthetic-{args.synthetic}"
    else:
        from ..data.ingest import load_subject_train_val, resolve_data_folder

        x, y = load_subject_train_val(resolve_data_folder(args.data_folder), args.subject,
                                      strict=not args.no_strict)
        label = f"sub-{args.subject}"

    n_trials = x.shape[0]
    if n_trials % args.n_folds:
        drop = n_trials % args.n_folds
        print(f"dropping {drop} trailing trials for uniform {args.n_folds}-fold splits")
        x, y = x[: n_trials - drop], y[: n_trials - drop]
        n_trials -= drop

    h = len(lr_scales) * len(wd_scales) * (len(warmup_grid) if warmup_grid else 1)
    print(f"sweep [{label}]: {len(lr_scales)} lr x {len(wd_scales)} wd"
          + (f" x {len(warmup_grid)} warmup" if warmup_grid else "")
          + f" x {args.n_folds} folds = {h * args.n_folds} models, {args.epochs} epochs",
          flush=True)
    report = cv_sweep(
        mcfg, mcfg.n_classes, np.asarray(x, np.float32), np.asarray(y).astype(np.int64),
        n_trials=n_trials, lr_scales=lr_scales, wd_scales=wd_scales, n_folds=args.n_folds,
        epochs=args.epochs, batch_size=args.batch_size, base_learning_rate=args.base_lr,
        base_weight_decay=args.base_wd, warmup_epochs=args.warmup_epochs,
        warmup_epochs_list=warmup_grid, seed=args.seed,
        data_dtype=torch.bfloat16 if args.precision == "bf16" else None,
        segment_epochs=args.segment_epochs or None, device=device,
    )

    csv_path, png_path, best_path = save_artifacts(args.output_dir, report, lr_scales,
                                                   wd_scales, warmup_grid)
    b = report.best
    print(f"sweep artifacts: {csv_path}, "
          + (png_path or "no sweep_heatmap.png (matplotlib is not installed)")
          + f", {best_path}")
    print(f"best: lr={b['learning_rate']:g} wd={b['weight_decay']:g} "
          + (f"warmup={b['warmup_epochs']} " if "warmup_epochs" in b else "")
          + f"mean val_acc {b['mean_val_acc']:.4f} +/- {b['std_val_acc']:.4f}", flush=True)
    return report


if __name__ == "__main__":
    main()
