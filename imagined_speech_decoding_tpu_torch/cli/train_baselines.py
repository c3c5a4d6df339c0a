"""Baseline-pipeline training CLI: BASELINE.json configs #1, #3 and #4.

Counterpart of ``imagined_speech_decoding_tpu/cli/train_baselines.py``
with the same parser and result tree, on the port's engine: the
pipeline's features (``pipelines.featurize_corpus``: the band-power
filters on kernel B1), per-subject K-fold CV of all subject x fold models
stacked (``train.cv``), the best fold's model on the test split, and the
tree under ``results/finetune_official/<pipeline>`` (or
``--output_dir``):

    python -m imagined_speech_decoding_tpu_torch.cli.train_baselines \\
        --pipeline bandpower_mlp --synthetic 2 --synthetic_trials 20 --epochs 2
    ... --pipeline stft_eegnet
    ... --pipeline cnn_bilstm [--augment] [--subject_group 5]

Data as ``cli.train_fast`` loads it (``--synthetic N`` or the raw
folder). ``--resume`` restarts the fit from
``<output_dir>/checkpoints/segment_carry.npz``; ``--subject_group`` trains
the subjects in sequential groups (the memory lever for the CNN-BiLSTM's
frontend at full width). ``--augment`` takes a raw-EEG pipeline only, as
in the JAX CLI. ``--mesh model|data|2d`` trains the stack on several
ranks, as ``cli.train_fast`` does (under ``torchrun``, or one rank per
visible card), rank 0 writing the tree. The device is the GPU: without
one the run raises ``RuntimeError`` before it loads data;
``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    from ..pipelines import PIPELINES

    p = argparse.ArgumentParser(
        description="Train baseline pipelines on BCI Competition 2020 Track #3 (PyTorch port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument(
        "--pipeline", type=str, required=True, choices=sorted(PIPELINES),
        help="; ".join(f"{k}: {v.description}" for k, v in sorted(PIPELINES.items())),
    )
    p.add_argument("--config", type=str, default="configs/default.yaml")
    p.add_argument("--epochs", type=int, default=None, help="Max training epochs")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--n_folds", type=int, default=None)
    p.add_argument("--precision", type=str, default=None, choices=["bf16", "f32"])
    p.add_argument("--learning_rate", type=float, default=None)
    p.add_argument("--weight_decay", type=float, default=None)
    p.add_argument("--augment", action="store_true",
                   help="train-time noise + channel dropout in the train step "
                   "(raw-EEG pipelines only; eval paths untouched)")
    p.add_argument("--noise_sigma", type=float, default=0.1,
                   help="augmentation noise scale (x per-trial signal std)")
    p.add_argument("--ch_drop", type=float, default=0.1,
                   help="augmentation per-channel dropout probability")
    p.add_argument("--data_folder", type=str, default="BCIC2020Track3")
    p.add_argument("--excel_path", type=str, default=None)
    p.add_argument("--output_dir", type=str, default=None,
                   help="default: results/finetune_official/<Pipeline>")
    p.add_argument("--resume", action="store_true",
                   help="resume from the segment checkpoint under --output_dir")
    p.add_argument("--mesh", type=str, default="none", choices=["none", "model", "data", "2d"],
                   help="device-mesh strategy (see isd-train-fast --help)")
    p.add_argument("--subject_group", type=int, default=None,
                   help="subjects trained per stacked group (the memory lever for models "
                   "whose activations do not fit the whole subject x fold stack)")
    p.add_argument("--synthetic", type=int, default=0, metavar="N_SUBJECTS",
                   help="run on synthetic data with N subjects (no dataset needed)")
    p.add_argument("--synthetic_trials", type=int, default=60)
    return p


def main(argv=None, device="cuda"):
    parser = build_parser()
    args = parser.parse_args(argv)

    from ..devices import require_device
    from ..models.api import make_augmented_model
    from ..pipelines import PIPELINES, featurize_corpus
    from ..train.cv import train_per_subject_cv
    from ..utils import seed_all
    from .train_fast import format_summary, launch_mesh, load_data, mesh_axis_of, resolve_config

    pipe = PIPELINES[args.pipeline]
    if args.augment and not pipe.augmentable:
        parser.error(
            f"--augment needs a raw-EEG-input pipeline; {pipe.name} trains "
            "on precomputed features (noise/channel-dropout semantics don't "
            "transfer to feature space)"
        )
    overrides = {
        k: v
        for k, v in {
            "max_epochs": args.epochs,
            "batch_size": args.batch_size,
            "seed": args.seed,
            "n_folds": args.n_folds,
            "precision": args.precision,
            "learning_rate": args.learning_rate,
            "weight_decay": args.weight_decay,
        }.items()
        if v is not None
    }
    cfg = resolve_config(args, overrides)
    if launch_mesh(main, argv, args, device):
        return None
    device = require_device(device)
    mesh_axis = mesh_axis_of(args)
    lead = True
    if mesh_axis:
        from ..parallel.mesh import init_world, is_lead

        device = init_world(device)
        lead = is_lead()
    seed_all(cfg.train.seed)
    out_dir = args.output_dir or os.path.join("results", "finetune_official", pipe.name)
    os.makedirs(out_dir, exist_ok=True)

    X, Y, subjects, test = load_data(args)
    n_channels, n_samples = X.shape[-2], X.shape[-1]
    if lead:
        print(f"pipeline {pipe.name}: {pipe.description}", flush=True)
    Xf, testf = featurize_corpus(pipe, X, test, device=device)
    if pipe.featurize is not None and lead:
        print(f"  features: {X.shape[2:]} -> {Xf.shape[2:]}", flush=True)

    model = pipe.make_model(n_channels, n_samples, cfg.model.n_classes)
    if args.augment:
        model = make_augmented_model(model, args.noise_sigma, args.ch_drop)
        if lead:
            print(f"  augment: noise_sigma={args.noise_sigma} ch_drop={args.ch_drop} "
                  "(train step only)", flush=True)
    result = train_per_subject_cv(
        model, cfg.train, Xf, Y, subjects, cfg.model.n_classes,
        test_per_subject=testf, save_dir=out_dir, device=device,
        checkpoint_dir=os.path.join(out_dir, "checkpoints"), resume=args.resume,
        subject_group_size=args.subject_group, mesh_axis=mesh_axis,
    )
    if result is None or not lead:  # a rank outside a '2d' grid, or not rank 0
        return result
    print("\n" + "=" * 60)
    print(f"BASELINE PIPELINE COMPLETE ({pipe.name})")
    print(f"Summary saved to {out_dir}/summary_per_subject.csv")
    print(format_summary(result.summary))
    print("=" * 60, flush=True)
    return result


if __name__ == "__main__":
    main()
