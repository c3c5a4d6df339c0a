"""Zero-shot cross-subject evaluation: the S_i -> S_j transfer matrix.

Counterpart of ``imagined_speech_decoding_tpu/cli/zero_shot.py`` with the
same parser. Every per-subject model is evaluated on every subject's test
split: the S models form one ``FAST(cfg, n_models=S)`` stack and each
(target subject, batch chunk) is one forward of the stack on that chunk,
broadcast to every model. It runs in f32, as the JAX CLI does (its model
takes no compute dtype), whatever precision trained the checkpoints. It
writes::

    <out>/zero_shot_matrix.csv   accuracy, rows model_S.., columns test_S..
    <out>/zero_shot_matrix.png   the heatmap, when matplotlib imports

Models: each subject's ``sub-XX/best_subject.npz`` from
``cli.train_fast`` (``--results_dir``), or ``--synthetic N`` models
trained here on a 16-electrode synthetic montage. The device is the GPU:
without one the run raises ``RuntimeError``; a Python caller runs on the
CPU with ``main(argv, device="cpu")``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Zero-shot cross-subject transfer matrix")
    p.add_argument("--config", type=str, default="configs/default.yaml")
    p.add_argument("--results_dir", type=str, default="results/finetune_official/FAST",
                   help="dir with sub-*/best_subject.npz checkpoints")
    p.add_argument("--data_folder", type=str, default="BCIC2020Track3")
    p.add_argument("--excel_path", type=str, default=None)
    p.add_argument("--output_dir", type=str, default=None,
                   help="defaults to <results_dir>/zero_shot")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--synthetic", type=int, default=0, metavar="N_SUBJECTS")
    p.add_argument("--synthetic_trials", type=int, default=48)
    p.add_argument("--synthetic_epochs", type=int, default=6)
    p.add_argument("--no-strict", action="store_true",
                   help="disable strict schema validation of raw dataset files")
    return p


def transfer_matrix(model, tests, batch_size: int = 64) -> np.ndarray:
    """Accuracy ``(S_models, S_targets)`` of the stacked ``model``
    (``FAST(cfg, n_models=S)`` with its weights loaded) on ``tests``, a list
    of ``(x (n, C, T), y (n,))`` a target subject. One stacked forward per
    (target, chunk of ``batch_size`` trials), the chunk broadcast to every
    model; the counts and accuracies are f32, as JAX ``transfer_matrix``'s."""
    import torch

    device = next(model.parameters()).device
    model.eval()
    accs = []
    with torch.no_grad():
        for x_t, y_t in tests:
            x_t = np.asarray(x_t, np.float32)
            y_t = torch.as_tensor(np.asarray(y_t).astype(np.int64), device=device)
            n = x_t.shape[0]
            correct = torch.zeros(model.n_models, device=device)
            for lo in range(0, n, batch_size):
                xb = torch.as_tensor(x_t[lo : lo + batch_size], device=device)
                logits = model(xb.expand(model.n_models, *xb.shape))
                correct += (logits.argmax(dim=-1) == y_t[lo : lo + batch_size]).float().sum(-1)
            accs.append(correct.cpu().numpy() / max(n, 1))
    return np.asarray(accs).T


def save_artifacts(out_dir, matrix, subjects):
    """``zero_shot_matrix.csv`` as pandas writes the indexed frame, and the
    heatmap when matplotlib imports (its path, else None)."""
    from ..train.artifacts import write_csv

    os.makedirs(out_dir, exist_ok=True)
    csv_path = write_csv(os.path.join(out_dir, "zero_shot_matrix.csv"),
                         [""] + [f"test_S{s}" for s in subjects],
                         [[f"model_S{s}", *row] for s, row in zip(subjects, matrix)])
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return csv_path, None
    fig, ax = plt.subplots(figsize=(8, 7))
    im = ax.imshow(matrix, vmin=0.0, vmax=1.0, cmap="viridis")
    ax.set_xticks(range(len(subjects)), [f"S{s}" for s in subjects], rotation=90)
    ax.set_yticks(range(len(subjects)), [f"S{s}" for s in subjects])
    ax.set_xlabel("test subject")
    ax.set_ylabel("trained-on subject")
    ax.set_title("Zero-shot cross-subject accuracy")
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    png_path = os.path.join(out_dir, "zero_shot_matrix.png")
    fig.savefig(png_path, dpi=120)
    plt.close(fig)
    return csv_path, png_path


def _subset_zones(zone_dict, electrodes):
    """Restrict a zone atlas to a subset montage (the synthetic demo)."""
    es = set(electrodes)
    out = {}
    for z, chs in zone_dict.items():
        kept = tuple(c for c in chs if c in es)
        if kept:
            out[z] = kept
    return out


def synthetic_models(cfg, args, device):
    """``--synthetic S``: S models of the JAX CLI's 16-electrode montage
    (``dim_cnn`` 8, ``dim_token`` 16, 400 samples, windows of 250 every 150,
    2 layers) trained at once on ``synthetic_corpus(0, S, trials)``, the
    first 3/4 of each subject's trials to train and the rest to validate
    and to test, batch 16, warmup 1; returns ``(the stacked model at its
    best snapshot, tests)``."""
    import torch

    from ..config import FASTConfig
    from ..data.synthetic import synthetic_corpus
    from ..models.fast import FAST
    from ..train.cv import stacked_init
    from ..train.engine import make_fit
    from ..transplant import from_jax_params

    s, nt = args.synthetic, args.synthetic_trials
    electrodes = cfg.model.electrodes[:16]
    mcfg = FASTConfig(
        electrodes=electrodes, zone_dict=_subset_zones(cfg.model.zone_dict, electrodes),
        dim_cnn=8, dim_token=16, seq_len=400, window_len=250, slide_step=150,
        head="Conv4Layers", n_classes=cfg.model.n_classes, num_layers=2, num_heads=4,
        dropout=0.1,
    )
    X, Y = synthetic_corpus(0, s, nt, mcfg.n_channels, mcfg.seq_len)
    n_train = nt * 3 // 4
    tidx = np.stack([i * nt + np.arange(n_train) for i in range(s)])
    vidx = np.stack([i * nt + np.arange(n_train, nt) for i in range(s)])
    model = FAST(mcfg, n_models=s, device=device)
    model.load_state_dict(from_jax_params(stacked_init(mcfg, 0, s)))
    fit = make_fit(model, mcfg.n_classes, epochs=args.synthetic_epochs, batch_size=16,
                   n_train=n_train, n_val=nt - n_train, warmup_epochs=1)
    res = fit(tidx, vidx, torch.as_tensor(X.reshape(-1, *X.shape[2:]), device=device),
              torch.as_tensor(Y.reshape(-1).astype(np.int64), device=device), seed=1)
    model.load_state_dict(res.best_params)
    return model, [(X[i, n_train:], Y[i, n_train:]) for i in range(s)]


def checkpoint_models(cfg, args, device):
    """The test split of every subject with a ``<results_dir>/sub-XX/
    best_subject.npz``, and those checkpoints, weights and model state, as
    one stacked model: ``(model, subjects, tests)``. A params-only file of
    a head with batch-norm state is evaluated with the initial statistics,
    and a warning says so (JAX ``zero_shot.py:185-190``)."""
    from ..data.constants import SUBJECTS
    from ..data.ingest import load_test_set_per_subject, resolve_data_folder, resolve_excel_path
    from ..models.fast import FAST
    from ..train.checkpoint import load_model_npz
    from ..transplant import from_jax_params, stack_trees, to_jax_params, to_jax_state

    base = resolve_data_folder(args.data_folder)
    per_subject = load_test_set_per_subject(base, resolve_excel_path(base, args.excel_path),
                                            strict=not args.no_strict)
    subjects = [s for s in SUBJECTS if s in per_subject]
    paths = [os.path.join(args.results_dir, f"sub-{sid}", "best_subject.npz") for sid in subjects]
    sd = FAST(cfg.model).state_dict()
    template_p, template_s = to_jax_params(sd), to_jax_state(sd)
    ps, ss = [], []
    for path in paths:
        p, s, had_state = load_model_npz(path, template_p, template_s)
        if not had_state and template_s["head"]:
            print(f"WARNING: {path} is a legacy params-only checkpoint but the "
                  f"{cfg.model.head} head is stateful — evaluating with INIT "
                  "batch-norm statistics (retrain to persist state).", flush=True)
        ps.append(p)
        ss.append(s)
    model = FAST(cfg.model, n_models=len(subjects), device=device)
    model.load_state_dict(from_jax_params(stack_trees(ps), stack_trees(ss)))
    return model, subjects, [per_subject[sid] for sid in subjects]


def main(argv=None, device="cuda"):
    args = build_parser().parse_args(argv)

    from ..devices import require_device
    from .train_fast import resolve_config

    device = require_device(device)
    cfg = resolve_config(args, {})
    if args.synthetic:
        model, tests = synthetic_models(cfg, args, device)
        subjects = [f"{i + 1:02d}" for i in range(args.synthetic)]
        out_dir = args.output_dir or "results/zero_shot_synthetic"
    else:
        model, subjects, tests = checkpoint_models(cfg, args, device)
        out_dir = args.output_dir or os.path.join(args.results_dir, "zero_shot")

    matrix = transfer_matrix(model, tests, args.batch_size)
    csv_path, png_path = save_artifacts(out_dir, matrix, subjects)
    diag = np.diag(matrix)
    off = matrix[~np.eye(len(subjects), dtype=bool)]
    print(f"Zero-shot matrix saved: {csv_path}, "
          + (png_path or "no zero_shot_matrix.png (matplotlib is not installed)"))
    print(f"within-subject (diag) mean acc: {diag.mean():.4f}")
    print(f"cross-subject (off-diag) mean acc: {off.mean():.4f}", flush=True)
    return matrix


if __name__ == "__main__":
    main()
