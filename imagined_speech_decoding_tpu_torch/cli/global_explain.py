"""Group-level attribution analysis: every subject's checkpoint, per class.

Counterpart of ``imagined_speech_decoding_tpu/cli/global_explain.py``
with the same parser, messages and file names. For each subject it loads
``<model_dir>/sub-{sid}/best_subject.npz`` (``sid`` the subject's index),
splits the subject's trials by a seeded permutation into background and
explained trials, and makes one expected-gradients call with the true
labels as targets (kernel B2f and one B2x launch a sample on the card;
B2w does not run). Each class's mean map gives three plots::

    <out>/Sub{sid}_Class{k}_{name}_Topomap.png     mean over time
    <out>/Sub{sid}_Class{k}_{name}_ZoneMatrix.png  zone x time
    <out>/Sub{sid}_Class{k}_{name}_FreqBands.png   band x time of |map|

and the pooled maps, weighted by each class's trial count, three more::

    <out>/group_class_topomaps.png
    <out>/group_zone_time.png
    <out>/group_band_heatmap.png

``explain_subject`` and ``pool_subjects`` compute the arrays; ``main``
draws them when matplotlib imports. Subjects without a checkpoint or data
are skipped with a message; ``--synthetic`` without a checkpoint explains
seed 0's random weights and stamps every title ``[UNTRAINED]``. The device
is the GPU: without one the run raises ``RuntimeError``; a Python caller
runs on the CPU with ``main(argv, device="cpu")``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="All-subject FAST attribution analysis")
    p.add_argument("--model_dir", type=str, default="results/FAST",
                   help="dir containing sub-<sid>/best_subject.npz checkpoints")
    p.add_argument("--cache", type=str, default=None, help="standardized per-subject HDF5 cache")
    p.add_argument("--subjects", type=int, nargs="*", default=None,
                   help="subject indices (default: all in the cache)")
    p.add_argument("--n_bg", type=int, default=200)
    p.add_argument("--n_test", type=int, default=100,
                   help="samples to average per subject (reference --n_test)")
    p.add_argument("--n_grad_samples", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output_dir", type=str, default="shap_subject_analysis")
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic corpus instead of a cache (tests/demos)")
    p.add_argument("--n_synth_subjects", type=int, default=3)
    return p


def explain_subject(model, background, x, y, bg_idx, alphas) -> dict:
    """One subject: expected gradients of ``x (B, C, T)`` against
    ``background`` for the true labels ``y (B,)`` on the draws ``bg_idx`` /
    ``alphas (n_samples, B)``, then for each class k with trials
    ``classes[k] = {"topomap": (C,), "zone_time": (Z, T), "bands":
    (n_bands, n_frames), "n": trials}`` of its mean map, and
    ``band_names`` / ``band_times``. Arrays come back as numpy."""
    import torch

    from ..data.constants import zone_layout
    from ..explain.attribution import expected_gradients_from_draws, zone_time_matrix
    from .explain_fast import band_map

    device = next(model.parameters()).device
    bg = torch.as_tensor(np.asarray(background, np.float32), device=device)
    xt = torch.as_tensor(np.asarray(x, np.float32), device=device)
    yt = torch.as_tensor(np.asarray(y, np.int64), device=device)
    attr = expected_gradients_from_draws(model, xt, bg, yt, bg_idx, alphas)
    zl = zone_layout(model.cfg.electrodes, model.cfg.zone_dict)
    classes, band_names, times = {}, None, None
    for k in range(model.cfg.n_classes):
        mask = yt == k
        n_k = int(mask.sum())
        if not n_k:
            continue
        avg = attr[mask].mean(0)
        band_names, times, bands = band_map(avg)
        classes[k] = {"topomap": avg.mean(-1).cpu().numpy(),
                      "zone_time": zone_time_matrix(avg, zl.indices, zl.mask).cpu().numpy(),
                      "bands": bands.cpu().numpy(), "n": n_k}
    return {"attr": attr.cpu().numpy(), "classes": classes, "band_names": band_names,
            "band_times": times}


def pool_subjects(results):
    """The subjects' class maps (``explain_subject`` results) pooled with
    their trial counts as weights: ``{"topomaps": {k: (C,)}, "zone_time":
    (Z, T), "bands": (n_bands, n_frames)}``, or None when no class had a
    trial."""
    topo, counts, zone_time, bands, total = {}, {}, 0.0, 0.0, 0
    for res in results:
        for k, c in res["classes"].items():
            topo[k] = topo.get(k, 0.0) + c["topomap"] * c["n"]
            counts[k] = counts.get(k, 0) + c["n"]
            zone_time = zone_time + c["zone_time"] * c["n"]
            bands = bands + c["bands"] * c["n"]
            total += c["n"]
    if not total:
        return None
    return {"topomaps": {k: topo[k] / counts[k] for k in sorted(topo)},
            "zone_time": zone_time / total, "bands": bands / total}


def main(argv=None, device="cuda"):
    args = build_parser().parse_args(argv)

    import torch

    from ..config import FASTConfig
    from ..data.constants import CLASSES, SFREQ, Electrodes, zone_layout
    from ..devices import require_device
    from ..explain.attribution import draw_samples
    from ..models.fast import FAST
    from ..train.checkpoint import load_model_npz
    from ..transplant import from_jax_params, init_jax_layout
    from .explain_fast import matplotlib_missing, split_trials

    device = require_device(device)
    cfg = FASTConfig.default()
    model = FAST(cfg, device=device)
    params0, state0 = init_jax_layout(cfg, 0)
    zl = zone_layout()
    out = args.output_dir
    os.makedirs(out, exist_ok=True)

    if args.synthetic:
        from ..data.synthetic import synthetic_corpus

        X, Y = synthetic_corpus(args.seed, n_subjects=args.n_synth_subjects,
                                n_trials=args.n_bg + args.n_test, n_samples=cfg.seq_len)
    elif not args.cache:
        # explaining real checkpoints on synthetic data would make real-looking plots
        build_parser().error("--cache is required (or pass --synthetic)")
    else:
        from ..data.cache import load_standardized_h5

        X, Y = load_standardized_h5(args.cache)
    subjects = args.subjects if args.subjects is not None else list(range(len(X)))
    plots = not matplotlib_missing()
    if plots:
        from ..explain import (
            plot_band_heatmap,
            plot_class_topomaps,
            plot_zone_time_heatmap,
            save_topomap,
        )

    results = []
    any_untrained = False  # any subject explained on random weights
    for sid in subjects:
        ckpt = os.path.join(args.model_dir, f"sub-{sid}", "best_subject.npz")
        if os.path.exists(ckpt):
            params, state, _ = load_model_npz(ckpt, params0, state0)
            stamp = ""
        elif args.synthetic:
            # maps of random weights look like trained ones: the titles say so
            params, state = params0, state0
            stamp = " [UNTRAINED]"
            any_untrained = True
        else:
            print(f"Skipping Subject {sid}: no checkpoint at {ckpt}")
            continue
        if sid >= len(X):
            print(f"Skipping Subject {sid}: no data")
            continue
        model.load_state_dict(from_jax_params(params, state))
        bg, xt, yt = split_trials(np.asarray(X[sid]), np.asarray(Y[sid]).astype(int), args.n_bg,
                                  args.n_test, args.seed)
        bg_idx, alphas = draw_samples(torch.Generator().manual_seed(args.seed),
                                      args.n_grad_samples, len(xt), len(bg))
        res = explain_subject(model, bg, xt, yt, bg_idx, alphas)
        results.append(res)
        for k, cname in enumerate(CLASSES):
            if k not in res["classes"]:
                print(f"Skipping Sub {sid} {cname}: no samples of this class")
                continue
            if not plots:
                continue
            c, tag = res["classes"][k], f"Sub{sid}_Class{k}_{cname}"
            save_topomap(f"{out}/{tag}_Topomap.png", c["topomap"], Electrodes,
                         title=f"Sub {sid}: {cname} (True Positives){stamp}")
            plot_zone_time_heatmap(f"{out}/{tag}_ZoneMatrix.png", c["zone_time"], zl.names,
                                   sfreq=SFREQ, title=f"Sub {sid}: {cname} (Time x Region){stamp}")
            plot_band_heatmap(f"{out}/{tag}_FreqBands.png", c["bands"], res["band_names"],
                              res["band_times"], title=f"Sub {sid}: {cname}{stamp}")
        n_k = sum(c["n"] for c in res["classes"].values())
        print(f"Subject {sid}: class " + ("plots written" if plots else "maps computed")
              + f" ({n_k} samples)")

    n_done = len(results)
    pooled = pool_subjects(results)
    if plots and pooled is not None:
        gstamp = " [UNTRAINED]" if any_untrained else ""
        meta = next(r for r in results if r["classes"])
        plot_class_topomaps(f"{out}/group_class_topomaps.png",
                            {CLASSES[k]: v for k, v in pooled["topomaps"].items()}, Electrodes,
                            title=f"Group mean attribution ({n_done} subjects){gstamp}")
        plot_zone_time_heatmap(f"{out}/group_zone_time.png", pooled["zone_time"], zl.names,
                               sfreq=SFREQ, title=f"Group zone x time ({n_done} subjects){gstamp}")
        plot_band_heatmap(f"{out}/group_band_heatmap.png", pooled["bands"], meta["band_names"],
                          meta["band_times"],
                          title=f"Group band energy ({n_done} subjects){gstamp}")
    print(f"Analysis Complete! ({n_done} subjects -> {out})")
    return out


if __name__ == "__main__":
    main()
