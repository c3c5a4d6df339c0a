"""Attribution analysis of one FAST checkpoint, with its plots.

Counterpart of ``imagined_speech_decoding_tpu/cli/explain_fast.py`` with
the same parser and file names. It loads a ``best_subject.npz`` (random
weights from ``transplant.init_jax_layout_params(cfg, 0)`` without one),
takes the subject's trials from ``--cache`` or ``synthetic_trials``,
splits them by a seeded permutation into background and explained trials,
and computes expected gradients for each trial's predicted class in f32:
one forward without gradient (kernel B2f on the card), then one input
gradient a sample (B2f and B2x; the weights are frozen, so B2w does not
run). ``explain_arrays`` computes every array the plots show; ``main``
draws them when matplotlib imports::

    <out>/sample{i}_pred{p}_true{t}_heatmap.png   electrode x time map
    <out>/sample{i}_pred{p}_true{t}_topomap.png   its mean over time
    <out>/sample{i}_pred{p}_true{t}_zones.png     its zone importance
    <out>/class_topomaps_correct_only.png         per-class means
    <out>/class_topomaps_errors_only.png
    <out>/zone_time.png                           zone x time of the mean map
    <out>/band_heatmap.png                        band x time of |mean map|

The device is the GPU: without one the run raises ``RuntimeError``; a
Python caller runs on the CPU with ``main(argv, device="cpu")``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="FAST attribution analysis")
    p.add_argument("--checkpoint", type=str, default=None, help="best_subject.npz")
    p.add_argument("--cache", type=str, default=None, help="per-subject HDF5 cache")
    p.add_argument("--subject", type=int, default=0, help="subject index in the cache")
    p.add_argument("--n_background", type=int, default=64)
    p.add_argument("--n_test", type=int, default=16)
    p.add_argument("--n_grad_samples", type=int, default=32)
    p.add_argument("--n_sample_plots", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output_dir", type=str, default="results/explain/FAST")
    p.add_argument("--synthetic", action="store_true")
    return p


def load_fast(cfg, checkpoint, device):
    """``FAST(cfg)`` on ``device`` with the weights and model state of the
    ``best_subject.npz`` at ``checkpoint``, or seed 0's random weights when
    it is None."""
    from ..models.fast import FAST
    from ..train.checkpoint import load_model_npz
    from ..transplant import from_jax_params, init_jax_layout

    params, state = init_jax_layout(cfg, 0)
    if checkpoint:
        params, state, _ = load_model_npz(checkpoint, params, state)
    model = FAST(cfg, device=device)
    model.load_state_dict(from_jax_params(params, state))
    return model


def split_trials(x, y, n_background: int, n_test: int, seed: int):
    """The seeded permutation into ``(background, explained trials, their
    labels)``: the first ``n_background`` trials of
    ``default_rng(seed).permutation``, then the next ``n_test``."""
    perm = np.random.default_rng(seed).permutation(len(x))
    sel = perm[n_background: n_background + n_test]
    return x[perm[:n_background]], x[sel], np.asarray(y)[sel].astype(int)


def band_map(attr_ct):
    """``band_stft_heatmap`` of the mean over channels of ``|attr_ct (C,
    T)|``: ``(band names, frame times, (n_bands, n_frames))``."""
    from ..data.constants import SFREQ
    from ..ops.spectral import band_stft_heatmap

    return band_stft_heatmap(attr_ct.abs().mean(0), SFREQ, nperseg=64, noverlap=32)


def explain_arrays(model, background, x, y, bg_idx, alphas) -> dict:
    """Everything the plots show, on the model's device, from the draws
    ``bg_idx`` / ``alphas (n_samples, B)`` (``attribution.draw_samples``):
    the attributions ``attr (B, C, T)`` for the predictions ``preds (B,)``,
    each trial's zone importance ``(B, Z)``, the per-class means over time
    and trials of the correct and the wrong trials (``class_means``:
    ``{"correct_only": {class: (C,)}, "errors_only": ...}``), the zone x
    time matrix of the mean map ``(Z, T)`` and its band heatmap. Arrays
    come back as numpy."""
    import torch

    from ..data.constants import CLASSES, zone_layout
    from ..explain.attribution import (
        _frozen,
        expected_gradients_from_draws,
        zone_importance,
        zone_time_matrix,
    )

    device = next(model.parameters()).device
    bg = torch.as_tensor(np.asarray(background, np.float32), device=device)
    xt = torch.as_tensor(np.asarray(x, np.float32), device=device)
    with _frozen(model), torch.no_grad():
        preds = model(xt).argmax(-1)
    attr = expected_gradients_from_draws(model, xt, bg, preds, bg_idx, alphas)
    zl = zone_layout(model.cfg.electrodes, model.cfg.zone_dict)
    yt = torch.as_tensor(np.asarray(y, np.int64), device=device)
    correct = preds == yt
    class_means = {"correct_only": {}, "errors_only": {}}
    for name, mask in (("correct_only", correct), ("errors_only", ~correct)):
        for k, cname in enumerate(CLASSES):
            sel = (yt == k) & mask
            if bool(sel.any()):  # mean over time, then over the trials
                class_means[name][cname] = attr[sel].mean(-1).mean(0).cpu().numpy()
    mean_attr = attr.mean(0)
    band_names, times, bands = band_map(mean_attr)
    return {"attr": attr.cpu().numpy(), "preds": preds.cpu().numpy(),
            "zone_importance": zone_importance(attr, zl.indices, zl.mask).cpu().numpy(),
            "class_means": class_means,
            "zone_time": zone_time_matrix(mean_attr, zl.indices, zl.mask).cpu().numpy(),
            "band_names": band_names, "band_times": times, "bands": bands.cpu().numpy(),
            "accuracy": float(correct.float().mean())}


def matplotlib_missing() -> bool:
    """True, with one line printed, when the plots cannot be drawn."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("plots skipped: matplotlib is not installed", flush=True)
        return True
    return False


def draw(out: str, arrays: dict, y, n_sample_plots: int) -> None:
    """The plot files of the module docstring, from ``explain_arrays``."""
    from ..data.constants import CLASSES, SFREQ, Electrodes, zone_layout
    from ..explain import (
        plot_attribution_heatmap,
        plot_band_heatmap,
        plot_class_topomaps,
        plot_zone_importance,
        plot_zone_time_heatmap,
        save_topomap,
    )

    zl = zone_layout()
    attr, preds = arrays["attr"], arrays["preds"]
    for i in range(min(n_sample_plots, len(attr))):
        tag = f"sample{i}_pred{preds[i]}_true{y[i]}"
        plot_attribution_heatmap(
            f"{out}/{tag}_heatmap.png", attr[i], Electrodes, sfreq=SFREQ,
            title=f"Attribution — pred {CLASSES[preds[i]]}, true {CLASSES[y[i]]}",
        )
        save_topomap(f"{out}/{tag}_topomap.png", attr[i].mean(-1), Electrodes,
                     title=f"pred {CLASSES[preds[i]]}")
        plot_zone_importance(f"{out}/{tag}_zones.png", arrays["zone_importance"][i], zl.names)
    for name, per_class in arrays["class_means"].items():
        if per_class:
            plot_class_topomaps(f"{out}/class_topomaps_{name}.png", per_class, Electrodes,
                                title=f"Mean attribution ({name.replace('_', ' ')})")
    plot_zone_time_heatmap(f"{out}/zone_time.png", arrays["zone_time"], zl.names, sfreq=SFREQ)
    plot_band_heatmap(f"{out}/band_heatmap.png", arrays["bands"], arrays["band_names"],
                      arrays["band_times"])


def main(argv=None, device="cuda"):
    args = build_parser().parse_args(argv)

    import torch

    from ..config import FASTConfig
    from ..devices import require_device
    from ..explain.attribution import draw_samples

    device = require_device(device)
    cfg = FASTConfig.default()
    model = load_fast(cfg, args.checkpoint, device)
    if args.synthetic or not args.cache:
        from ..data.synthetic import synthetic_trials

        x, y = synthetic_trials(args.seed, args.n_background + args.n_test, 64, cfg.seq_len)
    else:
        from ..data.cache import load_standardized_h5

        X, Y = load_standardized_h5(args.cache)
        x, y = X[args.subject], Y[args.subject]
    bg, xt, yt = split_trials(x, y, args.n_background, args.n_test, args.seed)
    bg_idx, alphas = draw_samples(torch.Generator().manual_seed(args.seed), args.n_grad_samples,
                                  len(xt), len(bg))
    arrays = explain_arrays(model, bg, xt, yt, bg_idx, alphas)
    out = args.output_dir
    os.makedirs(out, exist_ok=True)
    if not matplotlib_missing():
        draw(out, arrays, yt, args.n_sample_plots)
    print(f"attribution analysis written to {out} "
          f"(accuracy on explained set: {arrays['accuracy']:.3f})")
    return out


if __name__ == "__main__":
    main()
