"""Signal-quality analysis of one subject: Welch PSD and FastICA.

Counterpart of ``imagined_speech_decoding_tpu/cli/artifact_analysis.py``
with the same parser and file names. ``qc_arrays`` computes, on the
device, the Welch PSD of every trial and channel (``ops.spectral.
welch_psd``, ``nperseg = min(256, T)``) averaged over trials, and the
FastICA of the trials laid end to end (``ops.ica.fast_ica``, the JAX
CLI's sklearn settings). ``main`` writes::

    <out>/psd.npz              freqs, pxx (C, F): always
    <out>/psd.png              the PSD between --fmin and --fmax
    <out>/ica_components.png   each component's topography
    <out>/ica_sources.png      the sources' first 10 s

the plots when matplotlib imports. The device is the GPU: without one the
run raises ``RuntimeError``; a Python caller runs on the CPU with
``main(argv, device="cpu")``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="EEG artifact / signal-quality analysis")
    p.add_argument("--cache", type=str, default=None, help="per-subject HDF5 cache")
    p.add_argument("--subject", type=int, default=0)
    p.add_argument("--n_components", type=int, default=15)
    p.add_argument("--fmin", type=float, default=0.1)
    p.add_argument("--fmax", type=float, default=40.0)
    p.add_argument("--output_dir", type=str, default="results/artifact_analysis")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--n_trials", type=int, default=100, help="synthetic-mode trial count")
    p.add_argument("--seed", type=int, default=0)
    return p


def qc_arrays(x, n_components: int, seed: int) -> dict:
    """``x (N, C, T)`` tensor -> ``{"freqs": (F,), "pxx": (C, F)`` numpy,
    the PSD averaged over trials, ``"ica": ops.ica.ICAResult}`` of the
    trials end to end, ``(N T, C)``, centred, on x's device and dtype."""
    from ..data.constants import SFREQ
    from ..ops.ica import fast_ica
    from ..ops.spectral import welch_psd

    freqs, pxx = welch_psd(x, fs=SFREQ, nperseg=min(256, x.shape[-1]))
    cont = x.transpose(0, 1).reshape(x.shape[1], -1).T
    ica = fast_ica(cont - cont.mean(0), n_components, seed=seed, max_iter=500)
    return {"freqs": freqs, "pxx": pxx.mean(0).cpu().numpy(), "ica": ica}


def draw(out: str, arrays: dict, fmin: float, fmax: float, n_trials: int) -> None:
    """The three plots of the module docstring."""
    from ..data.constants import SFREQ, Electrodes
    from ..explain.topomap import plot_topomap, pyplot

    plt = pyplot()
    freqs, pxx = arrays["freqs"], arrays["pxx"]
    n_ch = pxx.shape[0]
    sel = (freqs >= fmin) & (freqs <= fmax)
    fig, ax = plt.subplots(figsize=(10, 5))
    for c in range(n_ch):
        ax.semilogy(freqs[sel], pxx[c, sel], lw=0.5, alpha=0.5)
    ax.semilogy(freqs[sel], pxx[:, sel].mean(0), "k", lw=2, label="mean")
    ax.set_xlabel("Frequency (Hz)")
    ax.set_ylabel("PSD (V²/Hz)")
    ax.set_title(f"Welch PSD, {n_trials} trials x {n_ch} channels")
    ax.legend()
    fig.tight_layout()
    fig.savefig(f"{out}/psd.png", dpi=120)
    plt.close(fig)

    mixing = arrays["ica"].mixing.cpu().numpy()
    sources = arrays["ica"].sources.cpu().numpy()
    k = mixing.shape[1]
    cols = 5
    rows = -(-k // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows))
    for i in range(rows * cols):
        ax = axes.flat[i]
        if i < k:
            plot_topomap(mixing[:, i], Electrodes[:n_ch], ax=ax, title=f"IC{i}")
        else:
            ax.axis("off")
    fig.suptitle("ICA component topographies")
    fig.savefig(f"{out}/ica_components.png", dpi=110)
    plt.close(fig)

    span = min(10 * int(SFREQ), sources.shape[0])
    fig, ax = plt.subplots(figsize=(12, 8))
    t = np.arange(span) / SFREQ
    for i in range(k):
        s = sources[:span, i]
        ax.plot(t, s / (np.abs(s).max() or 1) + 2.2 * i, lw=0.4)
    ax.set_yticks(2.2 * np.arange(k))
    ax.set_yticklabels([f"IC{i}" for i in range(k)])
    ax.set_xlabel("Time (s)")
    ax.set_title("ICA source time courses")
    fig.tight_layout()
    fig.savefig(f"{out}/ica_sources.png", dpi=110)
    plt.close(fig)


def main(argv=None, device="cuda"):
    args = build_parser().parse_args(argv)

    import torch

    from ..devices import require_device
    from .explain_fast import matplotlib_missing

    device = require_device(device)
    if args.synthetic or not args.cache:
        from ..data.synthetic import synthetic_trials

        x, _ = synthetic_trials(args.seed, args.n_trials, 64, 800)
    else:
        from ..data.cache import load_standardized_h5

        X, _ = load_standardized_h5(args.cache)
        x = X[args.subject]
    out = args.output_dir
    os.makedirs(out, exist_ok=True)
    arrays = qc_arrays(torch.as_tensor(np.asarray(x), device=device), args.n_components,
                       args.seed)
    np.savez(f"{out}/psd.npz", freqs=arrays["freqs"], pxx=arrays["pxx"])
    if not matplotlib_missing():
        draw(out, arrays, args.fmin, args.fmax, len(x))
    print(f"artifact analysis written to {out}")
    return out


if __name__ == "__main__":
    main()
