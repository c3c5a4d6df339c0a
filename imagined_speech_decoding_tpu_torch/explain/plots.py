"""Attribution plots: electrode x time heatmaps, zone bars, class-average
topomaps, zone x time and band x time heatmaps.

Counterpart of ``imagined_speech_decoding_tpu/explain/plots.py``, drawn
from the port's attributions (``explain.attribution``). Every drawing
function imports matplotlib itself, so importing this module needs none.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .topomap import plot_topomap, pyplot


def _ensure_dir(path: str):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)


def symmetric_vlim(values: np.ndarray, pct: float = 99.0) -> Tuple[float, float]:
    """Global symmetric color scale at the given percentile of |values|
    (reference ``scripts/explain_fast.py:404-420``)."""
    m = float(np.percentile(np.abs(values), pct)) or 1.0
    return -m, m


def plot_attribution_heatmap(
    path: str,
    attr: np.ndarray,  # (C, T)
    electrode_names: Sequence[str],
    sfreq: float = 250.0,
    vlim: Optional[Tuple[float, float]] = None,
    title: str = "Attribution (electrode x time)",
) -> str:
    _ensure_dir(path)
    plt = pyplot()
    if vlim is None:
        vlim = symmetric_vlim(attr)
    fig, ax = plt.subplots(figsize=(10, 8))
    im = ax.imshow(
        attr, aspect="auto", cmap="RdBu_r", vmin=vlim[0], vmax=vlim[1],
        extent=(0, attr.shape[1] / sfreq, attr.shape[0], 0),
    )
    ax.set_xlabel("Time (s)")
    ax.set_ylabel("Electrode")
    step = max(1, len(electrode_names) // 32)
    ax.set_yticks(np.arange(0, len(electrode_names), step) + 0.5)
    ax.set_yticklabels([electrode_names[i] for i in range(0, len(electrode_names), step)], fontsize=5)
    ax.set_title(title)
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_zone_importance(
    path: str,
    zone_values: np.ndarray,  # (Z,)
    zone_names: Sequence[str],
    title: str = "Net zone influence",
) -> str:
    """Per-zone net-influence bars (reference ``plot_zone_importance``,
    ``scripts/explain_fast.py:351-402``)."""
    _ensure_dir(path)
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(8, 4.5))
    colors = ["tab:red" if v >= 0 else "tab:blue" for v in zone_values]
    ax.bar(list(zone_names), zone_values, color=colors, edgecolor="black")
    ax.axhline(0, color="k", lw=0.8)
    ax.set_ylabel("Mean attribution")
    ax.set_title(title)
    plt.setp(ax.get_xticklabels(), rotation=30, ha="right")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_class_topomaps(
    path: str,
    per_class_values: Dict[str, np.ndarray],  # class name -> (C,)
    electrode_names: Sequence[str],
    title: str = "Mean attribution per class",
    pct: float = 99.0,
) -> str:
    """One topomap per class on a shared symmetric scale (reference
    class-conditional averages, ``scripts/explain_fast.py:208-348``)."""
    _ensure_dir(path)
    plt = pyplot()
    all_vals = np.stack(list(per_class_values.values()))
    vlim = symmetric_vlim(all_vals, pct)
    n = len(per_class_values)
    fig, axes = plt.subplots(1, n, figsize=(3.2 * n, 3.6))
    if n == 1:
        axes = [axes]
    im = None
    for ax, (cname, vals) in zip(axes, per_class_values.items()):
        _, im = plot_topomap(vals, electrode_names, ax=ax, vlim=vlim, title=cname)
    fig.suptitle(title)
    if im is not None:
        fig.colorbar(im, ax=axes, shrink=0.6)
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_zone_time_heatmap(
    path: str,
    zone_time: np.ndarray,  # (Z, T)
    zone_names: Sequence[str],
    sfreq: float = 250.0,
    title: str = "Zone x time attribution",
) -> str:
    """Zone x time matrix (reference ``compute_zone_time_matrix`` /
    ``plot_zone_time_heatmap``, ``scripts/global_shap_analysis.py:231-258``)."""
    _ensure_dir(path)
    plt = pyplot()
    vlim = symmetric_vlim(zone_time)
    fig, ax = plt.subplots(figsize=(10, 4.5))
    im = ax.imshow(
        zone_time, aspect="auto", cmap="RdBu_r", vmin=vlim[0], vmax=vlim[1],
        extent=(0, zone_time.shape[1] / sfreq, zone_time.shape[0], 0),
    )
    ax.set_yticks(np.arange(len(zone_names)) + 0.5)
    ax.set_yticklabels(zone_names, fontsize=8)
    ax.set_xlabel("Time (s)")
    ax.set_title(title)
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_band_heatmap(
    path: str,
    band_time: np.ndarray,  # (n_bands, n_frames)
    band_names: Sequence[str],
    frame_times: np.ndarray,
    title: str = "Frequency-band attribution energy",
) -> str:
    """Band x time |STFT| heatmap of an attribution time course
    (reference ``plot_frequency_band_heatmap``,
    ``scripts/global_shap_analysis.py:120-174``)."""
    _ensure_dir(path)
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(10, 4))
    im = ax.imshow(
        band_time, aspect="auto", cmap="viridis", origin="lower",
        extent=(float(frame_times[0]), float(frame_times[-1]), 0, len(band_names)),
    )
    ax.set_yticks(np.arange(len(band_names)) + 0.5)
    ax.set_yticklabels(band_names)
    ax.set_xlabel("Time (s)")
    ax.set_title(title)
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
