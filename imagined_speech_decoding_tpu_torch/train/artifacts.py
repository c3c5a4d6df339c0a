"""Result artifacts as CSV files, with the ``csv`` module and numpy.

Counterpart of the CSV half of ``imagined_speech_decoding_tpu/train/
artifacts.py`` (which writes them with pandas). The result tree::

    <output_dir>/
      sub-XX/fold-k_history.csv     Epoch,loss,acc,val_loss,val_acc
      sub-XX/fold_metrics.csv       Fold,Best_Val_Acc
      sub-XX/test_predictions.csv   Predicted,True rows on the test split
      sub-XX/best_subject.npz       best-fold model weights (train.checkpoint)
      summary_per_subject.csv       Subject,Best_Val_Acc,Test_Acc,Test_F1
      global_test_predictions.csv   all subjects' test predictions

Floats are written as pandas writes them: shortest round-trip text, NaN
as an empty field. The learning-curve plots need matplotlib, which the
port does not depend on; they are left out (ROADMAP.md). The per-subject
accuracy bar is drawn when matplotlib imports (``plot_subject_accuracy_bar``).
"""

from __future__ import annotations

import csv
import math
import os
from typing import Dict, Sequence

import numpy as np


def _cell(v) -> str:
    if isinstance(v, str):
        return v
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    # str of a numpy float is the shortest text that round-trips its own width
    return "" if math.isnan(v) else str(v)


def write_csv(path: str, header: Sequence[str], rows: Sequence[Sequence]) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(header)
        writer.writerows([_cell(v) for v in row] for row in rows)
    return path


def save_history_csv(path: str, history: Dict[str, np.ndarray]) -> str:
    """Per-epoch history -> CSV with an ``Epoch`` index column."""
    cols = {k: np.asarray(v) for k, v in history.items()}
    n = min(len(v) for v in cols.values())
    rows = [[e] + [cols[k][e] for k in cols] for e in range(n)]
    return write_csv(path, ["Epoch", *cols], rows)


def save_predictions_csv(path: str, y_pred: np.ndarray, y_true: np.ndarray) -> str:
    """``Predicted,True`` integer rows, in ``np.savetxt``'s format (a
    ``# `` header line), as the JAX package writes them."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savetxt(path, np.array([y_pred, y_true]).T, delimiter=",", fmt="%d",
               header="Predicted,True")
    return path


def load_predictions_csv(path: str):
    arr = np.atleast_2d(np.loadtxt(path, delimiter=",", skiprows=1, dtype=int))
    return arr[:, 0], arr[:, 1]


def plot_subject_accuracy_bar(path: str, subjects: Sequence[str], accuracies: Sequence[float],
                              title: str = "Test Accuracy per Subject (Finetune CV)"):
    """The JAX package's per-subject bar chart with a mean line; returns
    ``path``, or None (nothing written) when matplotlib does not import."""
    try:
        from matplotlib.figure import Figure
    except ImportError:
        return None
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    accs = np.asarray(accuracies, dtype=float)
    fig = Figure(figsize=(12, 6))
    ax = fig.add_subplot(1, 1, 1)
    bars = ax.bar(list(subjects), accs, color="skyblue", edgecolor="black")
    mean_acc = float(np.nanmean(accs)) if len(accs) else 0.0
    ax.axhline(y=mean_acc, color="red", linestyle="--", linewidth=2, label=f"Mean: {mean_acc:.4f}")
    for bar in bars:
        height = bar.get_height()
        ax.text(bar.get_x() + bar.get_width() / 2, height, f"{height:.2f}", ha="center",
                va="bottom", fontsize=9)
    ax.set_title(title, fontsize=14)
    ax.set_xlabel("Subject ID", fontsize=12)
    ax.set_ylabel("Accuracy", fontsize=12)
    top = max(float(np.nanmax(accs)) if len(accs) else 0.0, mean_acc)
    ax.set_ylim(0, max(top * 1.15, 0.01))
    ax.legend()
    fig.tight_layout()
    fig.savefig(path)
    return path
