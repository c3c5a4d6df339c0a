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
as an empty field. The learning-curve and per-subject accuracy plots
need matplotlib, which the port does not depend on; they are left out
(ROADMAP.md).
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
