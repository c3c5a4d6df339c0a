"""Benchmark CLI: aggregate result trees into metric tables.

Counterpart of ``imagined_speech_decoding_tpu/cli/benchmark.py`` with the
same parser and output, without pandas: it scans
``<results_dir>/<model>/sub-*/test_predictions.csv`` (and the global
predictions file), computes per-subject and global accuracy, macro F1,
precision and recall, and writes ``<model>_Subject_Metrics.csv`` and
``Model_Summary.csv`` as pandas writes them (``train.artifacts.write_csv``).
Without the global file the global metrics are the means over subjects;
a one-sided t-test of the subjects' accuracies against chance is added.

    python -m imagined_speech_decoding_tpu_torch.cli.benchmark \\
        --results_dir results/finetune_official [--models FAST]

Its work is a few hundred labels a model, counted on the host with
CPU tensors: it needs no device, and takes none.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

SUBJECT_COLUMNS = ("Subject", "Accuracy", "F1", "Precision", "Recall")
SUMMARY_COLUMNS = ("Model", "Acc_Mean", "Acc_Std", "F1_Mean", "F1_Std", "Global_Acc",
                   "Global_F1", "Global_Precision", "Global_Recall", "TTest_vs_Chance",
                   "P_Value_OneSided")


def load_subject_predictions(results_dir: str,
                             model: str) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """``{subject: (pred, true)}`` from the per-subject prediction CSVs."""
    from ..train.artifacts import load_predictions_csv

    out = {}
    for sub_dir in sorted(glob.glob(os.path.join(results_dir, model, "sub-*"))):
        path = os.path.join(sub_dir, "test_predictions.csv")
        if os.path.exists(path):
            sid = os.path.basename(sub_dir).replace("sub-", "")
            out[sid] = load_predictions_csv(path)
    return out


def load_global_predictions(results_dir: str,
                            model: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    from ..train.artifacts import load_predictions_csv

    path = os.path.join(results_dir, model, "global_test_predictions.csv")
    return load_predictions_csv(path) if os.path.exists(path) else None


def _metrics(pred: np.ndarray, true: np.ndarray, n_classes: int) -> Dict[str, float]:
    import torch

    from ..train.metrics import confusion_matrix, f1_from_confusion, precision_recall_from_confusion

    cm = confusion_matrix(torch.as_tensor(pred), torch.as_tensor(true), n_classes)
    prec, rec = precision_recall_from_confusion(cm)
    return {
        "Accuracy": float(np.trace(cm.numpy()) / max(len(true), 1)),
        "F1": float(f1_from_confusion(cm)),
        "Precision": float(prec),
        "Recall": float(rec),
    }


def process_results(results_dir: str, model: str, n_classes: int = 5,
                    chance: float = 0.2) -> Tuple[List[Dict], Dict[str, object]]:
    """The per-subject metric rows and the global summary of one model."""
    from ..train.metrics import ttest_vs_chance

    per_subject = load_subject_predictions(results_dir, model)
    if not per_subject:
        raise FileNotFoundError(f"no predictions under {results_dir}/{model}/sub-*/")

    rows = [{"Subject": sid, **_metrics(pred, true, n_classes)}
            for sid, (pred, true) in per_subject.items()]
    column = {k: np.array([r[k] for r in rows], np.float64)
              for k in ("Accuracy", "F1", "Precision", "Recall")}

    glob_preds = load_global_predictions(results_dir, model)
    if glob_preds is not None:
        global_metrics = _metrics(glob_preds[0], glob_preds[1], n_classes)
    else:  # the mean over subjects
        global_metrics = {k: float(v.mean()) for k, v in column.items()}

    accs = column["Accuracy"]
    t_stat, p_val = ttest_vs_chance(accs, chance) if len(accs) > 1 else (np.nan, np.nan)
    f1 = column["F1"]
    summary = {
        "Model": model,
        "Acc_Mean": float(accs.mean()),
        "Acc_Std": float(accs.std()),
        "F1_Mean": float(f1.mean()),
        "F1_Std": float(f1.std(ddof=1)) if len(f1) > 1 else float("nan"),
        "Global_Acc": global_metrics["Accuracy"],
        "Global_F1": global_metrics["F1"],
        "Global_Precision": global_metrics["Precision"],
        "Global_Recall": global_metrics["Recall"],
        "TTest_vs_Chance": float(t_stat),
        "P_Value_OneSided": float(p_val),
    }
    return rows, summary


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Aggregate benchmark metrics")
    p.add_argument("--results_dir", type=str, default="results/finetune_official")
    p.add_argument("--models", type=str, nargs="*", default=None,
                   help="model subdirs to process (default: all)")
    p.add_argument("--n_classes", type=int, default=5)
    p.add_argument("--chance", type=float, default=0.2)
    return p


def main(argv=None):
    from ..train.artifacts import write_csv

    args = build_parser().parse_args(argv)
    models = args.models or [
        os.path.basename(d)
        for d in sorted(glob.glob(os.path.join(args.results_dir, "*")))
        if os.path.isdir(d)
    ]
    summaries = []
    for model in models:
        try:
            rows, summary = process_results(args.results_dir, model, args.n_classes, args.chance)
        except FileNotFoundError as e:
            print(f"[skip] {model}: {e}")
            continue
        write_csv(os.path.join(args.results_dir, f"{model}_Subject_Metrics.csv"),
                  SUBJECT_COLUMNS, [[r[c] for c in SUBJECT_COLUMNS] for r in rows])
        print(f"{model}: mean acc {summary['Acc_Mean']:.4f} ± {summary['Acc_Std']:.4f} "
              f"(global {summary['Global_Acc']:.4f}, p={summary['P_Value_OneSided']:.2e})")
        summaries.append(summary)

    if summaries:
        write_csv(os.path.join(args.results_dir, "Model_Summary.csv"), SUMMARY_COLUMNS,
                  [[s[c] for c in SUMMARY_COLUMNS] for s in summaries])
        print(f"summary written: {args.results_dir}/Model_Summary.csv")
    return summaries


if __name__ == "__main__":
    main()
