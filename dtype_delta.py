#!/usr/bin/env python3
"""The accuracy cost of bf16 training in the PyTorch port: twin campaigns
that differ only in ``--precision``.

    python3 dtype_delta.py [--epochs 200] [--json PATH]   # on a machine with a card

Runs the port's training CLI (``cli/train_fast.py``) twice in this
process, as ``experiments/dtype_campaign.py`` runs the JAX package's:
``--synthetic 15 --synthetic_trials 350 --epochs 200 --label_noise 0.25
--seed 42``, once with ``--precision bf16`` and once with ``--precision
f32``, so the corpus, label flips, folds, initial weights and batches are
the same and only the compute dtype differs (75 stacked models, full
width, batch 64). Prints the card's name and power limit, each campaign's
wall time and fit time (host clock), the per-subject test and best
validation accuracies with their deltas (bf16 - f32), and the mean and
largest |delta| of the test accuracy; with ``--json``, writes them too.
Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from imagined_speech_decoding_tpu_torch.cli import train_fast


def campaign(precision: str, epochs: int, out_dir: str):
    argv = ["--synthetic", "15", "--synthetic_trials", "350", "--epochs", str(epochs),
            "--precision", precision, "--label_noise", "0.25", "--seed", "42",
            "--output_dir", out_dir]
    print(f"[dtype_delta] {precision}: cli.train_fast {' '.join(argv[:-1])} <tmp>", flush=True)
    t0 = time.perf_counter()
    result = train_fast.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = {row["Subject"]: row for row in result.summary}
    return rows, wall, result.timings


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--epochs", type=int, default=200)
    parser.add_argument("--json", type=str, default=None, help="write the results here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("dtype_delta.py needs a CUDA GPU: torch.cuda.is_available() is false")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for precision in ("bf16", "f32"):
            runs[precision] = campaign(precision, args.epochs, os.path.join(tmp, precision))
    (bf, wall_bf, t_bf), (f32, wall_f32, t_f32) = runs["bf16"], runs["f32"]
    print(f"{'subject':>8} {'bf16 test':>10} {'f32 test':>10} {'d test':>8} "
          f"{'bf16 val':>10} {'f32 val':>10} {'d val':>8}")
    per_subject, deltas = [], []
    for sid in bf:
        d_test = bf[sid]["Test_Acc"] - f32[sid]["Test_Acc"]
        d_val = bf[sid]["Best_Val_Acc"] - f32[sid]["Best_Val_Acc"]
        deltas.append(d_test)
        per_subject.append({"subject": sid, "bf16_test": bf[sid]["Test_Acc"],
                            "f32_test": f32[sid]["Test_Acc"], "delta_test": d_test,
                            "bf16_val": bf[sid]["Best_Val_Acc"],
                            "f32_val": f32[sid]["Best_Val_Acc"], "delta_val": d_val})
        print(f"{sid:>8} {bf[sid]['Test_Acc']:>10.4f} {f32[sid]['Test_Acc']:>10.4f} "
              f"{d_test:>+8.4f} {bf[sid]['Best_Val_Acc']:>10.4f} "
              f"{f32[sid]['Best_Val_Acc']:>10.4f} {d_val:>+8.4f}")
    summary = {
        "card": card, "epochs": args.epochs,
        "mean_test_acc": {"bf16": float(np.mean([r["bf16_test"] for r in per_subject])),
                          "f32": float(np.mean([r["f32_test"] for r in per_subject]))},
        "mean_delta_test": float(np.mean(deltas)),
        "max_abs_delta_test": float(np.max(np.abs(deltas))),
        "wall_s": {"bf16": wall_bf, "f32": wall_f32},
        "fit_s": {"bf16": t_bf["fit_s"], "f32": t_f32["fit_s"]},
        "corpus_s": {"bf16": t_bf["data_s"], "f32": t_f32["data_s"]},
        "per_subject": per_subject,
    }
    print(f"mean test acc bf16 {summary['mean_test_acc']['bf16']:.4f}, f32 "
          f"{summary['mean_test_acc']['f32']:.4f}; mean delta {summary['mean_delta_test']:+.4f}, "
          f"max |delta| {summary['max_abs_delta_test']:.4f}", flush=True)
    print(f"wall (host clock, corpus and artifacts included): bf16 {wall_bf:.1f} s, f32 "
          f"{wall_f32:.1f} s; fit: bf16 {t_bf['fit_s']:.1f} s, f32 {t_f32['fit_s']:.1f} s",
          flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)


if __name__ == "__main__":
    sys.exit(main())
