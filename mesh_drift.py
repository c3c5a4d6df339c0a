#!/usr/bin/env python3
"""How far a sound run under ``--mesh data`` moves from the unsharded run,
and how far runs with a known sharding fault move: the readings that set
the best-val_acc bound of ``chip_smoke.py`` section 13.

    python3 mesh_drift.py [--json PATH]   # on a machine with a card

Runs ``cli.train_fast --synthetic 15 --synthetic_trials 350 --epochs 2``
(75 stacked models, full width, batch 64; section 13's runs) once
unsharded in this process and then under ``--mesh data`` on two ranks
that share the card over gloo, in bf16 and in f32, as the port runs it
(``sound``) and with one fault put in both ranks for the run by
patching the loaded port (no file changes):

  * ``local_dropout``: every rank draws its dropout masks at its own
    shape, not at the whole batch's (``SharedRowsGenerator.set_batch``
    ignored), so both halves of a batch take the same masks;
  * ``rank_order``: rank 1 draws its own epoch permutations (one draw
    ahead of rank 0's), so the two halves of a batch come from different
    orders: some trials are seen twice in an epoch, others not at all.

For each run it prints the largest |delta| of the loss and val_loss
history rows, whether they pass section 13's bounds for ``data`` (rtol
1e-3, atol 1e-5), whether the two ranks' histories are equal, and of the
best val_acc of the 75 models: how many moved (by half a validation trial
or more), the largest move and the mean, in validation trials (70 a
fold). Prints the card's name and power limit first. Exits non-zero
without a card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SUBJECTS, TRIALS, EPOCHS = 15, 350, 2
VAL = TRIALS // 5  # validation trials a fold
RANKS = 2
RUNS = tuple((fault, precision) for precision in ("bf16", "f32")
             for fault in ("sound", "local_dropout", "rank_order"))
RTOL, ATOL = 1e-3, 1e-5  # chip_smoke.py's MESH_LOSS_TOL["data"]
CHILD = "--rank"
TIMEOUT_S = 900


def cli_argv(precision: str, out: str, mesh: bool) -> list:
    argv = ["--synthetic", str(SUBJECTS), "--synthetic_trials", str(TRIALS),
            "--epochs", str(EPOCHS), "--precision", precision, "--output_dir", out]
    return argv + (["--mesh", "data"] if mesh else [])


def use_corpus(train_fast, src: str) -> None:
    """The CLI reads the corpus saved in ``src`` instead of making it."""
    X, Y = np.load(os.path.join(src, "X.npy")), np.load(os.path.join(src, "Y.npy"))
    subjects = [f"{i + 1:02d}" for i in range(X.shape[0])]
    n_test = X.shape[1] // 3
    train_fast.load_data = lambda args: (
        X, Y, subjects, {sid: (X[i, :n_test], Y[i, :n_test]) for i, sid in enumerate(subjects)})


@contextlib.contextmanager
def fault(name: str, rank: int):
    """The port with fault ``name`` in it, for the block."""
    from imagined_speech_decoding_tpu_torch.models.modules import SharedRowsGenerator
    from imagined_speech_decoding_tpu_torch.train import engine

    kept = SharedRowsGenerator.set_batch, engine.epoch_permutations
    if name == "local_dropout":
        def set_batch(self, batch):
            self.batch, self._draw = None, 0

        SharedRowsGenerator.set_batch = set_batch
    elif name == "rank_order" and rank == 1:
        def epoch_permutations(gen, m, n):
            kept[1](gen, m, n)
            return kept[1](gen, m, n)

        engine.epoch_permutations = epoch_permutations
    try:
        yield
    finally:
        SharedRowsGenerator.set_batch, engine.epoch_permutations = kept


def rank_main(src: str, rank: int) -> None:
    """One of the two ranks: every run of ``RUNS``, its history and best
    val_acc written to ``rank<r>.json``."""
    import torch

    from imagined_speech_decoding_tpu_torch.cli import train_fast
    from imagined_speech_decoding_tpu_torch.parallel.mesh import init_world

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_world("cuda", backend="gloo")
    use_corpus(train_fast, src)
    rows = {}
    for name, precision in RUNS:
        with fault(name, rank):
            res = train_fast.main(cli_argv(precision, os.path.join(src, f"{name}_{precision}"),
                                           True))
        rows[f"{name} {precision}"] = {
            "history": {k: v.tolist() for k, v in res.fit.history.items()},
            "best_val_acc": res.fit.best_val_acc.tolist()}
    with open(os.path.join(src, f"rank{rank}.json"), "w") as f:
        json.dump(rows, f)


def run_ranks(src: str) -> list:
    from imagined_speech_decoding_tpu_torch.parallel.mesh import free_port

    port = str(free_port())
    procs = []
    try:
        for r in range(RANKS):
            log = open(os.path.join(src, f"rank{r}.log"), "w")
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), CHILD, src, str(r)],
                stdout=log, stderr=subprocess.STDOUT,
                env=dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(RANKS),
                         MASTER_ADDR="localhost", MASTER_PORT=port)))
            log.close()
        deadline = time.perf_counter() + TIMEOUT_S
        while any(p.poll() is None for p in procs):
            if time.perf_counter() > deadline or any(p.poll() for p in procs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if any(p.returncode for p in procs):
        for r in range(RANKS):
            with open(os.path.join(src, f"rank{r}.log")) as f:
                print(f"rank {r} ({procs[r].returncode}):\n{f.read()[-3000:]}", file=sys.stderr)
        raise SystemExit("a rank failed")
    out = []
    for r in range(RANKS):
        with open(os.path.join(src, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=None, help="also write the readings here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("mesh_drift.py needs a CUDA GPU: torch.cuda.is_available() is false")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from imagined_speech_decoding_tpu_torch.cli import train_fast
    from imagined_speech_decoding_tpu_torch.data.synthetic import synthetic_corpus
    from imagined_speech_decoding_tpu_torch.ops.cuda import _lib

    _lib.library()  # built once here, before the ranks start
    X, Y = synthetic_corpus(0, SUBJECTS, TRIALS, 64, 800)  # cli.train_fast's corpus
    readings = {}
    with tempfile.TemporaryDirectory() as src:
        np.save(os.path.join(src, "X.npy"), X)
        np.save(os.path.join(src, "Y.npy"), Y)
        use_corpus(train_fast, src)
        ref = {p: train_fast.main(cli_argv(p, os.path.join(src, f"unsharded_{p}"), False)).fit
               for p in ("bf16", "f32")}
        t0 = time.perf_counter()
        ranks = run_ranks(src)
        print(f"{len(RUNS)} runs on {RANKS} ranks in {time.perf_counter() - t0:.1f} s (wall)",
              flush=True)
    for name, precision in RUNS:
        key = f"{name} {precision}"
        row = ranks[0][key]
        hist = {k: np.asarray(v) for k, v in row["history"].items()}
        deltas = {k: float(np.max(np.abs(hist[k] - ref[precision].history[k])))
                  for k in ("loss", "val_loss")}
        loss_ok = all(np.allclose(hist[k], ref[precision].history[k], rtol=RTOL, atol=ATOL)
                      for k in ("loss", "val_loss"))
        flips = np.abs(np.asarray(row["best_val_acc"]) - ref[precision].best_val_acc) * VAL
        readings[key] = {**deltas, "loss_bounds_pass": bool(loss_ok),
                         "ranks_equal": ranks[1][key]["history"] == row["history"],
                         "models_moved": int((flips > 0.5).sum()),
                         "flips_max": float(flips.max()), "flips_mean": float(flips.mean())}
        r = readings[key]
        print(f"--mesh data --precision {precision}, {name}: max |delta| loss {r['loss']:.3g}, "
              f"val_loss {r['val_loss']:.3g} (bounds {'pass' if loss_ok else 'FAIL'}); ranks "
              f"{'equal' if r['ranks_equal'] else 'DIFFER'}; best val_acc moved in "
              f"{r['models_moved']} of {len(flips)} models, by {r['flips_max']:.0f} validation "
              f"trials at most, {r['flips_mean']:.3f} on average", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": smi.splitlines()[0], "readings": readings}, f, indent=1)


if __name__ == "__main__":
    if sys.argv[1:2] == [CHILD]:
        rank_main(sys.argv[2], int(sys.argv[3]))
    else:
        main()
