"""Shared pieces of the kernel timing scripts (``b2f_timing.py``,
``b2w_timing.py``, ``b2x_timing.py``, ``iir_timing.py``): each times a
kernel of the package that sits beside it by two yardsticks read on the
same calls, so that two checkouts of the repository can be compared on
one card (copy the script and this file into the other checkout):
- ``event_ms``: CUDA events around back-to-back calls, per call (the
  host's time between calls included when it is longer than the kernel's);
- ``device_ms``: the profiler's device time per call of the kernels whose
  name matches a pattern, and their count per call.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

FULL_WIDTH = "full width (C = 64, T = 800, 5 windows of 250 step 125, 8 zones, O = 32, K = 5)"


def start(doc: str, script: str, extra=()):
    """Parses ``--label`` (and ``extra``: ``(flag, kwargs)`` pairs), exits
    non-zero without a card, and prints the card's name and power limit."""
    parser = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    parser.add_argument("--label", default="this checkout")
    for flag, kwargs in extra:
        parser.add_argument(flag, **kwargs)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit(f"{script} needs a CUDA GPU: torch.cuda.is_available() is false")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return args


def event_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    begin.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return begin.elapsed_time(end) / iters


def device_ms(fn, iters: int, pattern=None):
    """Device time per call of the kernels whose name matches ``pattern``
    (every kernel and copy when None), and their count per call."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type != DeviceType.CPU
              and (pattern is None or re.search(pattern, e.key))]
    return (sum(e.self_device_time_total for e in events) / 1e3 / iters,
            sum(e.count for e in events) / iters)


def head_operands(m: int, b: int, dev, rng, dtype=torch.float32):
    """The default config, its window geometry, and at full width the
    fused head weights of M FAST models (seed 0) and x ``(M, B, 64, T)``
    normal from ``rng``, in ``dtype``."""
    from imagined_speech_decoding_tpu_torch.config import FASTConfig
    from imagined_speech_decoding_tpu_torch.models.fast import FAST
    from imagined_speech_decoding_tpu_torch.transplant import from_jax_params, init_jax_layout_params

    cfg = FASTConfig.default()
    model = FAST(cfg, n_models=m, device=dev)
    model.load_state_dict(from_jax_params(init_jax_layout_params(cfg, 0, m)))
    with torch.no_grad():
        ops = model.head.fused_weights()
    x = torch.tensor(rng.normal(size=(m, b, 64, cfg.seq_len)).astype(np.float32), device=dev)
    return cfg, (cfg.window_len, cfg.slide_step), ops, x.to(dtype)


def phase_split(launch, names, warps: int, units: int) -> dict:
    """One launch of a debug instantiation, ``launch(clk)``, whose
    ``clock64()`` counters (one per phase in ``names``, then every block's
    cycles and nanoseconds) it adds to ``clk``: cycles per warp and unit by
    phase, the SM clock, and a unit's cycles and microseconds on one SM."""
    clk = torch.zeros(len(names) + 2, dtype=torch.int64, device="cuda")
    with torch.no_grad():
        launch(clk)
    torch.cuda.synchronize()
    c = clk.tolist()
    mhz = 1e3 * c[-2] / c[-1]
    return {"mhz": mhz, "unit_cycles": c[-2] / units, "unit_us": c[-2] / units / mhz,
            "phase_cycles": {name: c[i] / warps / units for i, name in enumerate(names)}}


def print_phases(ph: dict, unit: str) -> None:
    print(f"    phases at {ph['mhz']:.0f} MHz, {ph['unit_cycles']:.0f} cycles "
          f"({ph['unit_us']:.2f} us) a{'n' if unit[0] in 'aeiou' else ''} {unit}; cycles a warp "
          f"and {unit}: " + json.dumps({k: round(v) for k, v in ph["phase_cycles"].items()}),
          flush=True)


def finish(label: str, rows: list) -> None:
    print(json.dumps({"label": label, "rows": rows}), flush=True)
