#!/usr/bin/env python3
"""Times kernel B2w-bf16 (the bf16 Conv4Layers head's weight gradients,
the default training step's largest kernel) of the package that sits
beside this script, by two yardsticks and by phase, so that two checkouts
of the repository can be compared on one card:

    python3 b2w_timing.py --label new               # from a checkout's root, on a card
    python3 other/b2w_timing.py --label old         # a copy of this file in another checkout

Work: ``ops.cuda.conv4head.conv4head_bwd_w`` on a bf16 x at full width
(C = 64, T = 800, 5 windows of 250 step 125, 8 zones, O = 32, K = 5; FAST
weights from seed 0, x and the cotangent g normal from numpy seed 0) for
(M, B) = (75, 64) (a training step's batch), (75, 24) (its ragged tail),
(75, 35) (a validation batch) and (1, 64). Both yardsticks are read on the
same calls:
- ``event_ms``: CUDA events around back-to-back wrapper calls, per call;
- ``device_ms``: the profiler's device time per call of the kernel and its
  partial pass (``conv4head_bwd_w_bf16_kernel``, ``sum_partials_kernel``).
``us_per_unit`` is event_ms spread over the card's SMs per (trial, window,
zone) unit, the time one unit takes on one SM.

Then, where the checkout has the debug instantiation
(``conv4head._launch_bwd_w(..., clk=...)``), one launch of it at M = 75,
B = 64 splits a unit's cycles by phase (``BWD_W_BF16_PHASES``: each
phase's clock64() cycles per warp and unit, barriers apart) and reads the
SM clock from the blocks' cycles over their nanoseconds.

Prints the card's name and power limit, one line per row, and as the last
line a JSON object of the rows. Exits non-zero without a card.
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

from imagined_speech_decoding_tpu_torch.config import FASTConfig  # noqa: E402
from imagined_speech_decoding_tpu_torch.models.fast import FAST  # noqa: E402
from imagined_speech_decoding_tpu_torch.ops.cuda import conv4head  # noqa: E402
from imagined_speech_decoding_tpu_torch.transplant import (  # noqa: E402
    from_jax_params,
    init_jax_layout_params,
)

ITERS = 10
SHAPES = ((75, 64), (75, 24), (75, 35), (1, 64))
KERNELS = "conv4head_bwd_w_bf16_kernel|sum_partials_kernel"
WARPS = 16  # a B2w-bf16 block


def event_ms(fn, iters: int = ITERS) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = ITERS) -> float:
    """Device time per call of the kernels whose name matches ``KERNELS``."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type != DeviceType.CPU and re.search(KERNELS, e.key)) / 1e3 / iters


def phase_split(g, x, ops, geo, units: int) -> dict:
    """One launch of the debug instantiation: cycles per warp and unit by
    phase, the SM clock, and the unit's cycles and microseconds."""
    names = conv4head.BWD_W_BF16_PHASES
    clk = torch.zeros(len(names) + 2, dtype=torch.int64, device=x.device)
    conv4head._launch_bwd_w(g, x, *ops, *geo, clk=clk)
    torch.cuda.synchronize()
    c = clk.tolist()
    mhz = 1e3 * c[-2] / c[-1]
    phases = {name: c[i] / WARPS / units for i, name in enumerate(names)}
    return {"mhz": mhz, "unit_cycles": c[-2] / units, "unit_us": c[-2] / units / mhz,
            "phase_cycles": phases}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--label", default="this checkout")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("b2w_timing.py needs a CUDA GPU: torch.cuda.is_available() is false")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cfg = FASTConfig.default()
    geo = (cfg.window_len, cfg.slide_step)
    rng = np.random.default_rng(0)
    rows = []
    for m, b in SHAPES:
        model = FAST(cfg, n_models=m, device=dev)
        model.load_state_dict(from_jax_params(init_jax_layout_params(cfg, 0, m)))
        with torch.no_grad():
            ops = model.head.fused_weights()
        x = torch.tensor(rng.normal(size=(m, b, 64, cfg.seq_len)).astype(np.float32),
                         device=dev).to(torch.bfloat16)
        g = torch.tensor(rng.normal(size=(m, b, cfg.n_tokens, 256)).astype(np.float32),
                         device=dev)
        fn = lambda: conv4head.conv4head_bwd_w(g, x, *ops, *geo)  # noqa: E731
        units = m * b * cfg.n_tokens * cfg.n_zones
        row = {"m": m, "b": b, "event_ms": event_ms(fn), "device_ms": device_ms(fn)}
        row["us_per_unit"] = 1e3 * row["event_ms"] * sms / units
        print(f"[{args.label}] B2w-bf16 M={m} B={b}: {row['event_ms']:.4f} ms a call (CUDA "
              f"events), {row['device_ms']:.4f} ms on the device, {row['us_per_unit']:.2f} us "
              f"a unit on one SM", flush=True)
        if (m, b) == SHAPES[0] and hasattr(conv4head, "BWD_W_BF16_PHASES"):
            row["phases"] = phase_split(g, x, ops, geo, units)
            ph = row["phases"]
            print(f"    phases at {ph['mhz']:.0f} MHz, {ph['unit_cycles']:.0f} cycles "
                  f"({ph['unit_us']:.2f} us) a unit; cycles a warp and unit: " + json.dumps(
                      {k: round(v) for k, v in ph["phase_cycles"].items()}), flush=True)
        rows.append(row)
        del x, g, model, ops
        torch.cuda.empty_cache()
    print(json.dumps({"label": args.label, "rows": rows}), flush=True)


if __name__ == "__main__":
    main()
