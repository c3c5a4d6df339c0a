#!/usr/bin/env python3
"""Times kernel B2x (the Conv4Layers head's input gradient) of the package
that sits beside this script, by two yardsticks, so that two checkouts of
the repository can be compared on one card:

    python3 b2x_timing.py --label new [--sweep]    # from a checkout's root, on a card
    python3 other/b2x_timing.py --label old        # a copy of this file in another checkout

Work: ``ops.cuda.conv4head.conv4head_bwd_x`` at full width (C = 64, T =
800, 5 windows of 250 step 125, 8 zones, O = 32, K = 5; FAST weights from
seed 0, x and the cotangent g normal from numpy seed 0) for (M, B) = (2, 8),
(1, 16) (the explain CLI's test trials), (1, 64) and (1, 100) (the
global-explain CLI's trials). Both yardsticks are read on the same calls:
- ``event_ms``: CUDA events around back-to-back wrapper calls, per call
  (the kernel, the dxw buffer and the overlap-add of the windows);
- ``device_ms``: the profiler's device time per call of the kernel and
  its partial pass (``conv4head_bwd_x_kernel``, ``sum_partials_kernel``).

``--sweep`` (a checkout whose wrapper has ``_launch_bwd_x``) adds the
device time of each split of the 8 zones into SZ = 1..8 ranges at each
shape, beside the wrapper's own pick.

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

ITERS = 20
SHAPES = ((2, 8), (1, 16), (1, 64), (1, 100))
KERNELS = "conv4head_bwd_x_kernel|sum_partials_kernel"


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


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--label", default="this checkout")
    parser.add_argument("--sweep", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("b2x_timing.py needs a CUDA GPU: torch.cuda.is_available() is false")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
        x = torch.tensor(rng.normal(size=(m, b, 64, cfg.seq_len)).astype(np.float32), device=dev)
        g = torch.tensor(rng.normal(size=(m, b, cfg.n_tokens, 256)).astype(np.float32),
                         device=dev)
        fn = lambda: conv4head.conv4head_bwd_x(g, x, *ops, *geo)  # noqa: E731
        row = {"m": m, "b": b, "event_ms": event_ms(fn), "device_ms": device_ms(fn)}
        if args.sweep and hasattr(conv4head, "_launch_bwd_x"):
            row["pick"] = conv4head._bwd_x_zone_splits(m, b, cfg.n_tokens, 8, 64,
                                                       cfg.window_len, sms)
            row["sweep"] = [[sz, device_ms(lambda: conv4head._launch_bwd_x(g, x, *ops, *geo, sz))]
                            for sz in range(1, 9)]
        rows.append(row)
        print(f"[{args.label}] B2x M={m} B={b}: {row['event_ms']:.4f} ms a call (CUDA events), "
              f"{row['device_ms']:.4f} ms on the device", flush=True)
        if "sweep" in row:
            print(f"    zone ranges SZ -> device ms: " + json.dumps(
                {sz: round(t, 4) for sz, t in row["sweep"]}) + f"; the wrapper picks {row['pick']}",
                flush=True)
    print(json.dumps({"label": args.label, "rows": rows}), flush=True)


if __name__ == "__main__":
    main()
