#!/usr/bin/env python3
"""Times kernel B1 (the biquad IIR cascade) of the package that sits
beside this script, by two yardsticks, so that two checkouts of the
repository can be compared on one card:

    python3 iir_timing.py --label new            # from a checkout's root, on a card
    python3 other/iir_timing.py --label old      # a copy of this file in another checkout

Both yardsticks are read on the same calls:
- ``event_ms``: CUDA events around 50 back-to-back calls, per call (the
  host's time between calls included when it is longer than the kernel's);
- ``device_ms``: the profiler's device time per call, over the same
  number of calls.

Work timed, with the band-pass of the online decoder (4-40 Hz, order 4,
250 Hz) and its 60 Hz notch:
- the causal entry ``ops.cuda.iir.sosfilt_time_major`` on (854, R), with
  zi, for R = 64, 512, 4,096 and 22,400 (device time: its kernel only);
- the decode's filter stage at B = 1 and 8 (64 channels, 800 samples),
  through ``ops.filters.sosfiltfilt`` once per filter and, where the
  package has it, through ``ops.cuda.iir.sosfiltfilt_chain`` on filters
  prepared once (device time: every kernel and copy, and their count).

Prints the card's name and power limit, one line per row, and as the
last line a JSON object of the rows. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from imagined_speech_decoding_tpu_torch.ops.cuda import iir  # noqa: E402
from imagined_speech_decoding_tpu_torch.ops.filters import (  # noqa: E402
    butter_sos,
    notch_ba,
    sosfiltfilt,
)

ITERS = 50
CAUSAL_ROWS = (64, 512, 4096, 22400)
DECODE_BATCHES = (1, 8)


def event_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def device_ms(fn, kernel=None):
    """Device time per call of the kernels whose name holds ``kernel``
    (every kernel and copy when None), and their count per call."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type != DeviceType.CPU
              and (kernel is None or kernel in e.key)]
    return (sum(e.self_device_time_total for e in events) / 1e3 / ITERS,
            sum(e.count for e in events) / ITERS)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--label", default="this checkout")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("iir_timing.py needs a CUDA GPU: torch.cuda.is_available() is false")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    from scipy.signal import tf2sos

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    band = butter_sos(250.0, 4.0, 40.0)
    notch = tf2sos(*notch_ba(250.0, 60.0))
    rows = []
    with torch.inference_mode():
        for r in CAUSAL_ROWS:
            xt = torch.tensor(rng.normal(size=(854, r)).astype(np.float32), device=dev)
            zi = torch.tensor(rng.normal(size=(2 * band.shape[0], r)).astype(np.float32),
                              device=dev)
            fn = lambda: iir.sosfilt_time_major(band, xt, zi)  # noqa: E731
            dms, n = device_ms(fn, "sosfilt_time_major_kernel")
            rows.append({"work": "causal", "shape": [854, r], "event_ms": event_ms(fn),
                         "device_ms": dms, "device_ops": n})
        routes = {"sosfiltfilt x2": lambda x: sosfiltfilt(band, sosfiltfilt(notch, x))}
        if hasattr(iir, "sosfiltfilt_chain"):
            chain = [iir.prepare_filter(notch), iir.prepare_filter(band)]
            routes["sosfiltfilt_chain"] = lambda x: iir.sosfiltfilt_chain(chain, x)
        for b in DECODE_BATCHES:
            x = torch.tensor(rng.normal(size=(b, 64, 800)).astype(np.float32), device=dev)
            for name, route in routes.items():
                fn = lambda: route(x)  # noqa: E731
                dms, n = device_ms(fn)
                rows.append({"work": f"decode filters, {name}", "shape": [b, 64, 800],
                             "event_ms": event_ms(fn), "device_ms": dms, "device_ops": n})
    for row in rows:
        print(f"[{args.label}] {row['work']} {tuple(row['shape'])}: {row['event_ms']:.4f} ms a "
              f"call (CUDA events), {row['device_ms']:.4f} ms on the device over "
              f"{row['device_ops']:g} kernels and copies", flush=True)
    print(json.dumps({"label": args.label, "rows": rows}), flush=True)


if __name__ == "__main__":
    main()
