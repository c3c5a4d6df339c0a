#!/usr/bin/env python3
"""Times kernel B2x (the Conv4Layers head's input gradient) of the package
that sits beside this script, by the two yardsticks of
``kernel_timing.py``:

    python3 b2x_timing.py --label new [--sweep]    # from a checkout's root, on a card
    python3 other/b2x_timing.py --label old        # with kernel_timing.py, in another checkout

Work: ``ops.cuda.conv4head.conv4head_bwd_x`` at full width (FAST weights
from seed 0, x and the cotangent g normal from numpy seed 0) for (M, B) =
(2, 8), (1, 16) (the explain CLI's test trials), (1, 64) and (1, 100) (the
global-explain CLI's trials). The CUDA-event time covers the wrapper (the
kernel, the dxw buffer and the overlap-add of the windows); device time is
the kernel's and its partial pass's (``conv4head_bwd_x_kernel``,
``sum_partials_kernel``).

``--sweep`` (a checkout whose wrapper has ``_launch_bwd_x``) adds the
device time of each split of the 8 zones into SZ = 1..8 ranges at each
shape, beside the wrapper's own pick.

Prints the card's name and power limit, one line per row, and as the last
line a JSON object of the rows. Exits non-zero without a card.
"""

from __future__ import annotations

import json

import numpy as np
import torch

import kernel_timing as kt
from imagined_speech_decoding_tpu_torch.ops.cuda import conv4head

ITERS = 20
SHAPES = ((2, 8), (1, 16), (1, 64), (1, 100))
KERNELS = "conv4head_bwd_x_kernel|sum_partials_kernel"


def main() -> None:
    args = kt.start(__doc__, "b2x_timing.py", [("--sweep", dict(action="store_true"))])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(0)
    rows = []
    for m, b in SHAPES:
        cfg, geo, ops, x = kt.head_operands(m, b, dev, rng)
        g = torch.tensor(rng.normal(size=(m, b, cfg.n_tokens, 256)).astype(np.float32),
                         device=dev)
        fn = lambda: conv4head.conv4head_bwd_x(g, x, *ops, *geo)  # noqa: E731
        row = {"m": m, "b": b, "event_ms": kt.event_ms(fn, ITERS),
               "device_ms": kt.device_ms(fn, ITERS, KERNELS)[0]}
        if args.sweep and hasattr(conv4head, "_launch_bwd_x"):
            row["pick"] = conv4head._bwd_x_zone_splits(m, b, cfg.n_tokens, 8, 64,
                                                       cfg.window_len, sms)
            row["sweep"] = [[sz, kt.device_ms(
                lambda: conv4head._launch_bwd_x(g, x, *ops, *geo, sz), ITERS, KERNELS)[0]]
                for sz in range(1, 9)]
        rows.append(row)
        print(f"[{args.label}] B2x M={m} B={b}: {row['event_ms']:.4f} ms a call (CUDA events), "
              f"{row['device_ms']:.4f} ms on the device", flush=True)
        if "sweep" in row:
            print("    zone ranges SZ -> device ms: " + json.dumps(
                {sz: round(t, 4) for sz, t in row["sweep"]}) + f"; the wrapper picks {row['pick']}",
                flush=True)
    kt.finish(args.label, rows)


if __name__ == "__main__":
    main()
