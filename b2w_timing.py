#!/usr/bin/env python3
"""Times kernel B2w-bf16 (the bf16 Conv4Layers head's weight gradients,
the default training step's largest kernel) of the package that sits
beside this script, by the two yardsticks of ``kernel_timing.py`` and by
phase:

    python3 b2w_timing.py --label new               # from a checkout's root, on a card
    python3 other/b2w_timing.py --label old         # with kernel_timing.py, in another checkout

Work: ``ops.cuda.conv4head.conv4head_bwd_w`` on a bf16 x at full width
(FAST weights from seed 0, x and the cotangent g normal from numpy seed 0)
for (M, B) = (75, 64) (a training step's batch), (75, 24) (its ragged
tail), (75, 35) (a validation batch) and (1, 64); device time is the
kernel's and its partial pass's (``conv4head_bwd_w_bf16_kernel``,
``sum_partials_kernel``). ``us_per_unit`` is event_ms spread over the
card's SMs per (trial, window, zone) unit, the time one unit takes on one
SM.

Then, where the checkout has the debug instantiation
(``conv4head._launch_bwd_w(..., clk=...)``), one launch of it at M = 75,
B = 64 splits a unit's cycles by phase (``BWD_W_BF16_PHASES``: each
phase's clock64() cycles per warp and unit, barriers apart) and reads the
SM clock from the blocks' cycles over their nanoseconds.

Prints the card's name and power limit, one line per row, and as the last
line a JSON object of the rows. Exits non-zero without a card.
"""

from __future__ import annotations

import numpy as np
import torch

import kernel_timing as kt
from imagined_speech_decoding_tpu_torch.ops.cuda import conv4head

ITERS = 10
SHAPES = ((75, 64), (75, 24), (75, 35), (1, 64))
KERNELS = "conv4head_bwd_w_bf16_kernel|sum_partials_kernel"
WARPS = 16  # a B2w-bf16 block


def main() -> None:
    args = kt.start(__doc__, "b2w_timing.py")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(0)
    rows = []
    for m, b in SHAPES:
        cfg, geo, ops, x = kt.head_operands(m, b, dev, rng, torch.bfloat16)
        g = torch.tensor(rng.normal(size=(m, b, cfg.n_tokens, 256)).astype(np.float32),
                         device=dev)
        fn = lambda: conv4head.conv4head_bwd_w(g, x, *ops, *geo)  # noqa: E731
        units = m * b * cfg.n_tokens * cfg.n_zones
        row = {"m": m, "b": b, "event_ms": kt.event_ms(fn, ITERS),
               "device_ms": kt.device_ms(fn, ITERS, KERNELS)[0]}
        row["us_per_unit"] = 1e3 * row["event_ms"] * sms / units
        print(f"[{args.label}] B2w-bf16 M={m} B={b}: {row['event_ms']:.4f} ms a call (CUDA "
              f"events), {row['device_ms']:.4f} ms on the device, {row['us_per_unit']:.2f} us "
              f"a unit on one SM", flush=True)
        if (m, b) == SHAPES[0] and hasattr(conv4head, "BWD_W_BF16_PHASES"):
            row["phases"] = kt.phase_split(
                lambda clk: conv4head._launch_bwd_w(g, x, *ops, *geo, clk=clk),
                conv4head.BWD_W_BF16_PHASES, WARPS, units)
            kt.print_phases(row["phases"], "unit")
        rows.append(row)
        del x, g, ops
        torch.cuda.empty_cache()
    kt.finish(args.label, rows)


if __name__ == "__main__":
    main()
