#!/usr/bin/env python3
"""Times kernel B2f-bf16 (the bf16 Conv4Layers head's forward, the default
training step's second kernel) of the package that sits beside this
script, by the two yardsticks of ``kernel_timing.py`` and by phase:

    python3 b2f_timing.py --label new               # from a checkout's root, on a card
    python3 other/b2f_timing.py --label old         # with kernel_timing.py, in another checkout

Work: ``ops.cuda.conv4head.fused_conv4_head`` on a bf16 x under
``torch.no_grad()`` at full width (FAST weights from seed 0, x normal from
numpy seed 0) for (M, B) = (75, 64) (a training step's batch), (75, 24)
(its ragged tail), (75, 35) (a validation batch), (1, 64) and (2, 8);
device time is the kernel's (``conv4head_fwd_bf16_kernel``).
``us_per_item`` is event_ms spread over the card's SMs per (trial, zone)
item, the time one item (its five windows) takes on one SM.

Then, where the checkout has the debug instantiation
(``conv4head._launch_fwd(..., clk=...)``), one launch of it at M = 75,
B = 64 splits an item's cycles by phase (``FWD_BF16_PHASES``: each phase's
clock64() cycles per warp and item, barriers apart) and reads the SM clock
from the blocks' cycles over their nanoseconds.

Prints the card's name and power limit, one line per row, and as the last
line a JSON object of the rows. Exits non-zero without a card.
"""

from __future__ import annotations

import numpy as np
import torch

import kernel_timing as kt
from imagined_speech_decoding_tpu_torch.ops.cuda import conv4head

ITERS = 10
SHAPES = ((75, 64), (75, 24), (75, 35), (1, 64), (2, 8))
WARPS = 16  # a B2f-bf16 block


def main() -> None:
    args = kt.start(__doc__, "b2f_timing.py")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(0)
    rows = []
    for m, b in SHAPES:
        cfg, geo, ops, x = kt.head_operands(m, b, dev, rng, torch.bfloat16)

        def fn():
            with torch.no_grad():
                return conv4head.fused_conv4_head(x, *ops, *geo)

        items = m * b * cfg.n_zones
        row = {"m": m, "b": b, "event_ms": kt.event_ms(fn, ITERS),
               "device_ms": kt.device_ms(fn, ITERS, "conv4head_fwd_bf16_kernel")[0]}
        row["us_per_item"] = 1e3 * row["event_ms"] * sms / items
        print(f"[{args.label}] B2f-bf16 M={m} B={b}: {row['event_ms']:.4f} ms a call (CUDA "
              f"events), {row['device_ms']:.4f} ms on the device, {row['us_per_item']:.2f} us "
              f"a (trial, zone) item on one SM", flush=True)
        if (m, b) == SHAPES[0] and hasattr(conv4head, "FWD_BF16_PHASES"):
            row["phases"] = kt.phase_split(
                lambda clk: conv4head._launch_fwd(x, *ops, *geo, clk=clk),
                conv4head.FWD_BF16_PHASES, WARPS, items)
            kt.print_phases(row["phases"], "item")
        rows.append(row)
        del x, ops
        torch.cuda.empty_cache()
    kt.finish(args.label, rows)


if __name__ == "__main__":
    main()
