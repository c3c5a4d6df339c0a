#!/usr/bin/env python3
"""Times kernel B2x (the Conv4Layers head's input gradient) and kernel
B2x-bf16 (its bf16 counterpart) of the package that sits beside this
script, by the two yardsticks of ``kernel_timing.py``:

    python3 b2x_timing.py --label new [--sweep]    # from a checkout's root, on a card
    python3 other/b2x_timing.py --label old        # with kernel_timing.py, in another checkout
    python3 b2x_timing.py --precision bf16         # bf16 only (f32: B2x only)

Work: ``ops.cuda.conv4head.conv4head_bwd_x`` at full width (FAST weights
from seed 0, x and the cotangent g normal from numpy seed 0) for (M, B) =
(2, 8), (1, 16) (the explain CLI's test trials), (1, 64) and (1, 100) (the
global-explain CLI's trials). The CUDA-event time covers the wrapper (the
kernel, the dxw buffer and the overlap-add of the windows); device time is
the kernel's and its partial pass's.

f32: B2x at those shapes, and at M = 1, B = 100 on windows of 500 (step
150), past B2x's whole-window plan: whichever kernel the checkout's route
launches there (B2x in column tiles, or B2x-g f32 in a checkout without
them), beside B2x-g f32 launched directly in the same process
(``general_*``).
bf16: whichever kernel the checkout's route launches for a bf16 x
(``route``: B2x-bf16, or B2x-g bf16 in a checkout without it), and B2x-g
bf16 launched directly at the same shapes (``general_*``); and at M = 1,
B = 100 on windows of 500 (3 windows) and on one window of 800 samples
(step 125), past one tile of B2x-bf16: its column tiles, or B2x-g bf16 in a
checkout without them. Then B2f-g bf16 launched directly (the forward on
one window of 800; B2f-bf16 runs it in column tiles, ``b2f_timing.py``) at
that shape. ``bound_ms`` is the head's
bound (``chip_smoke.general_bound``). ``us_per_unit``
is the device time spread over the card's SMs per (trial, window, zone)
unit, the time one unit takes on one SM. Where this process built the
kernels, the registers and spills of every instantiation of B2x and
B2x-bf16 from ``-Xptxas -v``.

``--sweep`` (a checkout whose wrapper has ``_launch_bwd_x``; bf16 where it
has B2x-bf16) adds the device time of each split of the 8 zones into SZ =
1..8 ranges at each shape, beside the wrapper's own pick. Where the
checkout has B2x-bf16's debug instantiation (``_launch_bwd_x(...,
clk=...)``), one launch of it at each bf16 shape (the wrapper's SZ) splits
a block's cycles by phase (``BWD_X_BF16_PHASES``: each phase's clock64()
cycles per warp and (trial, window, zone) unit, barriers apart; in column
tiles a unit is a zone's tiles) and reads the SM clock.

Prints the card's name and power limit, one line per row, and as the last
line a JSON object of the rows. Exits non-zero without a card.
"""

from __future__ import annotations

import json

import numpy as np
import torch

import kernel_timing as kt
from chip_smoke import general_bound
from imagined_speech_decoding_tpu_torch.ops.cuda import conv4head

ITERS = 20
SHAPES = ((2, 8), (1, 16), (1, 64), (1, 100))
WIDE = (1, 100, 500, 150)  # (M, B, window, step) past B2x's and B2x-bf16's whole-window plans
WHOLE = (1, 100, 800, 125)  # (M, B, window, step): one window of 800, past one tile of B2x-bf16
KERNELS = {"B2x": "conv4head_bwd_x_kernel|sum_partials_kernel",
           "B2x-bf16": "conv4head_bwd_x_bf16_|sum_partials_kernel",  # with its pre-pass
           "B2x-g": "conv4head_bwd_x_general_kernel", "B2f-g": "conv4head_fwd_general_kernel"}
ENTRIES = ("conv4head_bwd_x_kernel", "conv4head_bwd_x_bf16_kernel")
ZONES = 8
WARPS = 16  # a B2x-bf16 block


def route(fn, bf16: bool) -> str:
    """The kernel one call of ``fn`` launches, by the wrapper's counters."""
    counters = ("launches_bf16", "launches_general_bf16") if bf16 else ("launches",
                                                                        "launches_general")
    before = [getattr(conv4head.conv4head_bwd_x, k, 0) for k in counters]
    fn()
    moved = [getattr(conv4head.conv4head_bwd_x, k, 0) - b for k, b in zip(counters, before)]
    return ("B2x-bf16" if bf16 else "B2x") if moved[0] else "B2x-g"


def sweep(g, x, ops, geo, m, b, n, sms, bf16: bool) -> dict:
    """Device time of each SZ = 1..8, and the wrapper's pick."""
    costs = ((conv4head.X_BF16_UNIT_S, getattr(conv4head, "X_BF16_BLOCK_S", 0.0)) if bf16
             else (conv4head.X_UNIT_S,))
    tiles = {}  # a zone is its tiles' units
    if bf16 and hasattr(conv4head, "bwd_x_bf16_col_tiles"):
        tiles["tiles"] = len(conv4head.bwd_x_bf16_col_tiles(conv4head.bwd_x_bf16_plan(64, geo[0])))
    elif not bf16 and hasattr(conv4head, "bwd_x_col_tiles"):
        tiles["tiles"] = len(conv4head.bwd_x_col_tiles(64, geo[0]))
    pattern = KERNELS["B2x-bf16" if bf16 else "B2x"]
    return {"pick": conv4head._bwd_x_zone_splits(m, b, n, ZONES, 64, geo[0], sms, *costs,
                                                 **tiles),
            "sweep": [[sz, kt.device_ms(lambda: conv4head._launch_bwd_x(g, x, *ops, *geo, sz),
                                        ITERS, pattern)[0]] for sz in range(1, ZONES + 1)]}


def time_row(label, precision, m, b, geo, fn, name, sms, n, op="bwd_x") -> dict:
    row = {"precision": precision, "m": m, "b": b, "w": geo[0], "route": name,
           "event_ms": kt.event_ms(fn, ITERS), "device_ms": kt.device_ms(fn, ITERS,
                                                                         KERNELS[name])[0]}
    row["us_per_unit"] = 1e3 * row["device_ms"] * sms / (m * b * n * ZONES)
    (row["bound_ms"], row["bound_by"]), _ = general_bound(op, precision == "bf16", m, b, 64, 800,
                                                          ZONES, 32, *geo)
    print(f"[{label}] {name} {precision} M={m} B={b} W={geo[0]}: {row['event_ms']:.4f} ms a call "
          f"(CUDA events), {row['device_ms']:.4f} ms on the device, {row['us_per_unit']:.2f} us "
          f"a unit on one SM; bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
          f"{row['bound_ms'] / row['device_ms']:.1%})", flush=True)
    return row


def main() -> None:
    args = kt.start(__doc__, "b2x_timing.py", [("--sweep", dict(action="store_true")),
                                               ("--precision", dict(choices=("both", "bf16", "f32"),
                                                                    default="both"))])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(0)
    regs = kt.registers(ENTRIES)
    for name, line in regs.items():
        print(f"[{args.label}] ptxas {name}: {line}", flush=True)
    rows = []
    precisions = ("f32", "bf16") if args.precision == "both" else (args.precision,)
    for precision in precisions:
        bf16 = precision == "bf16"
        shapes = [(m, b, None, None) for m, b in SHAPES] + ([WIDE, WHOLE] if bf16 else [WIDE])
        for m, b, w, step in shapes:
            cfg, geo, ops, x = kt.head_operands(m, b, dev, rng,
                                                torch.bfloat16 if bf16 else torch.float32)
            geo = geo if w is None else (w, step)
            n = (cfg.seq_len - geo[0]) // geo[1] + 1
            g = torch.tensor(rng.normal(size=(m, b, n, 256)).astype(np.float32), device=dev)
            fn = lambda: conv4head.conv4head_bwd_x(g, x, *ops, *geo)  # noqa: E731
            row = time_row(args.label, precision, m, b, geo, fn, route(fn, bf16), sms, n)
            if bf16 or w is not None:
                general = lambda: conv4head._launch_general("bwd_x", g, x, *ops, *geo)  # noqa: E731
                row["general_event_ms"] = kt.event_ms(general, 5)
                row["general_device_ms"] = kt.device_ms(general, 5, KERNELS["B2x-g"])[0]
                print(f"[{args.label}] B2x-g {precision} M={m} B={b} W={geo[0]}, launched "
                      f"directly: {row['general_event_ms']:.4f} ms a call (CUDA events), "
                      f"{row['general_device_ms']:.4f} ms on the device", flush=True)
            if bf16 and row["route"] == "B2x-bf16" and hasattr(conv4head, "BWD_X_BF16_PHASES"):
                row["phases"] = kt.phase_split(
                    lambda clk: conv4head._launch_bwd_x(g, x, *ops, *geo, clk=clk),
                    conv4head.BWD_X_BF16_PHASES, WARPS, m * b * n * ZONES)
                kt.print_phases(row["phases"], "unit")
            tuned = row["route"] != "B2x-g" and hasattr(conv4head, "_launch_bwd_x")
            if args.sweep and tuned and (not bf16 or hasattr(conv4head, "bwd_x_bf16_plan")):
                row.update(sweep(g, x, ops, geo, m, b, n, sms, bf16))
                print("    zone ranges SZ -> device ms: " + json.dumps(
                    {sz: round(t, 4) for sz, t in row["sweep"]})
                    + f"; the wrapper picks {row['pick']}", flush=True)
            rows.append(row)
            if bf16 and (w, step) == WHOLE[2:]:  # B2f-g bf16 there, launched directly
                fwd = lambda: conv4head._launch_general("fwd", None, x, *ops, *geo)  # noqa: E731
                rows.append(time_row(args.label, precision, m, b, geo, fwd, "B2f-g", sms, n,
                                     op="fwd"))
            del x, g, ops
            torch.cuda.empty_cache()
    if regs:
        rows.append({"registers": regs})
    kt.finish(args.label, rows)


if __name__ == "__main__":
    main()
