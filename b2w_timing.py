#!/usr/bin/env python3
"""Times kernel B2w-bf16 (the bf16 Conv4Layers head's weight gradients,
the default training step's largest kernel) and kernel B2w (the f32
head's) of the package that sits beside this script, by the two
yardsticks of ``kernel_timing.py``, B2w-bf16 also by phase:

    python3 b2w_timing.py --label new               # from a checkout's root, on a card
    python3 other/b2w_timing.py --label old         # with kernel_timing.py, in another checkout
    python3 b2w_timing.py --precision f32           # B2w only (bf16: B2w-bf16 only)

Work: ``ops.cuda.conv4head.conv4head_bwd_w`` at full width (FAST weights
from seed 0, x and the cotangent g normal from numpy seed 0). bf16: for
(M, B) = (75, 64) (a training step's batch), (75, 24) (its ragged tail),
(75, 35) (a validation batch) and (1, 64) at the shipped windows of 250,
step 125; and (75, 64) at windows of 500, step 150 (3 windows, two column
tiles each), skipped where the checkout's B2w-bf16 has no plan for them.
Device time is the kernel's and its partial pass's
(``conv4head_bwd_w_bf16_kernel``, ``sum_partials_kernel``).
f32: (75, 64) at windows of 250 and of 500, whichever kernel the
checkout's route launches there (``route``: B2w, or B2w-g where B2w has
no plan for the windows), and at windows of 500 B2w-g f32 launched
directly as well (``general_*``). ``us_per_unit`` is event_ms spread over
the card's SMs per (trial, window, zone) unit, the time one unit takes on
one SM. Where this process built the kernels, the registers and spills of
every instantiation of B2w and B2w-bf16 from ``-Xptxas -v``.

Each bf16 row carries the sha256 of one call's four gradients (``sha256``),
so that two checkouts' outputs can be held bit for bit.

Then, where the checkout has the debug instantiation
(``conv4head._launch_bwd_w(..., clk=...)``), one launch of it at M = 75,
B = 64 (each window length) splits a unit's cycles by phase
(``BWD_W_BF16_PHASES``: each phase's clock64() cycles per warp and unit,
barriers apart) and reads the SM clock from the blocks' cycles over their
nanoseconds.

Prints the card's name and power limit, one line per row, and as the last
line a JSON object of the rows. Exits non-zero without a card.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

import kernel_timing as kt
from imagined_speech_decoding_tpu_torch.ops.cuda import conv4head

ITERS = 10
SHAPES = ((75, 64, 250, 125), (75, 24, 250, 125), (75, 35, 250, 125), (1, 64, 250, 125),
          (75, 64, 500, 150))  # (M, B, window, step)
F32_SHAPES = ((75, 64, 250, 125), (75, 64, 500, 150))
KERNELS = "conv4head_bwd_w_bf16_kernel|sum_partials_kernel"
F32_KERNELS = {"B2w": "conv4head_bwd_w_kernel|sum_partials_kernel",
               "B2w-g": "conv4head_bwd_w_general_kernel|sum_partials_kernel"}
WARPS = 16  # a B2w-bf16 block
ENTRIES = ("conv4head_bwd_w_kernel", "conv4head_bwd_w_bf16_kernel")


def f32_rows(args, dev, sms, rng) -> list:
    """B2w (or, where the checkout's route takes it, B2w-g) at F32_SHAPES,
    and B2w-g f32 launched directly at windows of 500."""
    rows = []
    for m, b, w, step in F32_SHAPES:
        cfg, _, ops, x = kt.head_operands(m, b, dev, rng)
        geo, n = (w, step), (cfg.seq_len - w) // step + 1
        g = torch.tensor(rng.normal(size=(m, b, n, 256)).astype(np.float32), device=dev)
        fn = lambda: conv4head.conv4head_bwd_w(g, x, *ops, *geo)  # noqa: E731
        before = conv4head.conv4head_bwd_w.launches_general
        fn()
        route = "B2w-g" if conv4head.conv4head_bwd_w.launches_general > before else "B2w"
        units = m * b * n * cfg.n_zones
        row = {"precision": "f32", "m": m, "b": b, "w": w, "route": route,
               "event_ms": kt.event_ms(fn, ITERS),
               "device_ms": kt.device_ms(fn, ITERS, F32_KERNELS[route])[0]}
        row["us_per_unit"] = 1e3 * row["event_ms"] * sms / units
        print(f"[{args.label}] {route} f32 M={m} B={b} W={w}: {row['event_ms']:.4f} ms a call "
              f"(CUDA events), {row['device_ms']:.4f} ms on the device, "
              f"{row['us_per_unit']:.2f} us a unit on one SM", flush=True)
        if w == 500:
            general = lambda: conv4head._launch_general("bwd_w", g, x, *ops, *geo)  # noqa: E731
            row["general_event_ms"] = kt.event_ms(general, 3)
            row["general_device_ms"] = kt.device_ms(general, 3, F32_KERNELS["B2w-g"])[0]
            print(f"[{args.label}] B2w-g f32 M={m} B={b} W={w}, launched directly: "
                  f"{row['general_event_ms']:.4f} ms a call (CUDA events), "
                  f"{row['general_device_ms']:.4f} ms on the device", flush=True)
        rows.append(row)
        del x, g, ops
        torch.cuda.empty_cache()
    return rows


def main() -> None:
    args = kt.start(__doc__, "b2w_timing.py", (("--precision", dict(
        choices=("both", "bf16", "f32"), default="both")),))
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(0)
    regs = kt.registers(ENTRIES)
    for name, line in regs.items():
        print(f"[{args.label}] ptxas {name}: {line}", flush=True)
    rows = f32_rows(args, dev, sms, rng) if args.precision != "bf16" else []
    for m, b, w, step in SHAPES if args.precision != "f32" else ():
        if conv4head.bwd_w_bf16_smem_bytes(64, w) > conv4head.MAX_SMEM_BYTES:
            print(f"[{args.label}] B2w-bf16 has no plan for windows of {w}: skipped", flush=True)
            continue
        cfg, _, ops, x = kt.head_operands(m, b, dev, rng, torch.bfloat16)
        geo, n = (w, step), (cfg.seq_len - w) // step + 1
        g = torch.tensor(rng.normal(size=(m, b, n, 256)).astype(np.float32), device=dev)
        fn = lambda: conv4head.conv4head_bwd_w(g, x, *ops, *geo)  # noqa: E731
        units = m * b * n * cfg.n_zones
        row = {"precision": "bf16", "m": m, "b": b, "w": w, "event_ms": kt.event_ms(fn, ITERS),
               "device_ms": kt.device_ms(fn, ITERS, KERNELS)[0]}
        row["us_per_unit"] = 1e3 * row["event_ms"] * sms / units
        digest = hashlib.sha256()
        for t in fn():
            digest.update(t.cpu().numpy().tobytes())
        row["sha256"] = digest.hexdigest()
        print(f"[{args.label}] B2w-bf16 M={m} B={b} W={w}: {row['event_ms']:.4f} ms a call (CUDA "
              f"events), {row['device_ms']:.4f} ms on the device, {row['us_per_unit']:.2f} us "
              f"a unit on one SM; sha256 {row['sha256'][:16]}", flush=True)
        if (m, b) == (75, 64) and hasattr(conv4head, "BWD_W_BF16_PHASES"):
            row["phases"] = kt.phase_split(
                lambda clk: conv4head._launch_bwd_w(g, x, *ops, *geo, clk=clk),
                conv4head.BWD_W_BF16_PHASES, WARPS, units)
            kt.print_phases(row["phases"], "unit")
        rows.append(row)
        del x, g, ops
        torch.cuda.empty_cache()
    if regs:
        rows.append({"registers": regs})
    kt.finish(args.label, rows)


if __name__ == "__main__":
    main()
