#!/usr/bin/env python3
"""Times kernel B2f-bf16 (the bf16 Conv4Layers head's forward, the default
training step's second kernel) and kernel B2f (the f32 head's) of the
package that sits beside this script, by the two yardsticks of
``kernel_timing.py``, B2f-bf16 also by phase:

    python3 b2f_timing.py --label new               # from a checkout's root, on a card
    python3 other/b2f_timing.py --label old         # with kernel_timing.py, in another checkout
    python3 b2f_timing.py --precision f32           # B2f only (bf16: B2f-bf16 only)

Work: ``ops.cuda.conv4head.fused_conv4_head`` on a bf16 x under
``torch.no_grad()`` at full width (FAST weights from seed 0, x normal from
numpy seed 0) for (M, B) = (75, 64) (a training step's batch), (75, 24)
(its ragged tail), (75, 35) (a validation batch), (1, 64) and (2, 8);
device time is the kernel's (``conv4head_fwd_bf16_kernel``).
``us_per_item`` is event_ms spread over the card's SMs per (trial, zone)
item, the time one item (its five windows) takes on one SM. At (75, 64)
also the features' sha256 (``sha256``), equal in two checkouts whose
shipped instantiation computes alike. Then one window of 800 samples
(step 125) at (M, B) = (1, 100) (an attribution batch) and (75, 64),
past B2f-bf16's whole-window plan: whichever kernel the checkout's route
launches (``route``: B2f-bf16's column tiles, or B2f-g bf16 in a checkout
without them), with ``bound_ms`` (``chip_smoke.general_bound``), and at
(1, 100) B2f-g bf16 launched directly (``general_*``).
f32: (75, 64) at windows of 250 and of 500 (3 windows, two column tiles
each), whichever kernel the checkout's route launches there (``route``:
B2f, or B2f-g where B2f has no plan for the windows), and B2f-g f32
launched directly at both (``general_*``), in the same call;
``us_per_unit`` per (trial, window, zone) unit. Then the sha256 of B2f's
features at the shipped geometry on a fixed input (``shipped_sha256``),
equal in two checkouts whose shipped instantiation computes alike. Where
this process built the kernels, the registers and spills of every
instantiation of B2f and B2f-bf16 from ``-Xptxas -v``.

Then, where the checkout has the debug instantiation
(``conv4head._launch_fwd(..., clk=...)``), one launch of it at M = 75,
B = 64 splits an item's cycles by phase (``FWD_BF16_PHASES``: each phase's
clock64() cycles per warp and item, barriers apart) and reads the SM clock
from the blocks' cycles over their nanoseconds.

Prints the card's name and power limit, one line per row, and as the last
line a JSON object of the rows. Exits non-zero without a card.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

import kernel_timing as kt
from chip_smoke import general_bound
from imagined_speech_decoding_tpu_torch.ops.cuda import conv4head

ITERS = 10
SHAPES = ((75, 64), (75, 24), (75, 35), (1, 64), (2, 8))
WHOLE_SHAPES = ((1, 100), (75, 64))  # (M, B) on one window of 800 samples
WHOLE = (800, 125)  # (window, step)
BF16_KERNELS = {"B2f-bf16": "conv4head_fwd_bf16_kernel", "B2f-g bf16": "conv4head_fwd_general"}
F32_SHAPES = ((75, 64, 250, 125), (75, 64, 500, 150))  # (M, B, window, step)
F32_KERNELS = {"B2f": "conv4head_fwd_kernel", "B2f-g": "conv4head_fwd_general_kernel"}
WARPS = 16  # a B2f-bf16 block


def shipped_digest(dev) -> str:
    """sha256 of B2f's features at the shipped geometry on a fixed input: M
    = 2, B = 8, full width, x and the fused weights normal from numpy seed
    63 (``tests/test_torch_cuda.py``'s ``_head_operands(2, 8, 64, 800, 8,
    32, 63)``), so that two checkouts' shipped instantiations can be held
    bit for bit."""
    rng = np.random.default_rng(63)
    m, b, c, t, z, o, k = 2, 8, 64, 800, 8, 32, 5

    def normal(shape, scale):
        return torch.tensor((scale * rng.normal(size=shape)).astype(np.float32), device=dev)

    ops = (normal((m, b, c, t), 1.0), normal((m, z * o, k * c), (k * c) ** -0.5),
           normal((m, z * o, 1), 0.1), normal((m, z, o, k * o), (k * o) ** -0.5),
           normal((m, z, o, k * o), (k * o) ** -0.5))
    with torch.no_grad():
        out = conv4head.fused_conv4_head(*ops, 250, 125).cpu()
    return hashlib.sha256(out.numpy().tobytes()).hexdigest()


def f32_rows(args, dev, sms, rng) -> list:
    """B2f (or, where the checkout's route takes it, B2f-g) at F32_SHAPES,
    and B2f-g f32 launched directly at each, in the same call."""
    rows = []
    for m, b, w, step in F32_SHAPES:
        cfg, _, ops, x = kt.head_operands(m, b, dev, rng)
        geo, n = (w, step), (cfg.seq_len - w) // step + 1

        def fn():
            with torch.no_grad():
                return conv4head.fused_conv4_head(x, *ops, *geo)

        before = conv4head.fused_conv4_head.launches_general
        fn()
        route = "B2f-g" if conv4head.fused_conv4_head.launches_general > before else "B2f"
        units = m * b * n * cfg.n_zones
        row = {"precision": "f32", "m": m, "b": b, "w": w, "route": route,
               "event_ms": kt.event_ms(fn, ITERS),
               "device_ms": kt.device_ms(fn, ITERS, F32_KERNELS[route])[0]}
        row["us_per_unit"] = 1e3 * row["event_ms"] * sms / units
        print(f"[{args.label}] {route} f32 M={m} B={b} W={w}: {row['event_ms']:.4f} ms a call "
              f"(CUDA events), {row['device_ms']:.4f} ms on the device, "
              f"{row['us_per_unit']:.2f} us a (trial, window, zone) unit on one SM", flush=True)
        general = lambda: conv4head._launch_general("fwd", None, x, *ops, *geo)  # noqa: E731
        row["general_event_ms"] = kt.event_ms(general, 3)
        row["general_device_ms"] = kt.device_ms(general, 3, F32_KERNELS["B2f-g"])[0]
        print(f"[{args.label}] B2f-g f32 M={m} B={b} W={w}, launched directly: "
              f"{row['general_event_ms']:.4f} ms a call (CUDA events), "
              f"{row['general_device_ms']:.4f} ms on the device", flush=True)
        rows.append(row)
        del x, ops
        torch.cuda.empty_cache()
    digest = shipped_digest(dev)
    print(f"[{args.label}] B2f at the shipped geometry, M=2 B=8 (numpy seed 63): sha256 {digest}",
          flush=True)
    rows.append({"shipped_sha256": digest})
    return rows


def whole_window_rows(args, dev, sms, rng) -> list:
    """One 800-sample window in bf16 at WHOLE_SHAPES: the route's kernel
    (B2f-bf16's column tiles, or B2f-g bf16 where the checkout's B2f-bf16
    has no plan for the window), and at M = 1 B2f-g bf16 launched directly,
    in the same call."""
    rows = []
    for m, b in WHOLE_SHAPES:
        cfg, _, ops, x = kt.head_operands(m, b, dev, rng, torch.bfloat16)

        def fn():
            with torch.no_grad():
                return conv4head.fused_conv4_head(x, *ops, *WHOLE)

        before = conv4head.fused_conv4_head.launches_general_bf16
        fn()
        route = ("B2f-g bf16" if conv4head.fused_conv4_head.launches_general_bf16 > before
                 else "B2f-bf16")
        (bound, by), _ = general_bound("fwd", True, m, b, 64, cfg.seq_len, cfg.n_zones, 32,
                                       *WHOLE)
        row = {"m": m, "b": b, "w": WHOLE[0], "route": route, "event_ms": kt.event_ms(fn, ITERS),
               "device_ms": kt.device_ms(fn, ITERS, BF16_KERNELS[route])[0], "bound_ms": bound,
               "bound_by": by}
        print(f"[{args.label}] {route} M={m} B={b} on one window of {WHOLE[0]}: "
              f"{row['event_ms']:.4f} ms a call (CUDA events), {row['device_ms']:.4f} ms on the "
              f"device; bound {bound:.4f} ms ({by}; {bound / row['device_ms']:.1%})", flush=True)
        if m == 1:
            general = lambda: conv4head._launch_general("fwd", None, x, *ops, *WHOLE)  # noqa: E731
            row["general_event_ms"] = kt.event_ms(general, 3)
            row["general_device_ms"] = kt.device_ms(general, 3, BF16_KERNELS["B2f-g bf16"])[0]
            print(f"[{args.label}] B2f-g bf16 M={m} B={b}, launched directly: "
                  f"{row['general_event_ms']:.4f} ms a call (CUDA events), "
                  f"{row['general_device_ms']:.4f} ms on the device, "
                  f"{row['general_device_ms'] / row['device_ms']:.2f}x the route's", flush=True)
        rows.append(row)
        del x, ops
        torch.cuda.empty_cache()
    return rows


def main() -> None:
    args = kt.start(__doc__, "b2f_timing.py", (("--precision", dict(
        choices=("both", "bf16", "f32"), default="both")),))
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(0)
    regs = kt.registers(("conv4head_fwd_kernel", "conv4head_fwd_bf16_kernel"))
    for name, line in regs.items():
        print(f"[{args.label}] ptxas {name}: {line}", flush=True)
    rows = f32_rows(args, dev, sms, rng) if args.precision != "bf16" else []
    for m, b in SHAPES if args.precision != "f32" else ():
        cfg, geo, ops, x = kt.head_operands(m, b, dev, rng, torch.bfloat16)

        def fn():
            with torch.no_grad():
                return conv4head.fused_conv4_head(x, *ops, *geo)

        items = m * b * cfg.n_zones
        row = {"m": m, "b": b, "event_ms": kt.event_ms(fn, ITERS),
               "device_ms": kt.device_ms(fn, ITERS, "conv4head_fwd_bf16_kernel")[0]}
        row["us_per_item"] = 1e3 * row["event_ms"] * sms / items
        if (m, b) == SHAPES[0]:
            row["sha256"] = hashlib.sha256(fn().float().cpu().numpy().tobytes()).hexdigest()
        print(f"[{args.label}] B2f-bf16 M={m} B={b}: {row['event_ms']:.4f} ms a call (CUDA "
              f"events), {row['device_ms']:.4f} ms on the device, {row['us_per_item']:.2f} us "
              f"a (trial, zone) item on one SM"
              + (f"; features' sha256 {row['sha256']}" if "sha256" in row else ""), flush=True)
        if (m, b) == SHAPES[0] and hasattr(conv4head, "FWD_BF16_PHASES"):
            row["phases"] = kt.phase_split(
                lambda clk: conv4head._launch_fwd(x, *ops, *geo, clk=clk),
                conv4head.FWD_BF16_PHASES, WARPS, items)
            kt.print_phases(row["phases"], "item")
        rows.append(row)
        del x, ops
        torch.cuda.empty_cache()
    if args.precision != "f32":
        rows += whole_window_rows(args, dev, sms, rng)
    if regs:
        rows.append({"registers": regs})
    kt.finish(args.label, rows)


if __name__ == "__main__":
    main()
