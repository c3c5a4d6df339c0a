"""Peak memory and step time of the batch-norm heads' training step, with
and without the recompute of their first block, on a CUDA GPU.

One training step (``engine.train_step``, AdamW) of ``FAST`` with the
CVBlock or the EEGNet_Encoder head at full width: 75 models (15 subjects x
5 folds) at batch 64, 64 x 800 inputs, in bf16 and in f32. The first block
(temporal conv, masked batch norm, spatial conv) runs in chunks either way;
``recompute`` is the package as it is, each training chunk under
``torch.utils.checkpoint``; ``keep`` calls each chunk directly instead, so
that its activations stay for the backward. Per case:
- ``peak_gb``: ``torch.cuda.max_memory_allocated`` from the model's
  construction through a warm-up step and the timed steps, or the
  out-of-memory error's first line;
- ``span_ms``: CUDA events around 2 back-to-back steps, per step;
- one more step under the profiler, with CUDA events around it: its span
  (``profiled_span_ms``), the sum of its kernel and copy records
  (``busy_ms``), the length of their union on the device's clock
  (``union_ms``), and by stream the records' count and sum, and the three
  kernels that take most of the time on each stream but the busiest. On
  one stream the union equals the sum, and neither can exceed the span.
TSception's f32 step (75 models, batch 32) gets the profiled row as well.

    python3 bn_head_memory.py [--only CVBlock,EEGNet_Encoder,TSception]

Prints the card's name and power limit first and one JSON object a case.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from imagined_speech_decoding_tpu_torch.config import FASTConfig  # noqa: E402
from imagined_speech_decoding_tpu_torch.models.api import make_tsception_model  # noqa: E402
from imagined_speech_decoding_tpu_torch.models.fast import FAST  # noqa: E402
from imagined_speech_decoding_tpu_torch.models import heads  # noqa: E402
from imagined_speech_decoding_tpu_torch.train import engine  # noqa: E402
from imagined_speech_decoding_tpu_torch.transplant import from_jax_params, init_jax_layout  # noqa: E402

M, B, TS_BATCH = 75, 64, 32
RECOMPUTE = heads.checkpoint


def direct(fn, *args, use_reentrant=None):
    return fn(*args)


def events_ms(step, iters: int) -> float:
    begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    begin.record()
    for _ in range(iters):
        step()
    end.record()
    end.synchronize()
    return begin.elapsed_time(end) / iters


def profiled_row(step) -> dict:
    """One step under the profiler with CUDA events around it."""
    box = {}

    def timed():
        box["ms"] = events_ms(step, 1)

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        timed()
        torch.cuda.synchronize()
    records = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() != DeviceType.CPU and not e.is_user_annotation()]
    spans = sorted((e.start_ns(), e.end_ns()) for e in records)
    union, reach = 0, -math.inf
    for a, b in spans:
        if b > reach:
            union += b - max(a, reach)
            reach = b
    streams = {}
    for e in records:
        st = streams.setdefault(e.device_resource_id(), {"records": 0, "ms": 0.0, "by": {}})
        st["records"] += 1
        st["ms"] += e.duration_ns() / 1e6
        st["by"][e.name()[:70]] = st["by"].get(e.name()[:70], 0.0) + e.duration_ns() / 1e6
    main_stream = max(streams, key=lambda k: streams[k]["ms"])
    for sid, st in streams.items():
        top = sorted(st.pop("by").items(), key=lambda kv: -kv[1])
        if sid != main_stream:
            st["top"] = [[name, round(ms, 3)] for name, ms in top[:3]]
    return {"profiled_span_ms": box["ms"], "busy_ms": sum(b - a for a, b in spans) / 1e6,
            "union_ms": union / 1e6, "records": len(spans),
            "streams": {str(k): v for k, v in streams.items()}}


def run_case(label: str, build) -> dict:
    """``build()`` -> a step function; the case's row, or its OOM."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    row = {"case": label}
    try:
        step = build()
        step()
        torch.cuda.synchronize()
        row["span_ms"] = events_ms(step, 2)
        row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        row.update(profiled_row(step))
    except torch.OutOfMemoryError as exc:
        row["oom"] = str(exc).splitlines()[0]
        row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    step = None
    print(json.dumps(row), flush=True)
    return row


def head_step(head: str, dtype, dev):
    def build():
        cfg = dataclasses.replace(FASTConfig.default(), head=head)
        model = FAST(cfg, n_models=M, device=dev)
        model.load_state_dict(from_jax_params(*init_jax_layout(cfg, 0, M)))
        model.train()
        opt = engine.make_optimizer(model.parameters())
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn((M, B, 64, 800), generator=gen, device=dev).to(dtype)
        y = torch.randint(0, cfg.n_classes, (M, B), generator=gen, device=dev)
        return lambda: engine.train_step(model, opt, x, y, 1e-4, cfg.n_classes, gen)

    return build


def tsception_step(dev):
    def build():
        mdef = make_tsception_model(64, 800)
        model = mdef.build(M, dev)
        mdef.load(model, *mdef.init(0, M))
        model.train()
        opt = engine.make_optimizer(model.parameters(), 0.0)
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn((M, TS_BATCH, 64, 800), generator=gen, device=dev)
        y = torch.randint(0, 5, (M, TS_BATCH), generator=gen, device=dev)
        return lambda: engine.train_step(model, opt, x, y, 1e-3, 5, gen)

    return build


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", default="CVBlock,EEGNet_Encoder,TSception")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bn_head_memory.py needs a CUDA GPU: torch.cuda.is_available() is false")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    wanted = args.only.split(",")
    names = [h for h in ("CVBlock", "EEGNet_Encoder") if h in wanted]
    # The cases most likely to run out of memory come last.
    cases = [(h, torch.bfloat16, r) for h in names for r in (True, False)]
    cases += [(h, torch.float32, True) for h in names]
    if "TSception" in wanted:
        cases.append(("TSception", torch.float32, None))
    cases += [(h, torch.float32, False) for h in names]
    for head, dtype, recompute in cases:
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        if head == "TSception":
            run_case(f"TSception {name}", tsception_step(dev))
            continue
        heads.checkpoint = RECOMPUTE if recompute else direct
        run_case(f"{head} {name} {'recompute' if recompute else 'keep'}",
                 head_step(head, dtype, dev))


if __name__ == "__main__":
    main()
