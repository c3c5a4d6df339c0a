"""Profiling: a ``torch.profiler`` trace of a region, named ranges in it,
and a steady-state step timer.

Counterpart of ``imagined_speech_decoding_tpu/profiling.py``:

  * ``trace(logdir)`` — context manager around ``torch.profiler.profile``
    (the host's activity, and the card's when one is visible) that writes
    a Chrome trace, ``<logdir>/trace.json``, for Perfetto
    (https://ui.perfetto.dev) or ``chrome://tracing``. The profiler has
    lost the card's records of a session before (its kernels ran, its
    trace held none); when a session that used the card holds no device
    record, ``trace`` says so on stderr;
  * ``annotate(name)`` — a named range on the trace's host timeline
    (``torch.profiler.record_function``), and an NVTX range when a card is
    visible;
  * ``sync_scalar(t)`` — wait for the device by reading one element back;
  * ``StepTimer`` — steady-state steps/s with warm-up laps discarded.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Callable, List, Optional

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the body; on exit (an exception too) write
    ``<logdir>/trace.json``. Yields ``logdir``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    on_card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    prof = profile(activities=activities)
    try:
        with prof:
            try:
                yield logdir
            finally:
                if on_card and torch.cuda.is_initialized():
                    torch.cuda.synchronize()
    finally:
        prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))
        if on_card and torch.cuda.is_initialized() and not any(
                e.device_type == DeviceType.CUDA for e in prof.events()):
            print(f"profiling.trace: the profiler recorded no device activity in "
                  f"{os.path.join(logdir, TRACE_FILE)} although the card was used; its "
                  "records were lost (time the region with CUDA events instead)",
                  file=sys.stderr, flush=True)


@contextlib.contextmanager
def annotate(name: str):
    """A named range on the profiler's timeline (and NVTX's, on a card)."""
    import torch

    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def sync_scalar(t) -> float:
    """Wait for the device by reading the first element of ``t`` back."""
    while getattr(t, "ndim", 0) > 0:
        t = t[0]
    return float(t)


class StepTimer:
    """Steady-state throughput measurement::

        timer = StepTimer(warmup=2)
        for i in range(10):
            out = step(...)
            timer.lap(lambda: sync_scalar(out))
        print(timer.steps_per_sec)
    """

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.laps: List[float] = []
        self._t0: Optional[float] = None
        self._count = 0

    def lap(self, sync: Optional[Callable[[], float]] = None) -> Optional[float]:
        if sync is not None:
            sync()
        now = time.perf_counter()
        self._count += 1
        # The first lap can never produce a delta (no prior timestamp),
        # so warmup=0 behaves like warmup=1 instead of crashing.
        if self._count <= self.warmup or self._t0 is None:
            self._t0 = now
            return None
        delta = now - self._t0
        self._t0 = now
        self.laps.append(delta)
        return delta

    @property
    def mean_lap(self) -> float:
        return sum(self.laps) / len(self.laps) if self.laps else float("nan")

    @property
    def steps_per_sec(self) -> float:
        m = self.mean_lap
        return 1.0 / m if m and m == m else float("nan")
