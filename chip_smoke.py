#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving, training and attribution
paths on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, on a machine with a card

1. Prints the card (``nvidia-smi`` name and power limit) and versions.
2. Builds the hand-written CUDA kernels from ``csrc/`` and prints the
   build time and, for the tensor-core kernels B2f, B2w and B2x and the
   bf16 instantiations B2f-bf16 and B2w-bf16, their registers and spills
   (``-Xptxas -v``), shared memory per block and the count of tensor-core
   instructions of their route in their SASS (``cuobjdump``, where the
   toolkit has it): HMMA (``mma.sync``), or HGMMA (``wgmma``) for
   B2f-bf16 and B2w-bf16 (which must have no HMMA); a count of 0 fails
   the run.
3. Holds each kernel against its plain PyTorch version on the card, in
   f32 with TF32 off, at the main paths' shapes, and times both with
   CUDA events (B1 also by the profiler's device time), beside the kernel's bound (the least time for its work:
   bytes at 3.35 TB/s, or its products as three TF32 tensor-core passes
   at 495 TFLOP/s, the fastest f32-accurate route):
     B1 (IIR cascade): the chain entry, 60 Hz notch then 4-40 Hz
        band-pass zero-phase in one launch, on (B, 64, 800) for B = 1, 8,
        64, 350 and on the corpus's 336,000 rows (there also with 8 and 16
        lanes a row); the causal entry on the band-pass's padded length,
        y and zf; tolerance rtol 1e-4, atol 1e-4 * max|ref| (the JAX
        package's Pallas IIR tolerance, tests/test_pallas.py). Bounds: x
        read and y written once, or the f32 FMAs of both passes.
     B2f (Conv4Layers head forward, through the model-axis entry at
        M = 1) at full width; rtol 1e-4, atol 1e-5.
     B2w / B2x (head weight / input gradients) at full width, M = 2,
        B = 8 and M = 1, B = 64, against the plain autograd backward;
        rtol 1e-4, atol 1e-4 * max|ref| per tensor (sums over B*N*t1
        terms). B2x also at M = 1, B = 16 and 100 (the attribution CLIs'
        batches), against its plain version alone (autograd w.r.t. x with
        the weights held out), timed also by the profiler's device time,
        with its share of the bound and of the ``mma.sync`` TF32 floor.
        Then all three at the training run's M = 75 and its
        batch sizes 64, 24 (the ragged tail) and 35 (validation): the
        full launches' outputs for models 0, 37 and 74 against the plain
        version on those models' operands, at the same tolerances; B2f,
        B2w and B2x are timed alone at M = 75, B = 64, with their rates and
        their shares of the bound and of the ``mma.sync`` TF32 floor.
     B2f-bf16 / B2w-bf16 (the training path's default precision: bf16 x,
        f32 weights, f32 outputs) at (M, B) = (2, 8), (1, 64) and the
        training run's M = 75 at 64, 24 and 35 (models 0, 37, 74), against
        the plain bf16 versions: |err| <= 3e-4 (features) and 1e-3 (weight
        gradients) x max|ref| per tensor (tests/test_torch_cuda.py says
        why); B2f-bf16's two runs at M = 75, B = 64 bit-identical; timed
        by CUDA events, with their bound (x at 2 bytes a sample; one bf16
        tensor-core pass at 989 TFLOP/s) and their share of their route's
        floor (``wgmma`` m64n32k16 for both, B2f-bf16's on its own work:
        the first conv once per trial); B2f-bf16's cycles a (trial, zone)
        item and B2w-bf16's a (trial, window, zone) unit by phase at M = 75,
        B = 64 (their debug instantiations, ``b2f_timing.py``'s and
        ``b2w_timing.py``'s splits).
     Head geometries the kernels are not built for, which the wrappers
        launch on zero-padded or split operands: dim_cnn = 8 trained in
        f32 and bf16 and a bf16 forward at T = 1001 (N = 7 windows: two
        B2f-bf16 groups), against the CPU, with the kernels' launches and
        the adapted calls counted.
4. Serving path: full-width FAST weights from a numpy seed are written
   as a checkpoint, the port's ``cli.serve`` serves it over TCP, and a
   ``DecoderClient`` sends INFO, DECODE at B = 1 and B = 8, RELOAD to a
   second checkpoint, and DECODE again. The posteriors must be finite,
   sum to 1 and match the port's plain CPU forward of the same weights
   (rtol 1e-4, atol 1e-5), every decode must have made exactly one B1
   chain launch, and B2f must have launched. In process: device busy
   time and ``cudaLaunchKernel`` calls per decode (profiler).
5. Training path: the port's ``cli.train_fast`` on a 15-subject x 350-trial
   synthetic corpus, 75 stacked full-width models, 2 epochs, at its
   default precision (bf16: B2f-bf16 and B2w-bf16 must have launched, and
   no f32 head kernel) and with ``--precision f32`` (B2f and B2w, no
   bf16 one); B2x never. The history must be finite, the result tree
   complete, and one subject's ``best_subject.npz`` must reproduce its
   ``test_predictions.csv`` on the card, with logits that match the plain
   CPU forward (f32: rtol 1e-4, atol 1e-5; bf16: 3e-3 in relative L2).
   Every path at the shipped geometry (serving, training in each
   precision, the bf16 trajectory, attribution) must launch the head's
   kernels on its operands as they are (``adapted`` 0).
   Then one step at M = 75, B = 64 in each precision under the profiler
   (the bf16 one must run B2f-bf16 and B2w-bf16 and no f32 head kernel),
   and a 2-subject x 10-trial run on the card against the same run on the
   CPU (plain path), in each precision.
6. Attribution path, on a trained checkpoint, every input gradient
   through B2x (and none through B2w): integrated gradients (8 trials x
   16 steps) against the plain CPU path; expected gradients at the
   global-explain CLI's shape (100 trials x 16 samples, 200 background
   trials), its host seconds and B2x's share of its device time, against
   the CPU on 4 trials with the same draws; ``attribution_for_predictions``
   at the explain CLI's shape (16 trials x 32 samples, 64 background
   trials), its predictions against the CPU's.

The line before the last is a JSON object of the kernels; the last line
is ``{"ok": true, "device": {...}}``. Any failed phase raises, and the
script exits non-zero. Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from scipy.signal import tf2sos
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from imagined_speech_decoding_tpu_torch.cli import train_fast
from imagined_speech_decoding_tpu_torch.cli.serve import build_parser, build_server
from imagined_speech_decoding_tpu_torch.config import FASTConfig, TrainConfig
from imagined_speech_decoding_tpu_torch.data.constants import SFREQ
from imagined_speech_decoding_tpu_torch.data.synthetic import synthetic_corpus, synthetic_trials
from imagined_speech_decoding_tpu_torch.explain.attribution import (
    attribution_for_predictions,
    expected_gradients,
    expected_gradients_from_draws,
    integrated_gradients,
)
from imagined_speech_decoding_tpu_torch.models.fast import FAST
from imagined_speech_decoding_tpu_torch.ops.cuda import _lib
from imagined_speech_decoding_tpu_torch.ops.cuda.conv4head import (
    BWD_W_BF16_PHASES,
    FWD_BF16_PHASES,
    KERNEL_TAPS,
    _launch_bwd_w,
    _launch_fwd,
    conv4head_bwd_plain,
    conv4head_bwd_w,
    conv4head_bwd_x,
    conv4head_bwd_x_plain,
    fused_conv4_head,
    fused_conv4_head_plain,
)
from imagined_speech_decoding_tpu_torch.ops.cuda.iir import (
    _launch_causal,
    _launch_chain,
    lanes_for,
    prepare_filter,
    sosfilt_time_major,
    sosfilt_time_major_plain,
    sosfiltfilt_chain,
    sosfiltfilt_chain_plain,
)
from imagined_speech_decoding_tpu_torch.ops.filters import butter_sos, notch_ba
from imagined_speech_decoding_tpu_torch.server import DecoderClient
from imagined_speech_decoding_tpu_torch.serving import make_online_decoder
from imagined_speech_decoding_tpu_torch.train import engine
from imagined_speech_decoding_tpu_torch.train.artifacts import load_predictions_csv
from imagined_speech_decoding_tpu_torch.train.checkpoint import load_model_npz, save_model_npz
from imagined_speech_decoding_tpu_torch.train.cv import build_cv_index_stack, stacked_init
from imagined_speech_decoding_tpu_torch.transplant import (
    from_jax_params,
    init_jax_layout_params,
    to_jax_params,
)

SEED = 0
IIR_RTOL = 1e-4  # atol = IIR_RTOL * max|ref|
HEAD_RTOL, HEAD_ATOL = 1e-4, 1e-5
POST_RTOL, POST_ATOL = 1e-4, 1e-5
BWD_RTOL = 1e-4  # atol = BWD_RTOL * max|ref| per gradient tensor
TRAJ_RTOL, TRAJ_ATOL = 1e-4, 1e-5  # card vs CPU training trajectory
TRAJ_NOISE_SHARE = 1e-4  # parameter elements allowed past it, each within the summed lr
MAIN_BATCH = 8  # the serving path's largest request; the JSON line's forward shapes
REQUESTS = 100  # timed DECODE requests per batch size
TRAIN_SUBJECTS, TRAIN_TRIALS, TRAIN_EPOCHS = 15, 350, 2  # 75 models, 280 + 70 trials each
TRAIN_BATCH = 64
# The head's batch sizes in that run: 280 train trials at batch 64 are
# 4 x 64 + a 24-trial tail; 70 validation trials are 2 x 35.
TRAIN_STEP_BATCHES = (TRAIN_BATCH, TRAIN_TRIALS * 4 // 5 % TRAIN_BATCH,
                      engine.eval_batch_size_for(TRAIN_TRIALS // 5, TRAIN_BATCH))
BWD_SHAPES = ((2, 8), (1, 64))  # (M, B) of the B2w comparisons; JSON line: the first
# (M, B) of B2x's: the attribution CLIs' batches too; JSON line: the last,
# expected gradients' batch in the attribution phase.
X_SHAPES = ((2, 8), (1, 16), (1, 64), (1, 100))
IG_TRIALS, IG_STEPS = 8, 16
EG_TRIALS, EG_SAMPLES, EG_BACKGROUND = 100, 16, 200  # cli/global_explain.py's defaults
EG_CPU_TRIALS = 4  # trials of expected gradients held against the CPU
AFP_TRIALS, AFP_SAMPLES, AFP_BACKGROUND = 16, 32, 64  # cli/explain_fast.py's defaults
B2X_KERNELS = "conv4head_bwd_x_kernel|sum_partials_kernel"  # B2x and its partial pass

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, 700 W):
TF32_FLOPS = 495e12  # tensor cores, TF32
F32_FLOPS = 67e12  # CUDA cores, f32
HBM_BYTES_S = 3.35e12
# The rate of mma.sync m16n8k8 TF32 on an H100 80GB HBM3 at 700 W, measured by
# mma_tf32_ceiling.py: the floor of B2f's and B2w's route (three passes per product).
MMA_SYNC_TF32_FLOPS = 323.2e12
BF16_FLOPS = 989e12  # tensor cores, bf16 dense
# The rate of mma.sync m16n8k16 bf16 on an H100 80GB HBM3 at 700 W, measured by
# mma_tf32_ceiling.py --mode bf16: the floor of B2f-bf16's route (one pass).
MMA_SYNC_BF16_FLOPS = 642.3e12
# The rate of wgmma m64n32k16 bf16 with both operands in shared memory, on the same card,
# measured by mma_tf32_ceiling.py --mode wgmma: the floor of B2w-bf16's and B2f-bf16's route.
WGMMA_N32_FLOPS = 653.0e12
BF16_FWD_REL, BF16_BWD_REL = 3e-4, 1e-3  # atol = REL * max|ref| per tensor (bf16 kernels)
BF16_LOGITS_L2 = 3e-3  # bf16 logits and gradients, card vs CPU, relative L2
BF16_SHAPES = ((2, 8), (1, 64))  # (M, B) of the bf16 kernel comparisons; JSON line: the last
IIR_FMA_PER_SECTION = 5  # per sample: csrc/iir.cu's transposed direct form II


def bound_ms(nbytes: float, flops: float, flops_s: float):
    """Least time the card could take for the work, and what sets it:
    each input read once and each output written once at the memory rate,
    or the operations at the peak of their route."""
    by_bytes, by_ops = 1e3 * nbytes / HBM_BYTES_S, 1e3 * flops / flops_s
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def iir_bound(rows: int, t_len: int = 854, sections: int = 4):
    """B1's causal entry on (t_len, rows): x, zi read and y, zf written; f32 FMAs."""
    nbytes = 4 * 2 * rows * (t_len + 2 * sections)
    return bound_ms(nbytes, 2 * IIR_FMA_PER_SECTION * sections * t_len * rows, F32_FLOPS)


def chain_bound(rows: int, filters, t_len: int = 800):
    """B1's chain entry on (rows, t_len): x read and y written once; f32
    FMAs of both passes of every filter at its extended length (the
    kernel's fix-up work does not count)."""
    flops = sum(2 * 2 * IIR_FMA_PER_SECTION * f.n_sections * (t_len + 2 * f.padlen)
                for f in filters)
    return bound_ms(4 * 2 * rows * t_len, flops * rows, F32_FLOPS)


HEAD_WEIGHT_FLOATS = 256 * 320 + 256 + 2 * 8 * 32 * 160  # w12, b12, w3, w4 of one model


def head_bound(fma_per_unit: int, m: int, b: int, n_out_floats: int, reads_g: bool = True):
    """A head kernel at full width (C = 64, T = 800, 5 windows, 8 zones,
    O = 32, K = 5) on M models of B trials. The fastest f32-accurate route
    for its products is three TF32 tensor-core passes: 3 x 2 FLOPs per FMA
    at the TF32 peak. Reads x, the weights and (backward) the cotangent g;
    writes ``n_out_floats``."""
    n_in = m * b * 64 * 800 + m * HEAD_WEIGHT_FLOATS + reads_g * m * b * 5 * 256
    return bound_ms(4 * (n_in + n_out_floats), 3 * 2 * fma_per_unit * m * b * 5 * 8, TF32_FLOPS)


def head_bound_bf16(fma_per_unit: int, m: int, b: int, n_out_floats: int,
                    reads_g: bool = True):
    """``head_bound`` for a bf16 kernel: x at 2 bytes a sample, the f32
    weights, cotangent and outputs at 4; its products as one bf16
    tensor-core pass at the bf16 peak."""
    nbytes = 2 * m * b * 64 * 800 + 4 * (m * HEAD_WEIGHT_FLOATS + reads_g * m * b * 5 * 256
                                         + n_out_floats)
    return bound_ms(nbytes, 2 * fma_per_unit * m * b * 5 * 8, BF16_FLOPS)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call between CUDA events on the current stream."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel: str, iters: int) -> float:
    """Mean device time per call of the kernels whose name matches the
    regular expression ``kernel`` (profiler): the kernels' own time,
    without the host's time between back-to-back calls, which ``cuda_ms``
    includes."""
    fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(iters):
            fn()

    total = sum(e.self_device_time_total for e in profiled(calls, need=(kernel,))
                if re.search(kernel, e.key))
    return total / 1e3 / iters


def profiled(fn, cpu: bool = False, need=()):
    """``fn()`` under the profiler (the device's activity, and the host's if
    ``cpu``): its ``key_averages()``. ``need`` holds regular expressions of
    kernels that ``fn`` launches. The profiler now and then loses device
    records: a whole session's (seen once on the H100, after a run of
    sessions), or one kernel's (B2f-bf16 in the bf16 training step, seen once
    on an H100 whose launch counter showed the launch). A session without
    device time, or without a record of each kernel in ``need``, is profiled
    again, up to three times."""
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    for _ in range(3):
        with profile(activities=activities) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        timed = [e.key for e in events if e.self_device_time_total > 0]
        if timed and all(any(re.search(k, key) for key in timed) for k in need):
            return events
    raise RuntimeError(f"the profiler recorded no device time, or none of {list(need)}, "
                       "in three sessions")


def check_close(name: str, got: torch.Tensor, ref: torch.Tensor, rtol: float, atol: float) -> float:
    err = float((got - ref).abs().max())
    torch.testing.assert_close(got, ref, rtol=rtol, atol=atol, msg=lambda m: f"{name}: {m}")
    return err


CORPUS_ROWS = TRAIN_SUBJECTS * TRAIN_TRIALS * 64  # 336,000 rows: the corpus's preprocessing
CHAIN_LANES = (8, 16, 32)  # lanes a row, compared at the corpus size


def decode_chain():
    """The online decoder's filters: the 60 Hz notch, then the 4-40 Hz band-pass."""
    return [prepare_filter(tf2sos(*notch_ba(SFREQ, 60.0))),
            prepare_filter(butter_sos(SFREQ, 4.0, 40.0))]


def phase_iir(dev, rng):
    """B1 against its plain version. The chain entry (the decode's notch +
    band-pass, zero-phase, one launch) at B = 1, 8, 64 and 350 trials of 64
    channels and at the corpus's 336,000 rows, there also with 8 and 16
    lanes a row; the causal entry alone on the band-pass's padded length,
    y and zf. ``ms`` is the CUDA-event time a call over back-to-back calls,
    as for every kernel; ``device_ms`` the profiler's device time a launch."""
    chain = decode_chain()
    pads = tuple(f.padlen for f in chain)
    band = chain[1].sos
    rows = {}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for b in (1, MAIN_BATCH, 64, 350, CORPUS_ROWS // 64):
        if b * 64 == CORPUS_ROWS:  # 1.07 GB: drawn on the card
            x = torch.randn((b, 64, 800), generator=gen, device=dev)
        else:
            x = torch.tensor(rng.normal(size=(b, 64, 800)).astype(np.float32), device=dev)
        ref = sosfiltfilt_chain_plain(chain, x)
        scale = IIR_RTOL * float(ref.abs().max())
        err = check_close(f"B1 chain R={b * 64}", sosfiltfilt_chain(chain, x), ref, IIR_RTOL, scale)
        bound, bound_by = chain_bound(b * 64, chain)
        big = b * 64 == CORPUS_ROWS
        row = rows[b] = {
            "bound_ms": bound, "bound_by": bound_by, "max_abs_err": err,
            "ms": cuda_ms(lambda: sosfiltfilt_chain(chain, x), 5 if big else 50),
            "device_ms": device_ms(lambda: sosfiltfilt_chain(chain, x),
                                   "sosfiltfilt_chain_kernel", 5 if big else 50),
            "plain_ms": cuda_ms(lambda: sosfiltfilt_chain_plain(chain, x), 1,
                                warmup=0 if big else 1),
        }
        print(f"B1 chain R={b * 64:<6} (B={b}) notch + band-pass zero-phase, one launch, "
              f"{lanes_for(b * 64)} lanes a row: kernel {row['ms']:.4f} ms a call back to back "
              f"(CUDA events), {row['device_ms']:.4f} ms on the device (profiler), plain "
              f"{row['plain_ms']:.3f} ms, max|err| {err:.3g}, bound {bound:.4f} ms ({bound_by}, "
              f"{bound / row['ms']:.1%} reached; {bound / row['device_ms']:.1%} of the device "
              f"time)", flush=True)
        if big:
            for lanes in CHAIN_LANES:
                check_close(f"B1 chain R={b * 64} lanes={lanes}",
                            _launch_chain(chain, x, pads, lanes), ref, IIR_RTOL, scale)
                ms = device_ms(lambda: _launch_chain(chain, x, pads, lanes),
                               "sosfiltfilt_chain_kernel", 5)
                print(f"B1 chain R={b * 64} with {lanes:>2} lanes a row: {ms:.4f} ms on the "
                      f"device ({bound / ms:.1%} of the bound)", flush=True)
            del x, ref
            torch.cuda.empty_cache()
            continue
        xt = torch.tensor(rng.normal(size=(854, b * 64)).astype(np.float32), device=dev)
        zi = torch.tensor(rng.normal(size=(8, b * 64)).astype(np.float32), device=dev)
        y_ref, zf_ref = sosfilt_time_major_plain(band, xt, zi)
        y, zf = sosfilt_time_major(band, xt, zi)
        k_err = max(check_close(f"B1 causal R={b * 64} {name}", got, want, IIR_RTOL,
                                IIR_RTOL * float(want.abs().max()))
                    for name, got, want in (("y", y, y_ref), ("zf", zf, zf_ref)))
        c_bound, c_bound_by = iir_bound(b * 64)
        row["causal"] = {
            "bound_ms": c_bound, "bound_by": c_bound_by, "max_abs_err": k_err,
            "ms": cuda_ms(lambda: sosfilt_time_major(band, xt, zi), 50),
            "device_ms": device_ms(lambda: sosfilt_time_major(band, xt, zi),
                                   "sosfilt_time_major_kernel", 50),
            "plain_ms": cuda_ms(lambda: sosfilt_time_major_plain(band, xt, zi), 2),
        }
        c = row["causal"]
        chain_alt = {g: device_ms(lambda: _launch_chain(chain, x, pads, g),
                                  "sosfiltfilt_chain_kernel", 20) for g in (16, 32)}
        causal_alt = {g: device_ms(lambda: _launch_causal(band, xt, zi, g),
                                   "sosfilt_time_major_kernel", 20) for g in (1, 16, 32)}
        print(f"B1 R={b * 64} lanes a row -> device ms: chain "
              f"{json.dumps({g: round(v, 4) for g, v in chain_alt.items()})}, causal "
              f"{json.dumps({g: round(v, 4) for g, v in causal_alt.items()})}", flush=True)
        print(f"B1 causal (854, {b * 64}) band-pass pass with zi and zf, "
              f"{lanes_for(b * 64, causal=True)} lanes a row: kernel {c['ms']:.4f} ms a call back "
              f"to back (CUDA events), {c['device_ms']:.4f} ms on the device (profiler), plain "
              f"{c['plain_ms']:.3f} ms, max|err| {k_err:.3g} (y and zf), bound {c_bound:.4f} ms "
              f"({c_bound_by}, {c_bound / c['ms']:.1%} reached; {c_bound / c['device_ms']:.1%} of "
              f"the device time)", flush=True)
    return rows


def phase_head(model, dev, rng):
    """B2f against its plain version at full width, one model (M = 1)."""
    cfg = model.cfg
    ops = model.head.fused_weights()
    rows = {}
    for b in (1, MAIN_BATCH, 64):
        x = torch.tensor(rng.normal(size=(1, b, 64, 800)).astype(np.float32), device=dev)
        ref = fused_conv4_head_plain(x, *ops, cfg.window_len, cfg.slide_step)
        got = fused_conv4_head(x, *ops, cfg.window_len, cfg.slide_step)
        err = check_close(f"B2 B={b}", got, ref, HEAD_RTOL, HEAD_ATOL)
        bound, bound_by = head_bound(HEAD_FMA_FWD, 1, b, b * 5 * 256, reads_g=False)
        rows[b] = {
            "bound_ms": bound, "bound_by": bound_by,
            "ms": cuda_ms(lambda: fused_conv4_head(x, *ops, cfg.window_len, cfg.slide_step), 50),
            "plain_ms": cuda_ms(
                lambda: fused_conv4_head_plain(x, *ops, cfg.window_len, cfg.slide_step), 20),
            "max_abs_err": err,
        }
        print(f"B2 B={b:<4} head forward: kernel {rows[b]['ms']:.4f} ms, plain "
              f"{rows[b]['plain_ms']:.4f} ms, max|err| {err:.3g}, bound {bound:.4f} ms "
              f"({bound_by}, {bound / rows[b]['ms']:.1%} reached)", flush=True)
    return rows


def phase_serving(cfg, params1, params2, rng, workdir):
    """Serve checkpoints through the port's CLI and decode over TCP."""
    ckpt1 = os.path.join(workdir, "FAST", "sub-01", "best_subject.npz")
    ckpt2 = os.path.join(workdir, "FAST", "sub-02", "best_subject.npz")
    save_model_npz(ckpt1, params1, {"head": {}})
    save_model_npz(ckpt2, params2, {"head": {}})
    server = build_server(build_parser().parse_args(["--checkpoint", ckpt1, "--port", "0"]))
    # One untimed warm-up request per batch size, then REQUESTS timed ones.
    sizes = [1, MAIN_BATCH] + [1] * REQUESTS + [MAIN_BATCH] * REQUESTS
    batches = [rng.normal(size=(b, 64, 800)).astype(np.float32) for b in sizes]

    reset_launches()
    latencies, posts = [], []
    with server, DecoderClient(*server.address) as client:
        info = client.info()
        for x in batches:
            t0 = time.perf_counter()
            posts.append(client.decode(x))
            latencies.append(time.perf_counter() - t0)
        client.reload(ckpt2)
        post_reloaded = client.decode(batches[-1])
    launches = read_launches()
    print(f"serving path: INFO {json.dumps(info)}", flush=True)
    print(f"serving path: kernel launches during the requests {launches}", flush=True)
    decodes = len(batches) + 1
    if launches["iir_chain"] != decodes or launches["iir"] != 0:
        raise RuntimeError(f"{decodes} decodes must make one B1 chain launch each and no "
                           f"causal one: {launches}")
    if launches["conv4head_fwd"] < 1:
        raise RuntimeError("the serving path never launched the conv4head_fwd kernel")
    require_unadapted(launches, "serving")
    if info["device"] != "cuda" or info["n_channels"] != 64 or info["n_classes"] != cfg.n_classes:
        raise RuntimeError(f"unexpected INFO {info}")

    verify_against_cpu(cfg, params1, params2, batches, posts, post_reloaded)
    for b in (1, MAIN_BATCH):
        ms = [1e3 * t for t, x in zip(latencies[2:], batches[2:]) if x.shape[0] == b]
        p50, p90, p99 = np.percentile(ms, [50, 90, 99])
        print(f"serving path: DECODE B={b} over TCP, closed loop, one client, host clock: "
              f"p50 {p50:.3f} ms, p90 {p90:.3f} ms, p99 {p99:.3f} ms, max {max(ms):.3f} ms "
              f"({len(ms)} requests)", flush=True)
    print("serving path: posteriors finite, sum to 1, match the plain CPU forward "
          f"(rtol {POST_RTOL}, atol {POST_ATOL}); RELOAD swapped the weights", flush=True)
    return launches


def verify_against_cpu(cfg, params1, params2, batches, posts, post_reloaded) -> None:
    """The served posteriors against the port's plain path on the CPU with
    the same weights and inputs, all requests' trials in one batch (trials
    never interact); the RELOADed ones against the second weights."""
    cpu_decode = make_online_decoder(FAST(cfg, device="cpu"), params1)
    check_posteriors(np.concatenate(posts), cpu_decode(np.concatenate(batches)))
    cpu_decode.swap_weights(params2)
    check_posteriors(post_reloaded, cpu_decode(batches[-1]))
    if np.allclose(post_reloaded, posts[-1]):
        raise RuntimeError("RELOAD did not change the served posteriors")


def check_posteriors(post: np.ndarray, ref: np.ndarray) -> None:
    if post.shape != ref.shape or not np.isfinite(post).all():
        raise RuntimeError(f"bad posteriors: shape {post.shape}, finite {np.isfinite(post).all()}")
    np.testing.assert_allclose(post.sum(-1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(post, ref, rtol=POST_RTOL, atol=POST_ATOL)


def phase_device_time(cfg, params, dev, rng):
    """In-process decode (no TCP): host clock, CUDA-event span, and the
    profiler's device time by kernel."""
    decode = make_online_decoder(FAST(cfg, device=dev), params)
    for b in (1, MAIN_BATCH):
        x = rng.normal(size=(b, 64, 800)).astype(np.float32)
        decode(x)
        host, span = [], []
        for _ in range(20):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            decode(x)  # ends in a device-to-host copy, so the device is done
            end.record()
            host.append(1e3 * (time.perf_counter() - t0))
            end.synchronize()
            span.append(start.elapsed_time(end))
        # Kernels and copies are events of their own; an op's device time
        # repeats its kernels', so only the device-side events are summed.
        events = profiled(lambda: [decode(x) for _ in range(5)], cpu=True)
        by_device = sorted(((e.self_device_time_total / 5e3, e.count // 5, e.key)
                            for e in events if e.device_type != DeviceType.CPU), reverse=True)
        by_host = sorted(((e.self_cpu_time_total / 5e3, e.count // 5, e.key)
                          for e in events if e.device_type == DeviceType.CPU), reverse=True)
        busy = sum(ms for ms, _, _ in by_device)
        device_ops = sum(calls for _, calls, _ in by_device)
        launches = sum(calls for _, calls, key in by_host if key == "cudaLaunchKernel")
        launches_ex = sum(calls for _, calls, key in by_host if key == "cudaLaunchKernelExC")
        print(f"decode B={b} in process: host p50 {np.median(host):.3f} ms; CUDA-event span "
              f"p50 {np.median(span):.3f} ms; profiler device time {busy:.3f} ms per decode "
              f"over {device_ops} kernels and copies (device idle "
              f"{1 - busy / np.median(span):.0%} of the span); {launches} cudaLaunchKernel "
              f"and {launches_ex} cudaLaunchKernelExC calls per decode", flush=True)
        for ms, calls, key in by_device[:8]:
            print(f"    device {ms:9.4f} ms  {calls:4d} calls  {key[:70]}", flush=True)
        for ms, calls, key in by_host[:8]:
            print(f"    host   {ms:9.4f} ms  {calls:4d} calls  {key[:70]}", flush=True)


HEAD_FMA_FWD = 5_038_080  # per (trial, window, zone) at full width: conv12 2.52 M + tails 2 x 1.26 M
# B2f-bf16's own multiply-adds per (trial, zone): the first conv once over the 746 h1 columns
# its 5 windows use (32 x 320 x 746 = 7.64 M) and the tails (5 x 2 x 1.26 M): 20% fewer than
# 5 x HEAD_FMA_FWD; with the 64-row tiles' padding it issues 640 wgmma of 32,768 (20.97 M).
FWD_BF16_FMA_ITEM = 32 * 320 * 746 + 5 * 2 * 32 * 160 * 246
FWD_BF16_FMA_TILED = 640 * 64 * 32 * 16
HEAD_FMA_BWD_W = 12_595_200  # recompute 5.04 M + dh2, dh1, dw4, dw3 1.26 M each + dw12 2.52 M
HEAD_FMA_BWD_X = 10_076_160  # recompute 5.04 M + dh2, dh1 1.26 M each + dx 2.52 M


def phase_head_backward(cfg, dev, rng):
    """B2w and B2x against their plain versions at full width, then B2f
    and B2w alone at the training step's shape."""
    geo = (cfg.window_len, cfg.slide_step)
    feat = cfg.n_zones * cfg.dim_cnn
    rows = {}
    for m, b in X_SHAPES:
        model = FAST(cfg, n_models=m, device=dev)
        model.load_state_dict(from_jax_params(init_jax_layout_params(cfg, SEED, m)))
        with torch.no_grad():
            ops = model.head.fused_weights()
        x = torch.tensor(rng.normal(size=(m, b, 64, 800)).astype(np.float32), device=dev)
        g = torch.tensor(rng.normal(size=(m, b, cfg.n_tokens, feat)).astype(np.float32),
                         device=dev)
        r = rows[(m, b)] = {}
        if (m, b) in BWD_SHAPES:
            ref = conv4head_bwd_plain(g, x, *ops, *geo)
            got = (conv4head_bwd_x(g, x, *ops, *geo), *conv4head_bwd_w(g, x, *ops, *geo))
            errs = {name: check_close(f"B2 backward M={m} B={b} {name}", a, r_, BWD_RTOL,
                                      BWD_RTOL * float(r_.abs().max()))
                    for name, a, r_ in zip(("dx", "dw12", "db12", "dw3", "dw4"), got, ref)}
            r.update(w_ms=cuda_ms(lambda: conv4head_bwd_w(g, x, *ops, *geo), 10),
                     plain_ms=cuda_ms(lambda: conv4head_bwd_plain(g, x, *ops, *geo), 3),
                     w_err=max(errs[k] for k in ("dw12", "db12", "dw3", "dw4")),
                     w_bound=head_bound(HEAD_FMA_BWD_W, m, b, m * HEAD_WEIGHT_FLOATS))
            print(f"B2w M={m} B={b:<3} weight grads: kernel {r['w_ms']:.3f} ms, max|err| "
                  f"{r['w_err']:.3g}, bound {r['w_bound'][0]:.3f} ms ({r['w_bound'][1]}, "
                  f"{r['w_bound'][0] / r['w_ms']:.1%} reached); plain autograd backward (all "
                  f"five) {r['plain_ms']:.3f} ms; per tensor "
                  f"{json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})}", flush=True)
        ref_x = conv4head_bwd_x_plain(g, x, *ops, *geo)
        r["x_err"] = check_close(f"B2x M={m} B={b}", conv4head_bwd_x(g, x, *ops, *geo), ref_x,
                                 BWD_RTOL, BWD_RTOL * float(ref_x.abs().max()))
        r["x_ms"] = cuda_ms(lambda: conv4head_bwd_x(g, x, *ops, *geo), 10)
        r["x_device_ms"] = device_ms(lambda: conv4head_bwd_x(g, x, *ops, *geo), B2X_KERNELS, 10)
        r["x_plain_ms"] = cuda_ms(lambda: conv4head_bwd_x_plain(g, x, *ops, *geo), 3)
        r["x_bound"] = head_bound(HEAD_FMA_BWD_X, m, b, m * b * 64 * 800)
        floor = 1e3 * 3 * 2 * m * b * cfg.n_tokens * cfg.n_zones * HEAD_FMA_BWD_X / MMA_SYNC_TF32_FLOPS
        bound = r["x_bound"][0]
        print(f"B2x M={m} B={b:<3} input grad: wrapper {r['x_ms']:.4f} ms a call (CUDA events: "
              f"the kernel, dxw and the overlap-add), kernel {r['x_device_ms']:.4f} ms on the "
              f"device (profiler), plain dx alone {r['x_plain_ms']:.3f} ms, max|err| "
              f"{r['x_err']:.3g}; bound {bound:.4f} ms ({r['x_bound'][1]}, {bound / r['x_ms']:.1%} "
              f"reached, {bound / r['x_device_ms']:.1%} of the device time); mma.sync floor "
              f"{floor:.4f} ms ({floor / r['x_device_ms']:.1%} of the device time)", flush=True)

    # The training run's own launches: M = 75 at its batch sizes (the
    # 64-trial steps, the ragged tail, the validation batch). The plain
    # autograd backward of all 75 models needs tens of GB, but the models
    # are independent: the full launches' outputs are held, model by model,
    # against the plain version on the first, a middle and the last
    # model's operands.
    m = TRAIN_SUBJECTS * 5
    model = FAST(cfg, n_models=m, device=dev)
    model.load_state_dict(from_jax_params(init_jax_layout_params(cfg, SEED, m)))
    with torch.no_grad():
        ops = model.head.fused_weights()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for b in TRAIN_STEP_BATCHES:
        x = torch.randn((m, b, 64, 800), generator=gen, device=dev)
        g = torch.randn((m, b, cfg.n_tokens, feat), generator=gen, device=dev)
        with torch.no_grad():
            out = fused_conv4_head(x, *ops, *geo)
        grads = (conv4head_bwd_x(g, x, *ops, *geo), *conv4head_bwd_w(g, x, *ops, *geo))
        errs = {"out": 0.0, "dx": 0.0, "dw12": 0.0, "db12": 0.0, "dw3": 0.0, "dw4": 0.0}
        for i in (0, m // 2, m - 1):
            one = [t[i : i + 1] for t in (g, x, *ops)]
            what = f"M={m} B={b} model {i}"
            ref = fused_conv4_head_plain(*one[1:], *geo)
            errs["out"] = max(errs["out"], check_close(f"B2f {what}", out[i : i + 1], ref,
                                                       HEAD_RTOL, HEAD_ATOL))
            for name, a, r in zip(("dx", "dw12", "db12", "dw3", "dw4"), grads,
                                  conv4head_bwd_plain(*one, *geo)):
                errs[name] = max(errs[name], check_close(f"B2 backward {what} {name}",
                                                         a[i : i + 1], r, BWD_RTOL,
                                                         BWD_RTOL * float(r.abs().max())))
        print(f"B2f / B2w / B2x at M={m} B={b:<3}: models 0, {m // 2} and {m - 1} of the full "
              f"launches match the plain version on their operands; max|err| "
              f"{json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})}", flush=True)
    x = torch.randn((m, TRAIN_BATCH, 64, 800), generator=gen, device=dev)
    g = torch.randn((m, TRAIN_BATCH, cfg.n_tokens, feat), generator=gen, device=dev)
    big = {"fwd_ms": cuda_ms(lambda: fused_conv4_head(x, *ops, *geo), 3),
           "w_ms": cuda_ms(lambda: conv4head_bwd_w(g, x, *ops, *geo), 3)}
    units = m * TRAIN_BATCH * cfg.n_tokens * cfg.n_zones
    fwd_bound = head_bound(HEAD_FMA_FWD, m, TRAIN_BATCH, m * TRAIN_BATCH * 5 * 256,
                           reads_g=False)
    w_bound = head_bound(HEAD_FMA_BWD_W, m, TRAIN_BATCH, m * HEAD_WEIGHT_FLOATS)
    fwd_floor, w_floor = (1e3 * 3 * 2 * units * fma / MMA_SYNC_TF32_FLOPS
                          for fma in (HEAD_FMA_FWD, HEAD_FMA_BWD_W))
    print(f"B2f / B2w alone at M={m} B={TRAIN_BATCH} (kernel only): B2f {big['fwd_ms']:.2f} ms "
          f"({units * HEAD_FMA_FWD / big['fwd_ms'] / 1e9:.2f} T FMA/s f32-equivalent; "
          f"bound {fwd_bound[0]:.2f} ms, {fwd_bound[1]}, {fwd_bound[0] / big['fwd_ms']:.1%} "
          f"reached; mma.sync floor {fwd_floor:.2f} ms, {fwd_floor / big['fwd_ms']:.1%} reached), "
          f"B2w {big['w_ms']:.2f} ms "
          f"({units * HEAD_FMA_BWD_W / big['w_ms'] / 1e9:.2f} T FMA/s f32-equivalent; bound "
          f"{w_bound[0]:.2f} ms, {w_bound[1]}, {w_bound[0] / big['w_ms']:.1%} reached; mma.sync "
          f"floor {w_floor:.2f} ms, {w_floor / big['w_ms']:.1%} reached)", flush=True)
    # B2x at the same shape: its own device time (it never runs in training).
    big["x_device_ms"] = device_ms(lambda: conv4head_bwd_x(g, x, *ops, *geo), B2X_KERNELS, 3)
    x_bound = head_bound(HEAD_FMA_BWD_X, m, TRAIN_BATCH, m * TRAIN_BATCH * 64 * 800)
    x_floor = 1e3 * 3 * 2 * units * HEAD_FMA_BWD_X / MMA_SYNC_TF32_FLOPS
    print(f"B2x alone at M={m} B={TRAIN_BATCH}: {big['x_device_ms']:.2f} ms on the device "
          f"({units * HEAD_FMA_BWD_X / big['x_device_ms'] / 1e9:.2f} T FMA/s f32-equivalent; "
          f"bound {x_bound[0]:.2f} ms, {x_bound[1]}, {x_bound[0] / big['x_device_ms']:.1%} "
          f"reached; mma.sync floor {x_floor:.2f} ms, {x_floor / big['x_device_ms']:.1%} "
          f"reached)", flush=True)
    return rows, big


def check_rel(name: str, got: torch.Tensor, ref: torch.Tensor, rel: float) -> float:
    """``check_close`` at atol ``rel * max|ref|``, rtol 0."""
    return check_close(name, got, ref, 0.0, rel * float(ref.abs().max()))


def compare_bf16(ops, x, g, geo, models, what: str) -> dict:
    """B2f-bf16 and B2w-bf16 once each on the stacked operands, their
    outputs for ``models`` held against the plain bf16 versions on those
    models' operands; the largest error per output."""
    with torch.no_grad():
        out = fused_conv4_head(x, *ops, *geo)
    dw = conv4head_bwd_w(g, x, *ops, *geo)
    errs = dict.fromkeys(("out", "dw12", "db12", "dw3", "dw4"), 0.0)
    for i in models:
        one = [t[i : i + 1] for t in (g, x, *ops)]
        errs["out"] = max(errs["out"], check_rel(
            f"B2f-bf16 {what} model {i}", out[i : i + 1],
            fused_conv4_head_plain(*one[1:], *geo), BF16_FWD_REL))
        for name, a, r in zip(("dw12", "db12", "dw3", "dw4"), dw,
                              conv4head_bwd_plain(*one, *geo)[1:]):
            errs[name] = max(errs[name], check_rel(f"B2w-bf16 {what} model {i} {name}",
                                                   a[i : i + 1], r, BF16_BWD_REL))
    return errs


def phase_bf16_kernels(cfg, dev, rng):
    """B2f-bf16 and B2w-bf16 against their plain bf16 versions at full
    width, timed; then at the training run's M = 75 and its batch sizes,
    and alone at M = 75, B = 64."""
    geo = (cfg.window_len, cfg.slide_step)
    feat = cfg.n_zones * cfg.dim_cnn
    rows = {}
    for m, b in BF16_SHAPES:
        model = FAST(cfg, n_models=m, device=dev)
        model.load_state_dict(from_jax_params(init_jax_layout_params(cfg, SEED, m)))
        with torch.no_grad():
            ops = model.head.fused_weights()
        x = torch.tensor(rng.normal(size=(m, b, 64, 800)).astype(np.float32),
                         device=dev).to(torch.bfloat16)
        g = torch.tensor(rng.normal(size=(m, b, cfg.n_tokens, feat)).astype(np.float32),
                         device=dev)
        errs = compare_bf16(ops, x, g, geo, range(m), f"M={m} B={b}")
        r = rows[(m, b)] = {
            "fwd_err": errs["out"], "w_err": max(errs[k] for k in ("dw12", "db12", "dw3", "dw4")),
            "fwd_ms": cuda_ms(lambda: fused_conv4_head(x, *ops, *geo), 20),
            "fwd_plain_ms": cuda_ms(lambda: fused_conv4_head_plain(x, *ops, *geo), 3),
            "w_ms": cuda_ms(lambda: conv4head_bwd_w(g, x, *ops, *geo), 10),
            "w_plain_ms": cuda_ms(lambda: conv4head_bwd_plain(g, x, *ops, *geo), 3),
            "fwd_bound": head_bound_bf16(HEAD_FMA_FWD, m, b, m * b * 5 * 256, reads_g=False),
            "w_bound": head_bound_bf16(HEAD_FMA_BWD_W, m, b, m * HEAD_WEIGHT_FLOATS),
        }
        for k, name in (("fwd", "B2f-bf16 forward"), ("w", "B2w-bf16 weight grads")):
            bound, by = r[f"{k}_bound"]
            print(f"{name} M={m} B={b:<3}: kernel {r[f'{k}_ms']:.4f} ms, plain bf16 "
                  f"{r[f'{k}_plain_ms']:.3f} ms, max|err| {r[f'{k}_err']:.3g}, bound {bound:.4f} ms "
                  f"({by}, {bound / r[f'{k}_ms']:.1%} reached)", flush=True)
        print(f"    per tensor max|err| {json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})}",
              flush=True)

    m = TRAIN_SUBJECTS * 5
    model = FAST(cfg, n_models=m, device=dev)
    model.load_state_dict(from_jax_params(init_jax_layout_params(cfg, SEED, m)))
    with torch.no_grad():
        ops = model.head.fused_weights()
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    for b in TRAIN_STEP_BATCHES:
        x = torch.randn((m, b, 64, 800), generator=gen, device=dev).to(torch.bfloat16)
        g = torch.randn((m, b, cfg.n_tokens, feat), generator=gen, device=dev)
        errs = compare_bf16(ops, x, g, geo, (0, m // 2, m - 1), f"M={m} B={b}")
        print(f"B2f-bf16 / B2w-bf16 at M={m} B={b:<3}: models 0, {m // 2} and {m - 1} of the full "
              f"launches match the plain bf16 version on their operands; max|err| "
              f"{json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})}", flush=True)
    x = torch.randn((m, TRAIN_BATCH, 64, 800), generator=gen, device=dev).to(torch.bfloat16)
    g = torch.randn((m, TRAIN_BATCH, cfg.n_tokens, feat), generator=gen, device=dev)
    with torch.no_grad():
        first = fused_conv4_head(x, *ops, *geo)
        if not torch.equal(fused_conv4_head(x, *ops, *geo), first):
            raise RuntimeError(f"B2f-bf16 at M={m} B={TRAIN_BATCH}: two runs differ in their bits")
    print(f"B2f-bf16 at M={m} B={TRAIN_BATCH}: two runs are bit-identical", flush=True)
    big = {"fwd_ms": cuda_ms(lambda: fused_conv4_head(x, *ops, *geo), 5),
           "w_ms": cuda_ms(lambda: conv4head_bwd_w(g, x, *ops, *geo), 5)}
    units = m * TRAIN_BATCH * cfg.n_tokens * cfg.n_zones
    items = m * TRAIN_BATCH * cfg.n_zones
    for k, fma, bound, name, route, rate in (
            ("fwd", FWD_BF16_FMA_ITEM * items / units,
             head_bound_bf16(HEAD_FMA_FWD, m, TRAIN_BATCH, m * TRAIN_BATCH * 5 * 256,
                             reads_g=False), "B2f-bf16", "wgmma m64n32k16", WGMMA_N32_FLOPS),
            ("w", HEAD_FMA_BWD_W, head_bound_bf16(HEAD_FMA_BWD_W, m, TRAIN_BATCH,
                                                  m * HEAD_WEIGHT_FLOATS), "B2w-bf16",
             "wgmma m64n32k16", WGMMA_N32_FLOPS)):
        ms = big[f"{k}_ms"]
        floor = 1e3 * 2 * units * fma / rate
        big[f"{k}_bound"], big[f"{k}_floor"] = bound, floor
        print(f"{name} alone at M={m} B={TRAIN_BATCH} (kernel only): {ms:.2f} ms "
              f"({units * fma / ms / 1e9:.2f} T FMA/s of its own work; bound {bound[0]:.2f} ms, "
              f"{bound[1]}, {bound[0] / ms:.1%} reached; {route} floor on its own work "
              f"{floor:.2f} ms, {floor / ms:.1%} reached)", flush=True)
    print(f"B2f-bf16's own work at M={m} B={TRAIN_BATCH}: {FWD_BF16_FMA_ITEM * items / 1e12:.3f} T "
          f"multiply-adds ({FWD_BF16_FMA_TILED * items / 1e12:.3f} T issued with the tiles' "
          f"padding) against the bound's {HEAD_FMA_FWD * units / 1e12:.3f} T", flush=True)
    # B2f-bf16 by phase: its debug instantiation's clock counters, per warp and (trial, zone).
    clk = torch.zeros(len(FWD_BF16_PHASES) + 2, dtype=torch.int64, device=dev)
    with torch.no_grad():
        _launch_fwd(x, *ops, *geo, clk=clk)
    c = clk.tolist()
    big["fwd_phase_cycles"] = {k: c[i] / 16 / items for i, k in enumerate(FWD_BF16_PHASES)}
    print(f"B2f-bf16 by phase at M={m} B={TRAIN_BATCH}: {c[-2] / items:.0f} cycles a (trial, "
          f"zone) item at {1e3 * c[-2] / c[-1]:.0f} MHz; cycles a warp and item: "
          f"{json.dumps({k: round(v) for k, v in big['fwd_phase_cycles'].items()})}", flush=True)
    # B2w-bf16 by phase: its debug instantiation's clock counters, per warp and unit.
    clk = torch.zeros(len(BWD_W_BF16_PHASES) + 2, dtype=torch.int64, device=dev)
    _launch_bwd_w(g, x, *ops, *geo, clk=clk)
    c = clk.tolist()
    big["w_phase_cycles"] = {k: c[i] / 16 / units for i, k in enumerate(BWD_W_BF16_PHASES)}
    print(f"B2w-bf16 by phase at M={m} B={TRAIN_BATCH}: {c[-2] / units:.0f} cycles a unit at "
          f"{1e3 * c[-2] / c[-1]:.0f} MHz; cycles a warp and unit: "
          f"{json.dumps({k: round(v) for k, v in big['w_phase_cycles'].items()})}", flush=True)
    return rows, big


def phase_adapted_geometry(cfg, dev, rng):
    """Head geometries the kernels are not built for, launched on operands
    ``_adapted`` zero-pads or splits: dim_cnn = 8 (the width
    cli/zero_shot.py trains), full width otherwise, M = 2, B = 8, features
    and weight gradients in f32 and in bf16 (zones padded to 32 channels);
    and a bf16 forward of trials of T = 1001 (N = 7: two groups of windows,
    each on an even copy of its samples). Each must launch its kernels,
    count adapted calls, and match the CPU: f32 at HEAD_RTOL / HEAD_ATOL and
    BWD_RTOL, bf16 at BF16_FWD_REL and BF16_BWD_REL."""
    cfg8 = dataclasses.replace(cfg, dim_cnn=8)
    geo = (cfg8.window_len, cfg8.slide_step)
    m, b = 2, 8
    model = FAST(cfg8, n_models=m)
    model.load_state_dict(from_jax_params(init_jax_layout_params(cfg8, SEED, m)))
    with torch.no_grad():
        ops = model.head.fused_weights()
    x = torch.tensor(rng.normal(size=(m, b, 64, 800)).astype(np.float32))
    g = torch.tensor(rng.normal(size=(m, b, cfg8.n_tokens, cfg8.n_zones * 8)).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        results = {}
        for device in (dev, torch.device("cpu")):
            weights = [t.detach().to(device).requires_grad_(True) for t in ops]
            reset_launches()
            out = fused_conv4_head(x.to(device, dtype), *weights, *geo)
            (out * g.to(device)).sum().backward()
            if device.type == "cuda":
                launches = read_launches()
            results[device.type] = [out.detach().cpu()] + [p.grad.cpu() for p in weights]
        want = HEAD_KERNELS["bf16" if dtype == torch.bfloat16 else "f32"]
        if launches["adapted"] != 2 or any(launches[k] != 1 for k in want):
            raise RuntimeError(f"dim_cnn = 8 must launch {want} once each, adapted: {launches}")
        errs = {}
        for name, got, ref in zip(("out", "dw12", "db12", "dw3", "dw4"), results["cuda"],
                                  results["cpu"]):
            what = f"adapted dim_cnn=8 {dtype} {name}"
            if dtype == torch.bfloat16:
                errs[name] = check_rel(what, got, ref, BF16_FWD_REL if name == "out" else
                                       BF16_BWD_REL)
            elif name == "out":
                errs[name] = check_close(what, got, ref, HEAD_RTOL, HEAD_ATOL)
            else:
                errs[name] = check_close(what, got, ref, BWD_RTOL,
                                         BWD_RTOL * float(ref.abs().max()))
        print(f"head at dim_cnn=8 ({str(dtype).split('.')[-1]}), M={m} B={b}: zones padded to 32 "
              f"channels, launches {json.dumps({k: launches[k] for k in want})}, "
              f"{launches['adapted']} adapted calls; matches the CPU, max|err| "
              f"{json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})}", flush=True)
    z, o, k = cfg.n_zones, cfg.dim_cnn, KERNEL_TAPS
    ops32 = [torch.tensor(rng.normal(scale=sc, size=shape).astype(np.float32), device=dev)
             for shape, sc in (((1, z * o, k * 64), (k * 64) ** -0.5), ((1, z * o, 1), 0.1),
                               ((1, z, o, k * o), (k * o) ** -0.5),
                               ((1, z, o, k * o), (k * o) ** -0.5))]
    x = torch.tensor(rng.normal(size=(1, 16, 64, 1001)).astype(np.float32)).to(torch.bfloat16)
    geo = (cfg.window_len, cfg.slide_step)
    reset_launches()
    with torch.no_grad():
        got = fused_conv4_head(x.to(dev), *ops32, *geo)
    launches = read_launches()
    if launches["adapted"] != 1 or launches["conv4head_fwd_bf16"] != 2:
        raise RuntimeError(f"T = 1001 must take two B2f-bf16 launches, adapted: {launches}")
    err = check_rel("adapted bf16 forward T=1001", got.cpu(),
                    fused_conv4_head_plain(x, *(t.cpu() for t in ops32), *geo), BF16_FWD_REL)
    print(f"bf16 head forward at T=1001 (N=7), M=1 B=16: two B2f-bf16 launches (5 and 2 "
          f"windows), 1 adapted call; matches the CPU, max|err| {err:.3g}", flush=True)


TC_KERNELS = (  # the tensor-core kernels: (name, entry function, its smem bytes at full width
    # from the library, the tensor-core instruction of its route in SASS: mma.sync is HMMA,
    # wgmma HGMMA)
    ("B2f", "conv4head_fwd_kernel", lambda lib, c: lib.isd_conv4head_smem_bytes(
        64, c.window_len, c.dim_cnn, KERNEL_TAPS), "HMMA"),
    ("B2w", "conv4head_bwd_w_kernel", lambda lib, c: lib.isd_conv4head_bwd_w_smem_bytes(
        64, c.window_len, c.dim_cnn, KERNEL_TAPS), "HMMA"),
    ("B2x", "conv4head_bwd_x_kernel", lambda lib, c: lib.isd_conv4head_bwd_x_smem_bytes(
        64, c.window_len, c.dim_cnn, KERNEL_TAPS), "HMMA"),
    ("B2f-bf16", "conv4head_fwd_bf16_kernel", lambda lib, c: lib.isd_conv4head_fwd_bf16_smem_bytes(
        64, c.window_len, c.slide_step, c.n_tokens, c.dim_cnn, KERNEL_TAPS), "HGMMA"),
    ("B2w-bf16", "conv4head_bwd_w_bf16_kernel", lambda lib, c: (
        lib.isd_conv4head_bwd_w_bf16_smem_bytes(64, c.window_len, c.dim_cnn, KERNEL_TAPS)),
     "HGMMA"),
)
DEBUG_INSTANTIATION = "Lb1EE"  # B2f-bf16's and B2w-bf16's phase counters (kClock): not counted


def report_iir_build(info) -> None:
    """B1's registers and spills per entry, from this run's ``-Xptxas -v`` log."""
    for block in info["log"].split("Compiling entry function")[1:]:
        for entry in ("sosfiltfilt_chain_kernel", "sosfilt_time_major_kernel"):
            if entry in block.splitlines()[0]:
                lines = [ln.strip() for ln in block.split("Compile time")[0].splitlines()
                         if re.search(r"registers|spill", ln)]
                print(f"B1 ptxas {entry}: {' | '.join(lines)}", flush=True)


def report_tc_build(info, cfg) -> None:
    """The tensor-core kernels' registers and spills (each instantiation)
    from the ``-Xptxas -v`` log of this run's build, their dynamic shared
    memory per block at full width, and the count of tensor-core
    instructions of each one's route (HMMA, or HGMMA for B2w-bf16's wgmma)
    in the SASS of its shipped and generic instantiations; raises if any
    has none."""
    log = info["log"]
    if not log:
        print("ptxas: no build log (the library was already built)", flush=True)
    lib = _lib.library()
    for what, entry, smem_fn, _ in TC_KERNELS:
        for block in log.split("Compiling entry function")[1:]:
            if entry in block.splitlines()[0]:
                name = re.search(entry + r"ILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", block)
                lines = [ln.strip() for ln in block.split("Compile time")[0].splitlines()
                         if re.search(r"registers|spill", ln)]
                print(f"{what} ptxas <O, K, C, W> = <{', '.join(name.groups()) if name else '?'}>: "
                      f"{' | '.join(lines)}", flush=True)
        print(f"{what} shared memory: {smem_fn(lib, cfg)} bytes per block (dynamic)", flush=True)
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(cuobjdump):
        print("SASS: cuobjdump is missing; HMMA / HGMMA counts not read", flush=True)
        return
    sass = subprocess.run([cuobjdump, "-sass", info["path"]], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
        elif name is not None and DEBUG_INSTANTIATION not in name:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\b", ln):
                    counts[(name, op)] = counts.get((name, op), 0) + 1
    for what, entry, _, op in TC_KERNELS:
        n_op = sum(v for (k, o), v in counts.items() if entry in k and o == op)
        n_hmma = sum(v for (k, o), v in counts.items() if entry in k and o == "HMMA")
        if n_op == 0:
            raise RuntimeError(f"{what}'s SASS has no {op} instruction: "
                               "it does not run on the tensor cores by its route")
        if op == "HGMMA" and n_hmma:
            raise RuntimeError(f"{what} runs on wgmma, yet its SASS has {n_hmma} HMMA")
        print(f"{what} SASS: {n_op} {op} instructions (cuobjdump -sass)"
              + (", no HMMA" if op == "HGMMA" else ""), flush=True)


def reset_launches() -> None:
    for fn in (sosfiltfilt_chain, sosfilt_time_major, fused_conv4_head, conv4head_bwd_w,
               conv4head_bwd_x):
        fn.launches = 0
    fused_conv4_head.launches_bf16 = conv4head_bwd_w.launches_bf16 = 0
    for fn in HEAD_WRAPPERS:
        fn.adapted = 0


def read_launches() -> dict:
    torch.cuda.synchronize()
    return {"iir_chain": sosfiltfilt_chain.launches, "iir": sosfilt_time_major.launches,
            "conv4head_fwd": fused_conv4_head.launches,
            "conv4head_bwd_w": conv4head_bwd_w.launches,
            "conv4head_bwd_x": conv4head_bwd_x.launches,
            "conv4head_fwd_bf16": fused_conv4_head.launches_bf16,
            "conv4head_bwd_w_bf16": conv4head_bwd_w.launches_bf16,
            "adapted": sum(fn.adapted for fn in HEAD_WRAPPERS)}


HEAD_WRAPPERS = (fused_conv4_head, conv4head_bwd_w, conv4head_bwd_x)  # each counts adapted


def require_unadapted(launches: dict, path: str) -> None:
    """The shipped geometry runs every head call on its operands as they are."""
    if launches["adapted"]:
        raise RuntimeError(f"the {path} path padded or split the head's operands "
                           f"{launches['adapted']} times at the shipped geometry")


HEAD_KERNELS = {"f32": ("conv4head_fwd", "conv4head_bwd_w"),
                "bf16": ("conv4head_fwd_bf16", "conv4head_bwd_w_bf16")}  # launch-count keys


def phase_training(cfg, dev, workdir, precision: str):
    """The training CLI on the full synthetic corpus: 75 stacked models, at
    the CLI's default precision (bf16: no ``--precision``) or f32."""
    out = os.path.join(workdir, f"train_{precision}")
    argv = ["--synthetic", str(TRAIN_SUBJECTS), "--synthetic_trials", str(TRAIN_TRIALS),
            "--epochs", str(TRAIN_EPOCHS)]
    argv += [] if precision == "bf16" else ["--precision", precision]
    argv += ["--output_dir", out]
    print(f"training path ({precision}): cli.train_fast {' '.join(argv[:-1])} <tmp>", flush=True)
    reset_launches()
    result = train_fast.main(argv)
    launches = read_launches()
    print(f"training path ({precision}): kernel launches during the run {launches}", flush=True)
    other = "f32" if precision == "bf16" else "bf16"
    if any(launches[k] < 1 for k in HEAD_KERNELS[precision]):
        raise RuntimeError(f"the {precision} training path never launched {HEAD_KERNELS[precision]}")
    if any(launches[k] for k in HEAD_KERNELS[other]) or launches["conv4head_bwd_x"]:
        raise RuntimeError(f"the {precision} training path launched a head kernel of the other "
                           f"precision or B2x: {launches}")
    require_unadapted(launches, f"{precision} training")
    for k, v in result.fit.history.items():
        if v.shape != (TRAIN_SUBJECTS * 5, TRAIN_EPOCHS) or not np.isfinite(v).all():
            raise RuntimeError(f"history {k}: shape {v.shape}, finite {np.isfinite(v).all()}")
    subjects = [f"{i + 1:02d}" for i in range(TRAIN_SUBJECTS)]
    expected = [os.path.join(out, n) for n in
                ("summary_per_subject.csv", "global_test_predictions.csv")]
    for sid in subjects:
        expected += [os.path.join(out, f"sub-{sid}", n) for n in
                     [f"fold-{k}_history.csv" for k in range(5)]
                     + ["fold_metrics.csv", "best_subject.npz", "test_predictions.csv"]]
    missing = [p for p in expected if not os.path.isfile(p)]
    if missing:
        raise RuntimeError(f"result tree incomplete: {missing[:5]}")

    # One subject's best checkpoint, loaded as the serving layout (M = 1),
    # reproduces its test predictions (unfiltered: the training data is),
    # in the run's precision.
    dtype = TrainConfig(precision=precision).compute_dtype
    si = TRAIN_SUBJECTS - 1
    ckpt = os.path.join(out, f"sub-{subjects[si]}", "best_subject.npz")
    params, _, _ = load_model_npz(ckpt, init_jax_layout_params(cfg, SEED), {"head": {}})
    model = FAST(cfg, device=dev)
    model.load_state_dict(from_jax_params(params))
    subject = synthetic_trials(1000 * si, TRAIN_TRIALS, 64, 800)
    x_test = torch.tensor(subject[0][: TRAIN_TRIALS // 3]).to(dtype)
    y_pred = engine.predict(model, x_test.to(dev), TRAIN_BATCH)
    saved, _ = load_predictions_csv(os.path.join(out, f"sub-{subjects[si]}", "test_predictions.csv"))
    if not np.array_equal(y_pred, saved):
        raise RuntimeError("the best checkpoint does not reproduce test_predictions.csv")
    cpu = FAST(cfg)
    cpu.load_state_dict(from_jax_params(params))
    with torch.no_grad():
        logits = model.eval()(x_test.to(dev)).cpu().float()
        ref = cpu.eval()(x_test).float()
    if precision == "f32":
        logit_err = check_close("best checkpoint logits, card vs CPU", logits, ref, POST_RTOL,
                                POST_ATOL)
        how = f"max|err| {logit_err:.3g}"
    else:
        logit_err = float((logits - ref).norm() / ref.norm())
        if not logit_err <= BF16_LOGITS_L2:
            raise RuntimeError(f"bf16 checkpoint logits, card vs CPU: relative L2 {logit_err:.3g} "
                               f"> {BF16_LOGITS_L2}")
        how = f"relative L2 {logit_err:.3g} (max|err| {float((logits - ref).abs().max()):.3g})"

    t = result.timings
    m, n_train = TRAIN_SUBJECTS * 5, TRAIN_TRIALS * 4 // 5
    print(f"training path ({precision}): all {len(expected)} result files written; "
          f"sub-{subjects[si]}'s best_subject.npz reproduces its {len(saved)} test predictions; "
          f"its logits match the plain CPU forward, {how}", flush=True)
    print(f"training path ({precision}), host clock: corpus generation {t['data_s']:.2f} s, fit "
          f"{t['fit_s']:.2f} s, artifacts + test eval {t['artifacts_s']:.2f} s", flush=True)
    for ep, (tr, va) in enumerate(zip(t["train_s"], t["val_s"])):
        print(f"  epoch {ep}: train pass {tr:.3f} s ({t['steps_per_epoch']} steps, "
              f"{1e3 * tr / t['steps_per_epoch']:.1f} ms/step, "
              f"{m * n_train * cfg.n_tokens / tr:.0f} train trial-windows/s), validation "
              f"{va:.3f} s, epoch {tr + va:.3f} s", flush=True)
    acc = [row["Test_Acc"] for row in result.summary]
    print(f"  mean val_acc {result.fit.history['val_acc'][:, -1].mean():.4f}, mean test acc "
          f"{np.mean(acc):.4f} after {TRAIN_EPOCHS} epochs", flush=True)
    return launches, t, (ckpt, subject)


def phase_train_step_profile(cfg, dev, dtype):
    """One training step of the 75-model stack at batch 64 on a ``dtype``
    batch: CUDA-event span, profiler device time by kernel, device idle
    share. A bf16 step must run B2f-bf16 and B2w-bf16 and no f32 head
    kernel."""
    m = TRAIN_SUBJECTS * 5
    model = FAST(cfg, n_models=m, device=dev)
    model.load_state_dict(from_jax_params(init_jax_layout_params(cfg, SEED, m)))
    model.train()
    opt = engine.make_optimizer(model.parameters())
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((m, TRAIN_BATCH, 64, 800), generator=gen, device=dev).to(dtype)
    y = torch.randint(0, cfg.n_classes, (m, TRAIN_BATCH), generator=gen, device=dev)

    def step():
        engine.train_step(model, opt, x, y, 1e-4, cfg.n_classes, gen)

    step()
    span = cuda_ms(step, 3, warmup=0)
    name = "bf16" if dtype == torch.bfloat16 else "f32"
    other = "f32" if name == "bf16" else "bf16"
    # Which head kernels ran is read from the launch counters; the profiler
    # is asked only for their times, and profiles again where it lost one.
    kernels = {"f32": ("conv4head_fwd_kernel", "conv4head_bwd_w_kernel"),
               "bf16": ("conv4head_fwd_bf16_kernel", "conv4head_bwd_w_bf16_kernel")}
    reset_launches()
    events = profiled(step, cpu=True, need=kernels[name])
    launches = read_launches()
    if (any(launches[k] < 1 for k in HEAD_KERNELS[name])
            or any(launches[k] for k in HEAD_KERNELS[other]) or launches["conv4head_bwd_x"]):
        raise RuntimeError(f"the {name} training step must launch {HEAD_KERNELS[name]} and no "
                           f"other head kernel: {launches}")
    require_unadapted(launches, f"{name} training step")
    by_device = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                        for e in events if e.device_type != DeviceType.CPU), reverse=True)
    busy = sum(ms for ms, _, _ in by_device)
    print(f"train step {name} M={m} B={TRAIN_BATCH}: CUDA-event span {span:.2f} ms; profiler "
          f"device time {busy:.2f} ms over {sum(c for _, c, _ in by_device)} kernels and copies "
          f"(device idle {max(0.0, 1 - busy / span):.1%} of the span)", flush=True)
    for ms, calls, key in by_device[:10]:
        print(f"    device {ms:10.3f} ms {100 * ms / busy:5.1f}%  {calls:4d} calls  {key[:60]}",
              flush=True)
    if any(re.search(k, key) for k in kernels[other] for _, _, key in by_device):
        raise RuntimeError(f"the {name} training step's profile holds a {other} head kernel")
    return {"step_ms": span, "busy_ms": busy}


def phase_trajectory(cfg, dev):
    """2 subjects x 10 trials (10 models, 8 + 2 trials, batch 8), dropout 0,
    2 epochs: the engine on the card against the engine on the CPU, from
    the same weights and the same CPU-generator permutations."""
    cfg0 = dataclasses.replace(cfg, dropout=0.0)
    x, y = synthetic_corpus(SEED, 2, 10, 64, 800)
    tidx, vidx, _ = build_cv_index_stack(2, 10, 5, 42)
    m = tidx.shape[0]
    p0 = from_jax_params(stacked_init(cfg0, 42, m))
    runs, models = {}, {}
    for device, d in (("card", dev), ("cpu", torch.device("cpu"))):
        model = models[device] = FAST(cfg0, n_models=m, device=d)
        model.load_state_dict(p0)
        fit = engine.make_fit(model, cfg.n_classes, epochs=2, batch_size=8, n_train=8, n_val=2,
                              learning_rate=1e-3, warmup_epochs=0)
        t0 = time.perf_counter()
        runs[device] = fit(tidx, vidx, torch.as_tensor(x.reshape(-1, 64, 800), device=d),
                           torch.as_tensor(y.reshape(-1).astype(np.int64), device=d), seed=43)
        print(f"trajectory: {device} fit {time.perf_counter() - t0:.2f} s", flush=True)
    gpu, cpu = runs["card"], runs["cpu"]
    for k in engine.HISTORY_KEYS:
        np.testing.assert_allclose(gpu.history[k], cpu.history[k], rtol=TRAJ_RTOL, atol=TRAJ_ATOL,
                                   err_msg=k)
    np.testing.assert_array_equal(gpu.best_epoch, cpu.best_epoch)
    np.testing.assert_allclose(gpu.best_val_acc, cpu.best_val_acc, rtol=TRAJ_RTOL)
    # The last step's gradients, per tensor, as the kernels are held (BWD_RTOL).
    for (k, a), b in zip(models["card"].named_parameters(), models["cpu"].parameters()):
        check_close(f"trajectory last-step gradient {k}", a.grad.cpu(), b.grad, BWD_RTOL,
                    BWD_RTOL * float(b.grad.abs().max()))
    # Parameters. Adam moves an element by ~lr whatever its gradient's size, so
    # an element whose gradient is at the rounding-noise level moves
    # differently on the two devices: the key part of the attention
    # in-projection bias (its exact gradient is 0, softmax being
    # shift-invariant along the keys) and a few others. Every element must
    # stay within the summed learning rate, and all but TRAJ_NOISE_SHARE of
    # the others within rtol TRAJ_RTOL, atol TRAJ_ATOL.
    budget = float(np.sum(fit.lr_table))
    d = cfg.dim_token
    far, total, worst = {}, 0, 0.0
    for which in ("params", "best_params"):
        a_all, b_all = getattr(gpu, which), getattr(cpu, which)
        for k in a_all:
            a, b = a_all[k].cpu(), b_all[k]
            torch.testing.assert_close(a, b, rtol=0, atol=budget,
                                       msg=lambda msg, k=k: f"{which} {k}: {msg}")
            worst = max(worst, float((a - b).abs().max()))
            if k.endswith("attn.in_proj.bias"):
                a, b = torch.cat([a[:, :d], a[:, 2 * d :]], 1), torch.cat([b[:, :d], b[:, 2 * d :]], 1)
            n_far = int(((a - b).abs() > TRAJ_ATOL + TRAJ_RTOL * b.abs()).sum())
            if n_far:
                far[f"{which}.{k}"] = n_far
            total += b.numel()
    n_far = sum(far.values())
    print(f"trajectory: {n_far} of {total} parameter elements (the key bias aside) beyond rtol "
          f"{TRAJ_RTOL}, atol {TRAJ_ATOL}: {json.dumps(dict(sorted(far.items(), key=lambda kv: -kv[1])[:6]))}",
          flush=True)
    if n_far > TRAJ_NOISE_SHARE * total:
        raise RuntimeError(f"trajectory: {n_far} of {total} parameter elements differ beyond "
                           f"rtol {TRAJ_RTOL}, atol {TRAJ_ATOL}")
    moved = max(float((gpu.params[k].cpu() - p0[k]).abs().max()) for k in p0)
    print(f"trajectory: card and CPU agree over 2 epochs: history (rtol {TRAJ_RTOL}, atol "
          f"{TRAJ_ATOL}), best epochs, last-step gradients (rtol {BWD_RTOL}, atol {BWD_RTOL} * "
          f"max|ref|), final and best parameters ({n_far} of {total} elements beyond rtol "
          f"{TRAJ_RTOL}, atol {TRAJ_ATOL}; max|card - CPU| {worst:.3g} <= summed lr {budget:.3g}) "
          f"while the parameters moved up to {moved:.3g}", flush=True)


BF16_TRAJ_LOSS_RTOL = 1e-2  # bf16 card vs CPU: train and validation losses
BF16_TRAJ_GRAD_L2 = 1e-2  # bf16 card vs CPU: the last step's gradients, all parameters, relative L2
BF16_TRAJ_WEIGHT_DECAY = 0.01  # AdamW's decay in that run (make_fit's default)


def phase_trajectory_bf16(cfg, dev):
    """``phase_trajectory``'s run in bf16, the corpus held in bf16 as
    ``train.cv`` holds it: the card (B2f-bf16, B2w-bf16, the cuBLAS bf16
    trunk) against the CPU (the plain bf16 head, the same trunk). bf16
    rounds every activation, and an element whose f32 sum lies near a
    rounding boundary rounds one ulp apart on the two devices, so the
    losses are held at rtol 1e-2 and the last step's gradients (all
    parameters together) at 1e-2 in relative L2. Far more elements than
    in f32 have gradients at the rounding-noise level (the key part of the
    attention in-projection bias, whose exact gradient is 0, always), and
    Adam moves each by up to lr a step whatever its size, in its own
    direction on each device. So every parameter is held to two such
    walks apart: 2 x the summed lr x (1.01 + weight decay x max|p|), the
    bias-corrected m / sqrt(v) of the run's first two steps being at most
    1.0014 (Cauchy-Schwarz over Adam's weights) and the decay pulling
    each walk by at most lr x wd x |p| more. Accuracies (2 validation
    trials a model: steps of 0.5) and best epochs follow from the losses
    and are printed, not held."""
    cfg0 = dataclasses.replace(cfg, dropout=0.0)
    x, y = synthetic_corpus(SEED, 2, 10, 64, 800)
    tidx, vidx, _ = build_cv_index_stack(2, 10, 5, 42)
    m = tidx.shape[0]
    p0 = from_jax_params(stacked_init(cfg0, 42, m))
    runs, models = {}, {}
    for device, d in (("card", dev), ("cpu", torch.device("cpu"))):
        model = models[device] = FAST(cfg0, n_models=m, device=d)
        model.load_state_dict(p0)
        fit = engine.make_fit(model, cfg.n_classes, epochs=2, batch_size=8, n_train=8, n_val=2,
                              learning_rate=1e-3, warmup_epochs=0,
                              weight_decay=BF16_TRAJ_WEIGHT_DECAY)
        reset_launches()
        runs[device] = fit(tidx, vidx,
                           torch.as_tensor(x.reshape(-1, 64, 800), dtype=torch.bfloat16, device=d),
                           torch.as_tensor(y.reshape(-1).astype(np.int64), device=d), seed=43)
        launches = read_launches()
        if device == "card" and (launches["conv4head_fwd_bf16"] < 1
                                 or launches["conv4head_bwd_w_bf16"] < 1):
            raise RuntimeError(f"the bf16 trajectory run did not launch the bf16 kernels: {launches}")
        if device == "card":
            require_unadapted(launches, "bf16 trajectory")
    gpu, cpu = runs["card"], runs["cpu"]
    loss_err = max(float(np.abs(gpu.history[k] / cpu.history[k] - 1).max())
                   for k in ("loss", "val_loss"))
    g_card = torch.cat([p.grad.detach().cpu().flatten() for p in models["card"].parameters()])
    g_cpu = torch.cat([p.grad.detach().flatten() for p in models["cpu"].parameters()])
    grad_err = float((g_card - g_cpu).norm() / g_cpu.norm())
    p_max = max(float(v.abs().max()) for v in p0.values())
    budget = 2 * float(np.sum(fit.lr_table)) * (1.01 + BF16_TRAJ_WEIGHT_DECAY * p_max)
    diffs = {f"{which}.{k}": float((getattr(gpu, which)[k].cpu() - getattr(cpu, which)[k])
                                   .abs().max())
             for which in ("params", "best_params") for k in gpu.params}
    worst = max(diffs, key=diffs.get)
    acc_diff = max(float(np.nanmax(np.abs(gpu.history[k] - cpu.history[k])))
                   for k in ("acc", "val_acc"))
    print(f"trajectory bf16: card against CPU over 2 epochs: losses within {loss_err:.3g} "
          f"relative (rtol {BF16_TRAJ_LOSS_RTOL}), last-step gradients {grad_err:.3g} in relative "
          f"L2 (<= {BF16_TRAJ_GRAD_L2}), parameters max|card - CPU| {diffs[worst]:.3g} at "
          f"{worst} (<= two Adam walks, {budget:.4g}); accuracies differ by up to "
          f"{acc_diff:.3g}, best epochs "
          f"{'equal' if np.array_equal(gpu.best_epoch, cpu.best_epoch) else 'differ'}",
          flush=True)
    if not (loss_err <= BF16_TRAJ_LOSS_RTOL and grad_err <= BF16_TRAJ_GRAD_L2
            and diffs[worst] <= budget):
        raise RuntimeError("trajectory bf16: the card and the CPU disagree beyond the bounds above")


def phase_explain(cfg, dev, ckpt, subject):
    """Attributions of a trained checkpoint on its subject's trials
    ``subject = (x, y)``; every input gradient runs through B2x. Against
    the same attributions on the CPU (plain path)."""
    params, _, _ = load_model_npz(ckpt, init_jax_layout_params(cfg, SEED), {"head": {}})
    model = FAST(cfg, device=dev)
    model.load_state_dict(from_jax_params(params))
    cpu = FAST(cfg)
    cpu.load_state_dict(from_jax_params(params))
    x_all, y_all = subject
    x = torch.tensor(x_all[:IG_TRIALS], device=dev)
    with torch.no_grad():
        target = model.eval()(x).argmax(-1)
    reset_launches()
    t0 = time.perf_counter()
    attr = integrated_gradients(model, x, target, n_steps=IG_STEPS)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    print(f"attribution path: integrated gradients, {IG_TRIALS} trials x {IG_STEPS} steps, "
          f"{host_s:.3f} s", flush=True)
    ref = integrated_gradients(cpu, x.cpu(), target.cpu(), n_steps=IG_STEPS)
    err = check_close("integrated gradients", attr.cpu(), ref, BWD_RTOL,
                      BWD_RTOL * float(ref.abs().max()))
    print(f"attribution path: integrated gradients match the plain CPU path, max|err| {err:.3g} "
          f"(max|attr| {float(ref.abs().max()):.3g})", flush=True)

    # Expected gradients as cli/global_explain.py runs them: a seeded
    # permutation into 200 background and 100 explained trials, the true
    # labels as targets, 16 samples.
    perm = np.random.default_rng(SEED).permutation(len(x_all))
    bg = torch.tensor(x_all[perm[:EG_BACKGROUND]], device=dev)
    sel = perm[EG_BACKGROUND:EG_BACKGROUND + EG_TRIALS]
    xt = torch.tensor(x_all[sel], device=dev)
    yt = torch.tensor(np.asarray(y_all)[sel].astype(np.int64), device=dev)

    def eg():
        return expected_gradients(model, xt, bg, yt, torch.Generator().manual_seed(SEED),
                                  EG_SAMPLES)

    eg()  # warm-up: the first call at these shapes sets up allocations and cuBLAS plans
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    attr = eg()
    torch.cuda.synchronize()
    eg_s = time.perf_counter() - t0
    by_device = [(e.self_device_time_total / 1e3, e.key) for e in profiled(eg, cpu=True)
                 if e.device_type != DeviceType.CPU]
    busy = sum(ms for ms, _ in by_device)
    b2x = sum(ms for ms, key in by_device if re.search(B2X_KERNELS, key))
    b2f = sum(ms for ms, key in by_device if "conv4head_fwd_kernel" in key)
    gen = torch.Generator().manual_seed(SEED)  # expected_gradients' draws, in its order
    bg_idx = torch.randint(0, EG_BACKGROUND, (EG_SAMPLES, EG_TRIALS), generator=gen)
    alphas = torch.rand((EG_SAMPLES, EG_TRIALS), generator=gen)
    k = EG_CPU_TRIALS
    ref = expected_gradients_from_draws(cpu, xt[:k].cpu(), bg.cpu(), yt[:k].cpu(), bg_idx[:, :k],
                                        alphas[:, :k])
    eg_err = check_close("expected gradients", attr[:k].cpu(), ref, BWD_RTOL,
                         BWD_RTOL * float(ref.abs().max()))
    if attr.shape != xt.shape or not bool(torch.isfinite(attr).all()):
        raise RuntimeError(f"expected gradients: shape {tuple(attr.shape)} or non-finite values")
    print(f"attribution path: expected gradients, {EG_TRIALS} trials x {EG_SAMPLES} samples "
          f"against {EG_BACKGROUND} background trials: {eg_s:.3f} s on the host clock (after a "
          f"warm-up call); profiler device time {busy:.2f} ms (device idle "
          f"{max(0.0, 1 - busy / (1e3 * eg_s)):.0%} of the host time), B2x {b2x:.2f} ms "
          f"({b2x / busy:.1%}), B2f {b2f:.2f} ms "
          f"({b2f / busy:.1%}); the first {k} trials match the CPU on the same draws, max|err| "
          f"{eg_err:.3g} (max|attr| {float(ref.abs().max()):.3g})", flush=True)

    # attribution_for_predictions as cli/explain_fast.py runs it.
    bg = torch.tensor(x_all[perm[:AFP_BACKGROUND]], device=dev)
    xt = x_all[perm[AFP_BACKGROUND:AFP_BACKGROUND + AFP_TRIALS]]
    attr, preds = attribution_for_predictions(model, torch.tensor(xt, device=dev), bg,
                                              torch.Generator().manual_seed(SEED), AFP_SAMPLES)
    with torch.no_grad():
        cpu_preds = cpu.eval()(torch.from_numpy(xt)).argmax(-1)
    if not torch.equal(preds.cpu(), cpu_preds) or not bool(torch.isfinite(attr).all()):
        raise RuntimeError("attribution_for_predictions: predictions differ from the CPU's or "
                           "attributions are not finite")
    launches = read_launches()
    print(f"attribution path: attribution_for_predictions, {AFP_TRIALS} trials x {AFP_SAMPLES} "
          f"samples against {AFP_BACKGROUND}: predictions equal the CPU's; kernel launches in "
          f"the phase {launches}", flush=True)
    want = IG_STEPS + 3 * EG_SAMPLES + AFP_SAMPLES
    if launches["conv4head_bwd_x"] != want or launches["conv4head_bwd_w"] != 0:
        raise RuntimeError(f"the attribution path must launch B2x {want} times and B2w never")
    require_unadapted(launches, "attribution")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA GPU: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}, device {kind}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 GEMMs reduce in f32, as the JAX trunk's (train.cv sets it too).
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")

    info = _lib.build_info()
    print(f"kernels built in {info['seconds']:.2f} s -> {os.path.relpath(info['path'])}", flush=True)
    report_iir_build(info)
    report_tc_build(info, FASTConfig.default())

    cfg = FASTConfig.default()
    rng = np.random.default_rng(SEED)
    params1 = init_jax_layout_params(cfg, SEED)
    params2 = init_jax_layout_params(cfg, SEED + 1)
    model = FAST(cfg, device=dev)
    model.load_state_dict(from_jax_params(params1))

    with torch.inference_mode():
        iir = phase_iir(dev, rng)
        head = phase_head(model, dev, rng)
    bwd, _ = phase_head_backward(cfg, dev, rng)
    bf16, _ = phase_bf16_kernels(cfg, dev, rng)
    phase_adapted_geometry(cfg, dev, rng)
    with tempfile.TemporaryDirectory() as workdir:
        serving = phase_serving(cfg, params1, params2, rng, workdir)
        phase_device_time(cfg, params1, dev, rng)
        training, _, (ckpt, subject) = phase_training(cfg, dev, workdir, "f32")
        training_bf16, _, _ = phase_training(cfg, dev, workdir, "bf16")
        explain = phase_explain(cfg, dev, ckpt, subject)
    phase_train_step_profile(cfg, dev, torch.float32)
    phase_train_step_profile(cfg, dev, torch.bfloat16)
    phase_trajectory(cfg, dev)
    phase_trajectory_bf16(cfg, dev)

    src = "imagined_speech_decoding_tpu_torch/csrc/"
    pallas = "imagined_speech_decoding_tpu/ops/pallas/"
    b2, b2x, b16 = bwd[BWD_SHAPES[0]], bwd[X_SHAPES[-1]], bf16[BF16_SHAPES[-1]]
    # library_ms: no single PyTorch call computes the IIR cascade, the fused
    # windowed head or its gradients.
    keys = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by")
    kernels = [
        {"name": "iir_sosfiltfilt_chain", "route": "cuda", "source": src + "iir.cu",
         "replaces": pallas + "iir.py:67", "launches": serving["iir_chain"],
         **{k: iir[MAIN_BATCH][k] for k in keys}, "library_ms": None},
        {"name": "iir_sosfilt_time_major", "route": "cuda", "source": src + "iir.cu",
         "replaces": pallas + "iir.py:67", "launches": serving["iir"],
         **{k: iir[MAIN_BATCH]["causal"][k] for k in keys}, "library_ms": None},
        {"name": "conv4head_fwd", "route": "cuda", "source": src + "conv4head.cu",
         "replaces": pallas + "conv4head.py:303", "launches": training["conv4head_fwd"],
         **head[MAIN_BATCH], "library_ms": None},
        {"name": "conv4head_bwd_w", "route": "cuda", "source": src + "conv4head_bwd.cu",
         "replaces": pallas + "conv4head.py:323", "launches": training["conv4head_bwd_w"],
         "max_abs_err": b2["w_err"], "ms": b2["w_ms"], "plain_ms": b2["plain_ms"],
         "bound_ms": b2["w_bound"][0], "bound_by": b2["w_bound"][1], "library_ms": None},
        {"name": "conv4head_bwd_x", "route": "cuda", "source": src + "conv4head_bwd.cu",
         "replaces": pallas + "conv4head.py:351", "launches": explain["conv4head_bwd_x"],
         "max_abs_err": b2x["x_err"], "ms": b2x["x_ms"], "device_ms": b2x["x_device_ms"],
         "plain_ms": b2x["x_plain_ms"], "bound_ms": b2x["x_bound"][0],
         "bound_by": b2x["x_bound"][1], "library_ms": None},
        {"name": "conv4head_fwd_bf16", "route": "cuda", "source": src + "conv4head_fwd_bf16.cu",
         "replaces": pallas + "conv4head.py:303", "launches": training_bf16["conv4head_fwd_bf16"],
         "max_abs_err": b16["fwd_err"], "ms": b16["fwd_ms"], "plain_ms": b16["fwd_plain_ms"],
         "bound_ms": b16["fwd_bound"][0], "bound_by": b16["fwd_bound"][1], "library_ms": None},
        {"name": "conv4head_bwd_w_bf16", "route": "cuda", "source": src + "conv4head_bwd_w_bf16.cu",
         "replaces": pallas + "conv4head.py:323", "launches": training_bf16["conv4head_bwd_w_bf16"],
         "max_abs_err": b16["w_err"], "ms": b16["w_ms"], "plain_ms": b16["w_plain_ms"],
         "bound_ms": b16["w_bound"][0], "bound_by": b16["w_bound"][1], "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
