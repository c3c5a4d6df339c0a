#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving, training and attribution
paths on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, on a machine with a card

1. Prints the card (``nvidia-smi`` name and power limit) and versions.
2. Builds the hand-written CUDA kernels from ``csrc/`` and prints the
   build time and, for the tensor-core kernels B2f and B2w, their
   registers and spills (``-Xptxas -v``), shared memory per block and the
   count of HMMA instructions in their SASS (``cuobjdump``, where the
   toolkit has it; a count of 0 fails the run).
3. Holds each kernel against its plain PyTorch version on the card, in
   f32 with TF32 off, at the main paths' shapes, and times both with
   CUDA events, beside the kernel's bound (the least time for its work:
   bytes at 3.35 TB/s, or its products as three TF32 tensor-core passes
   at 495 TFLOP/s, the fastest f32-accurate route):
     B1 (IIR cascade): 60 Hz notch then 4-40 Hz band-pass ``sosfiltfilt``
        on (B, 64, 800); tolerance rtol 1e-4, atol 1e-4 * max|ref|
        (the JAX package's Pallas IIR tolerance, tests/test_pallas.py).
     B2f (Conv4Layers head forward, through the model-axis entry at
        M = 1) at full width; rtol 1e-4, atol 1e-5.
     B2w / B2x (head weight / input gradients) at full width, M = 2,
        B = 8 and M = 1, B = 64, against the plain autograd backward;
        rtol 1e-4, atol 1e-4 * max|ref| per tensor (sums over B*N*t1
        terms). Then all three at the training run's M = 75 and its
        batch sizes 64, 24 (the ragged tail) and 35 (validation): the
        full launches' outputs for models 0, 37 and 74 against the plain
        version on those models' operands, at the same tolerances; B2f
        and B2w are timed alone at M = 75, B = 64, with their rates and
        their shares of the bound and of the ``mma.sync`` TF32 floor.
4. Serving path: full-width FAST weights from a numpy seed are written
   as a checkpoint, the port's ``cli.serve`` serves it over TCP, and a
   ``DecoderClient`` sends INFO, DECODE at B = 1 and B = 8, RELOAD to a
   second checkpoint, and DECODE again. The posteriors must be finite,
   sum to 1 and match the port's plain CPU forward of the same weights
   (rtol 1e-4, atol 1e-5), and B1 and B2f must have launched.
5. Training path: the port's ``cli.train_fast`` on a 15-subject x 350-trial
   synthetic corpus, 75 stacked full-width models, 2 epochs, f32. B2f and
   B2w must have launched and B2x not; the history must be finite, the
   result tree complete, and one subject's ``best_subject.npz`` must
   reproduce its ``test_predictions.csv`` on the card, with logits that
   match the plain CPU forward (rtol 1e-4, atol 1e-5). Then one step at M = 75,
   B = 64 under the profiler, and a 2-subject x 10-trial run on the card
   against the same run on the CPU (plain path).
6. Attribution path: integrated gradients of a trained checkpoint, whose
   input gradient runs through B2x, against the plain CPU path.

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
from imagined_speech_decoding_tpu_torch.explain.attribution import integrated_gradients
from imagined_speech_decoding_tpu_torch.models.fast import FAST
from imagined_speech_decoding_tpu_torch.ops.cuda import _lib
from imagined_speech_decoding_tpu_torch.ops.cuda.conv4head import (
    KERNEL_TAPS,
    conv4head_bwd_plain,
    conv4head_bwd_w,
    conv4head_bwd_x,
    fused_conv4_head,
    fused_conv4_head_plain,
)
from imagined_speech_decoding_tpu_torch.ops.cuda.iir import (
    sosfilt_time_major,
    sosfilt_time_major_plain,
)
from imagined_speech_decoding_tpu_torch.ops.filters import (
    butter_sos,
    notch_ba,
    sosfiltfilt,
)
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
BWD_SHAPES = ((2, 8), (1, 64))  # (M, B) of the backward comparisons; JSON line: the first
IG_TRIALS, IG_STEPS = 8, 16

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, 700 W):
TF32_FLOPS = 495e12  # tensor cores, TF32
F32_FLOPS = 67e12  # CUDA cores, f32
HBM_BYTES_S = 3.35e12
# The rate of mma.sync m16n8k8 TF32 on an H100 80GB HBM3 at 700 W, measured by
# mma_tf32_ceiling.py: the floor of B2f's and B2w's route (three passes per product).
MMA_SYNC_TF32_FLOPS = 323.2e12
IIR_FMA_PER_SECTION = 5  # per sample: csrc/iir.cu's transposed direct form II


def bound_ms(nbytes: float, flops: float, flops_s: float):
    """Least time the card could take for the work, and what sets it:
    each input read once and each output written once at the memory rate,
    or the operations at the peak of their route."""
    by_bytes, by_ops = 1e3 * nbytes / HBM_BYTES_S, 1e3 * flops / flops_s
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def iir_bound(rows: int, t_len: int = 854, sections: int = 4):
    """B1 on (t_len, rows): x, zi read and y, zf written; f32 FMAs."""
    nbytes = 4 * 2 * rows * (t_len + 2 * sections)
    return bound_ms(nbytes, 2 * IIR_FMA_PER_SECTION * sections * t_len * rows, F32_FLOPS)


HEAD_WEIGHT_FLOATS = 256 * 320 + 256 + 2 * 8 * 32 * 160  # w12, b12, w3, w4 of one model


def head_bound(fma_per_unit: int, m: int, b: int, n_out_floats: int, reads_g: bool = True):
    """A head kernel at full width (C = 64, T = 800, 5 windows, 8 zones,
    O = 32, K = 5) on M models of B trials. The fastest f32-accurate route
    for its products is three TF32 tensor-core passes: 3 x 2 FLOPs per FMA
    at the TF32 peak. Reads x, the weights and (backward) the cotangent g;
    writes ``n_out_floats``."""
    n_in = m * b * 64 * 800 + m * HEAD_WEIGHT_FLOATS + reads_g * m * b * 5 * 256
    return bound_ms(4 * (n_in + n_out_floats), 3 * 2 * fma_per_unit * m * b * 5 * 8, TF32_FLOPS)


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


def check_close(name: str, got: torch.Tensor, ref: torch.Tensor, rtol: float, atol: float) -> float:
    err = float((got - ref).abs().max())
    torch.testing.assert_close(got, ref, rtol=rtol, atol=atol, msg=lambda m: f"{name}: {m}")
    return err


def phase_iir(dev, rng):
    """B1 against its plain version: the zero-phase notch + band-pass
    chain, and the causal kernel alone on the band-pass's padded length."""
    notch = tf2sos(*notch_ba(SFREQ, 60.0))
    band = butter_sos(SFREQ, 4.0, 40.0)

    def chain(x, backend):
        return sosfiltfilt(band, sosfiltfilt(notch, x, time_major=backend), time_major=backend)

    rows = {}
    for b in (1, MAIN_BATCH, 64, 350):
        x = torch.tensor(rng.normal(size=(b, 64, 800)).astype(np.float32), device=dev)
        ref = chain(x, sosfilt_time_major_plain)
        err = check_close(f"B1 chain B={b}", chain(x, sosfilt_time_major), ref,
                          IIR_RTOL, IIR_RTOL * float(ref.abs().max()))
        xt = torch.tensor(rng.normal(size=(854, b * 64)).astype(np.float32), device=dev)
        zi = torch.tensor(rng.normal(size=(8, b * 64)).astype(np.float32), device=dev)
        y_ref, _ = sosfilt_time_major_plain(band, xt, zi)
        y, _ = sosfilt_time_major(band, xt, zi)
        k_err = check_close(f"B1 kernel B={b}", y, y_ref, IIR_RTOL,
                            IIR_RTOL * float(y_ref.abs().max()))
        bound, bound_by = iir_bound(b * 64)
        rows[b] = {
            "bound_ms": bound, "bound_by": bound_by,
            "chain_ms": cuda_ms(lambda: chain(x, sosfilt_time_major), 20),
            "chain_plain_ms": cuda_ms(lambda: chain(x, sosfilt_time_major_plain), 2),
            "chain_max_abs_err": err,
            "ms": cuda_ms(lambda: sosfilt_time_major(band, xt, zi), 50),
            "plain_ms": cuda_ms(lambda: sosfilt_time_major_plain(band, xt, zi), 2),
            "max_abs_err": k_err,
        }
        print(f"B1 B={b:<4} (854, {b * 64}) band-pass pass: kernel {rows[b]['ms']:.4f} ms, "
              f"plain {rows[b]['plain_ms']:.3f} ms, max|err| {k_err:.3g}, bound "
              f"{bound:.4f} ms ({bound_by}); notch+band "
              f"sosfiltfilt: kernel {rows[b]['chain_ms']:.3f} ms, plain "
              f"{rows[b]['chain_plain_ms']:.3f} ms, max|err| {err:.3g}", flush=True)
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
    for name in ("iir", "conv4head_fwd"):
        if launches[name] < 1:
            raise RuntimeError(f"the serving path never launched the {name} kernel")
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
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                decode(x)
        # Kernels and copies are events of their own; an op's device time
        # repeats its kernels', so only the device-side events are summed.
        events = prof.key_averages()
        by_device = sorted(((e.self_device_time_total / 5e3, e.count // 5, e.key)
                            for e in events if e.device_type != DeviceType.CPU), reverse=True)
        by_host = sorted(((e.self_cpu_time_total / 5e3, e.count // 5, e.key)
                          for e in events if e.device_type == DeviceType.CPU), reverse=True)
        busy = sum(ms for ms, _, _ in by_device)
        device_ops = sum(calls for _, calls, _ in by_device)
        print(f"decode B={b} in process: host p50 {np.median(host):.3f} ms; CUDA-event span "
              f"p50 {np.median(span):.3f} ms; profiler device time {busy:.3f} ms per decode "
              f"over {device_ops} kernels and copies (device idle "
              f"{1 - busy / np.median(span):.0%} of the span)", flush=True)
        for ms, calls, key in by_device[:8]:
            print(f"    device {ms:9.4f} ms  {calls:4d} calls  {key[:70]}", flush=True)
        for ms, calls, key in by_host[:8]:
            print(f"    host   {ms:9.4f} ms  {calls:4d} calls  {key[:70]}", flush=True)


HEAD_FMA_FWD = 5_038_080  # per (trial, window, zone) at full width: conv12 2.52 M + tails 2 x 1.26 M
HEAD_FMA_BWD_W = 12_595_200  # recompute 5.04 M + dh2, dh1, dw4, dw3 1.26 M each + dw12 2.52 M
HEAD_FMA_BWD_X = 10_076_160  # recompute 5.04 M + dh2, dh1 1.26 M each + dx 2.52 M


def phase_head_backward(cfg, dev, rng):
    """B2w and B2x against the plain autograd backward at full width, then
    B2f and B2w alone at the training step's shape."""
    geo = (cfg.window_len, cfg.slide_step)
    feat = cfg.n_zones * cfg.dim_cnn
    rows = {}
    for m, b in BWD_SHAPES:
        model = FAST(cfg, n_models=m, device=dev)
        model.load_state_dict(from_jax_params(init_jax_layout_params(cfg, SEED, m)))
        with torch.no_grad():
            ops = model.head.fused_weights()
        x = torch.tensor(rng.normal(size=(m, b, 64, 800)).astype(np.float32), device=dev)
        g = torch.tensor(rng.normal(size=(m, b, cfg.n_tokens, feat)).astype(np.float32),
                         device=dev)
        ref = conv4head_bwd_plain(g, x, *ops, *geo)
        got = (conv4head_bwd_x(g, x, *ops, *geo), *conv4head_bwd_w(g, x, *ops, *geo))
        errs = {name: check_close(f"B2 backward M={m} B={b} {name}", a, r, BWD_RTOL,
                                  BWD_RTOL * float(r.abs().max()))
                for name, a, r in zip(("dx", "dw12", "db12", "dw3", "dw4"), got, ref)}
        rows[(m, b)] = {
            "w_ms": cuda_ms(lambda: conv4head_bwd_w(g, x, *ops, *geo), 10),
            "x_ms": cuda_ms(lambda: conv4head_bwd_x(g, x, *ops, *geo), 10),
            "plain_ms": cuda_ms(lambda: conv4head_bwd_plain(g, x, *ops, *geo), 3),
            "w_err": max(errs[k] for k in ("dw12", "db12", "dw3", "dw4")),
            "x_err": errs["dx"],
        }
        r = rows[(m, b)]
        r["w_bound"] = head_bound(HEAD_FMA_BWD_W, m, b, m * HEAD_WEIGHT_FLOATS)
        r["x_bound"] = head_bound(HEAD_FMA_BWD_X, m, b, m * b * 64 * 800)
        print(f"B2w M={m} B={b:<3} weight grads: kernel {r['w_ms']:.3f} ms, max|err| "
              f"{r['w_err']:.3g}, bound {r['w_bound'][0]:.3f} ms ({r['w_bound'][1]}, "
              f"{r['w_bound'][0] / r['w_ms']:.1%} reached); B2x input grad: kernel "
              f"{r['x_ms']:.3f} ms, max|err| {r['x_err']:.3g}, bound {r['x_bound'][0]:.3f} ms "
              f"({r['x_bound'][1]}, {r['x_bound'][0] / r['x_ms']:.1%} reached); plain autograd "
              f"backward (all five) {r['plain_ms']:.3f} ms; "
              f"per tensor {json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})}",
              flush=True)

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
    return rows, big


TC_KERNELS = (  # the tensor-core kernels: (name, entry function, its smem-bytes function)
    ("B2f", "conv4head_fwd_kernel", "isd_conv4head_smem_bytes"),
    ("B2w", "conv4head_bwd_w_kernel", "isd_conv4head_bwd_w_smem_bytes"),
)


def report_tc_build(info, cfg) -> None:
    """B2f's and B2w's registers and spills (each instantiation) from the
    ``-Xptxas -v`` log of this run's build, their dynamic shared memory per
    block at full width, and the count of tensor-core (HMMA) instructions
    in each one's SASS; raises if either has none."""
    log = info["log"]
    if not log:
        print("ptxas: no build log (the library was already built)", flush=True)
    lib = _lib.library()
    for what, entry, smem_fn in TC_KERNELS:
        for block in log.split("Compiling entry function")[1:]:
            if entry in block.splitlines()[0]:
                name = re.search(entry + r"ILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", block)
                lines = [ln.strip() for ln in block.split("Compile time")[0].splitlines()
                         if re.search(r"registers|spill", ln)]
                print(f"{what} ptxas <O, K, C, W> = <{', '.join(name.groups()) if name else '?'}>: "
                      f"{' | '.join(lines)}", flush=True)
        smem = getattr(lib, smem_fn)(64, cfg.window_len, cfg.dim_cnn, KERNEL_TAPS)
        print(f"{what} shared memory: {smem} bytes per block (dynamic)", flush=True)
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(cuobjdump):
        print("SASS: cuobjdump is missing; HMMA counts not read", flush=True)
        return
    sass = subprocess.run([cuobjdump, "-sass", info["path"]], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
        elif "HMMA" in ln and name is not None:
            counts[name] = counts.get(name, 0) + 1
    for what, entry, _ in TC_KERNELS:
        hmma = sum(v for k, v in counts.items() if entry in k)
        if hmma == 0:
            raise RuntimeError(f"{what}'s SASS has no HMMA instruction: "
                               "it does not run on the tensor cores")
        print(f"{what} SASS: {hmma} HMMA instructions (cuobjdump -sass)", flush=True)


def reset_launches() -> None:
    for fn in (sosfilt_time_major, fused_conv4_head, conv4head_bwd_w, conv4head_bwd_x):
        fn.launches = 0


def read_launches() -> dict:
    torch.cuda.synchronize()
    return {"iir": sosfilt_time_major.launches, "conv4head_fwd": fused_conv4_head.launches,
            "conv4head_bwd_w": conv4head_bwd_w.launches,
            "conv4head_bwd_x": conv4head_bwd_x.launches}


def phase_training(cfg, dev, workdir):
    """The training CLI on the full synthetic corpus: 75 stacked models."""
    out = os.path.join(workdir, "train")
    argv = ["--synthetic", str(TRAIN_SUBJECTS), "--synthetic_trials", str(TRAIN_TRIALS),
            "--epochs", str(TRAIN_EPOCHS), "--precision", "f32", "--output_dir", out]
    print(f"training path: cli.train_fast {' '.join(argv[:-1])} <tmp>", flush=True)
    reset_launches()
    result = train_fast.main(argv)
    launches = read_launches()
    print(f"training path: kernel launches during the run {launches}", flush=True)
    if launches["conv4head_fwd"] < 1 or launches["conv4head_bwd_w"] < 1:
        raise RuntimeError("the training path never launched B2f or B2w")
    if launches["conv4head_bwd_x"] != 0:
        raise RuntimeError("the training path launched B2x: no input gradient is needed")
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
    # reproduces its test predictions (unfiltered: the training data is).
    si = TRAIN_SUBJECTS - 1
    ckpt = os.path.join(out, f"sub-{subjects[si]}", "best_subject.npz")
    params, _, _ = load_model_npz(ckpt, init_jax_layout_params(cfg, SEED), {"head": {}})
    model = FAST(cfg, device=dev)
    model.load_state_dict(from_jax_params(params))
    x_test = synthetic_trials(1000 * si, TRAIN_TRIALS, 64, 800)[0][: TRAIN_TRIALS // 3]
    y_pred = engine.predict(model, torch.tensor(x_test, device=dev), TRAIN_BATCH)
    saved, _ = load_predictions_csv(os.path.join(out, f"sub-{subjects[si]}", "test_predictions.csv"))
    if not np.array_equal(y_pred, saved):
        raise RuntimeError("the best checkpoint does not reproduce test_predictions.csv")
    cpu = FAST(cfg)
    cpu.load_state_dict(from_jax_params(params))
    with torch.no_grad():
        logits = model.eval()(torch.tensor(x_test, device=dev)).cpu()
        logit_err = check_close("best checkpoint logits, card vs CPU", logits,
                                cpu.eval()(torch.from_numpy(x_test)), POST_RTOL, POST_ATOL)

    t = result.timings
    m, n_train = TRAIN_SUBJECTS * 5, TRAIN_TRIALS * 4 // 5
    print(f"training path: all {len(expected)} result files written; sub-{subjects[si]}'s "
          f"best_subject.npz reproduces its {len(saved)} test predictions; its logits match "
          f"the plain CPU forward, max|err| {logit_err:.3g}", flush=True)
    print(f"training path, host clock: corpus generation {t['data_s']:.2f} s, fit "
          f"{t['fit_s']:.2f} s, artifacts + test eval {t['artifacts_s']:.2f} s", flush=True)
    for ep, (tr, va) in enumerate(zip(t["train_s"], t["val_s"])):
        print(f"  epoch {ep}: train pass {tr:.3f} s ({t['steps_per_epoch']} steps, "
              f"{1e3 * tr / t['steps_per_epoch']:.1f} ms/step, "
              f"{m * n_train * cfg.n_tokens / tr:.0f} train trial-windows/s), validation "
              f"{va:.3f} s, epoch {tr + va:.3f} s", flush=True)
    acc = [row["Test_Acc"] for row in result.summary]
    print(f"  mean val_acc {result.fit.history['val_acc'][:, -1].mean():.4f}, mean test acc "
          f"{np.mean(acc):.4f} after {TRAIN_EPOCHS} epochs", flush=True)
    return launches, t, (ckpt, x_test)


def phase_train_step_profile(cfg, dev):
    """One training step of the 75-model stack at batch 64: CUDA-event
    span, profiler device time by kernel, device idle share."""
    m = TRAIN_SUBJECTS * 5
    model = FAST(cfg, n_models=m, device=dev)
    model.load_state_dict(from_jax_params(init_jax_layout_params(cfg, SEED, m)))
    model.train()
    opt = engine.make_optimizer(model.parameters())
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((m, TRAIN_BATCH, 64, 800), generator=gen, device=dev)
    y = torch.randint(0, cfg.n_classes, (m, TRAIN_BATCH), generator=gen, device=dev)

    def step():
        engine.train_step(model, opt, x, y, 1e-4, cfg.n_classes, gen)

    step()
    span = cuda_ms(step, 3, warmup=0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    by_device = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                        for e in prof.key_averages() if e.device_type != DeviceType.CPU),
                       reverse=True)
    busy = sum(ms for ms, _, _ in by_device)
    print(f"train step M={m} B={TRAIN_BATCH}: CUDA-event span {span:.2f} ms; profiler device "
          f"time {busy:.2f} ms over {sum(c for _, c, _ in by_device)} kernels and copies "
          f"(device idle {max(0.0, 1 - busy / span):.1%} of the span)", flush=True)
    for ms, calls, key in by_device[:10]:
        print(f"    device {ms:10.3f} ms {100 * ms / busy:5.1f}%  {calls:4d} calls  {key[:60]}",
              flush=True)
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


def phase_explain(cfg, dev, ckpt, x_test):
    """Integrated gradients of a trained checkpoint: the input gradient
    runs through B2x; against the same attribution on the CPU."""
    params, _, _ = load_model_npz(ckpt, init_jax_layout_params(cfg, SEED), {"head": {}})
    model = FAST(cfg, device=dev)
    model.load_state_dict(from_jax_params(params))
    x = torch.tensor(x_test[:IG_TRIALS], device=dev)
    with torch.no_grad():
        target = model.eval()(x).argmax(-1)
    reset_launches()
    t0 = time.perf_counter()
    attr = integrated_gradients(model, x, target, n_steps=IG_STEPS)
    launches = read_launches()
    host_s = time.perf_counter() - t0
    print(f"attribution path: integrated gradients, {IG_TRIALS} trials x {IG_STEPS} steps, "
          f"{host_s:.3f} s; kernel launches {launches}", flush=True)
    if launches["conv4head_bwd_x"] < 1 or launches["conv4head_bwd_w"] != 0:
        raise RuntimeError("the attribution path must launch B2x and not B2w")
    cpu = FAST(cfg)
    cpu.load_state_dict(from_jax_params(params))
    ref = integrated_gradients(cpu, x.cpu(), target.cpu(), n_steps=IG_STEPS)
    err = check_close("integrated gradients", attr.cpu(), ref, BWD_RTOL,
                      BWD_RTOL * float(ref.abs().max()))
    print(f"attribution path: matches the plain CPU path, max|err| {err:.3g} "
          f"(max|attr| {float(ref.abs().max()):.3g})", flush=True)
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
    dev = torch.device("cuda")

    info = _lib.build_info()
    print(f"kernels built in {info['seconds']:.2f} s -> {os.path.relpath(info['path'])}", flush=True)
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
    with tempfile.TemporaryDirectory() as workdir:
        serving = phase_serving(cfg, params1, params2, rng, workdir)
        phase_device_time(cfg, params1, dev, rng)
        training, _, (ckpt, x_test) = phase_training(cfg, dev, workdir)
        explain = phase_explain(cfg, dev, ckpt, x_test)
    phase_train_step_profile(cfg, dev)
    phase_trajectory(cfg, dev)

    src = "imagined_speech_decoding_tpu_torch/csrc/"
    pallas = "imagined_speech_decoding_tpu/ops/pallas/"
    b2 = bwd[BWD_SHAPES[0]]
    # library_ms: no single PyTorch call computes the IIR cascade, the fused
    # windowed head or its gradients.
    kernels = [
        {"name": "iir_sosfilt_time_major", "route": "cuda", "source": src + "iir.cu",
         "replaces": pallas + "iir.py:67", "launches": serving["iir"],
         **{k: iir[MAIN_BATCH][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                             "bound_by")}, "library_ms": None},
        {"name": "conv4head_fwd", "route": "cuda", "source": src + "conv4head.cu",
         "replaces": pallas + "conv4head.py:303", "launches": training["conv4head_fwd"],
         **head[MAIN_BATCH], "library_ms": None},
        {"name": "conv4head_bwd_w", "route": "cuda", "source": src + "conv4head_bwd.cu",
         "replaces": pallas + "conv4head.py:323", "launches": training["conv4head_bwd_w"],
         "max_abs_err": b2["w_err"], "ms": b2["w_ms"], "plain_ms": b2["plain_ms"],
         "bound_ms": b2["w_bound"][0], "bound_by": b2["w_bound"][1], "library_ms": None},
        {"name": "conv4head_bwd_x", "route": "cuda", "source": src + "conv4head_bwd.cu",
         "replaces": pallas + "conv4head.py:351", "launches": explain["conv4head_bwd_x"],
         "max_abs_err": b2["x_err"], "ms": b2["x_ms"], "plain_ms": b2["plain_ms"],
         "bound_ms": b2["x_bound"][0], "bound_by": b2["x_bound"][1], "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
