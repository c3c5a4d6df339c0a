#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, on a machine with a card

1. Prints the card (``nvidia-smi`` name and power limit) and versions.
2. Builds the hand-written CUDA kernels from ``csrc/`` and prints the
   build time.
3. Holds each kernel against its plain PyTorch version on the card, in
   f32 with TF32 off, at the serving path's shapes, and times both with
   CUDA events:
     B1 (IIR cascade): 60 Hz notch then 4-40 Hz band-pass ``sosfiltfilt``
        on (B, 64, 800); tolerance rtol 1e-4, atol 1e-4 * max|ref|
        (the JAX package's Pallas IIR tolerance, tests/test_pallas.py).
     B2 (Conv4Layers head forward) at full width; rtol 1e-4, atol 1e-5.
4. Drives the main path: full-width FAST weights from a numpy seed are
   written as a checkpoint, the port's ``cli.serve`` serves it over TCP,
   and a ``DecoderClient`` sends INFO, DECODE at B = 1 and B = 8, RELOAD
   to a second checkpoint, and DECODE again. The posteriors must be
   finite, sum to 1 and match the port's plain CPU forward of the same
   weights (rtol 1e-4, atol 1e-5), and both kernels' launch counters must
   have moved during those requests.

The line before the last is a JSON object of the kernels; the last line
is ``{"ok": true, "device": {...}}``. Any failed phase raises, and the
script exits non-zero. Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from scipy.signal import tf2sos
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from imagined_speech_decoding_tpu_torch.cli.serve import build_parser, build_server
from imagined_speech_decoding_tpu_torch.config import FASTConfig
from imagined_speech_decoding_tpu_torch.data.constants import SFREQ
from imagined_speech_decoding_tpu_torch.models.fast import FAST
from imagined_speech_decoding_tpu_torch.ops.cuda import _lib
from imagined_speech_decoding_tpu_torch.ops.cuda.conv4head import (
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
from imagined_speech_decoding_tpu_torch.train.checkpoint import save_model_npz
from imagined_speech_decoding_tpu_torch.transplant import (
    from_jax_params,
    init_jax_layout_params,
)

SEED = 0
IIR_RTOL = 1e-4  # atol = IIR_RTOL * max|ref|
HEAD_RTOL, HEAD_ATOL = 1e-4, 1e-5
POST_RTOL, POST_ATOL = 1e-4, 1e-5
MAIN_BATCH = 8  # the main path's largest request; the JSON line's shapes
REQUESTS = 100  # timed DECODE requests per batch size


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
        rows[b] = {
            "chain_ms": cuda_ms(lambda: chain(x, sosfilt_time_major), 20),
            "chain_plain_ms": cuda_ms(lambda: chain(x, sosfilt_time_major_plain), 2),
            "chain_max_abs_err": err,
            "ms": cuda_ms(lambda: sosfilt_time_major(band, xt, zi), 50),
            "plain_ms": cuda_ms(lambda: sosfilt_time_major_plain(band, xt, zi), 2),
            "max_abs_err": k_err,
        }
        print(f"B1 B={b:<4} (854, {b * 64}) band-pass pass: kernel {rows[b]['ms']:.4f} ms, "
              f"plain {rows[b]['plain_ms']:.3f} ms, max|err| {k_err:.3g}; notch+band "
              f"sosfiltfilt: kernel {rows[b]['chain_ms']:.3f} ms, plain "
              f"{rows[b]['chain_plain_ms']:.3f} ms, max|err| {err:.3g}", flush=True)
    return rows


def phase_head(model, dev, rng):
    """B2 against its plain version at full width."""
    cfg = model.cfg
    ops = model.head.prepare_fused_weights()
    rows = {}
    for b in (1, MAIN_BATCH, 64):
        x = torch.tensor(rng.normal(size=(b, 64, 800)).astype(np.float32), device=dev)
        ref = fused_conv4_head_plain(x, *ops, cfg.window_len, cfg.slide_step)
        got = fused_conv4_head(x, *ops, cfg.window_len, cfg.slide_step)
        err = check_close(f"B2 B={b}", got, ref, HEAD_RTOL, HEAD_ATOL)
        rows[b] = {
            "ms": cuda_ms(lambda: fused_conv4_head(x, *ops, cfg.window_len, cfg.slide_step), 50),
            "plain_ms": cuda_ms(
                lambda: fused_conv4_head_plain(x, *ops, cfg.window_len, cfg.slide_step), 20),
            "max_abs_err": err,
        }
        print(f"B2 B={b:<4} head forward: kernel {rows[b]['ms']:.4f} ms, plain "
              f"{rows[b]['plain_ms']:.4f} ms, max|err| {err:.3g}", flush=True)
    return rows


def phase_main_path(cfg, params1, params2, rng, workdir):
    """Serve checkpoints through the port's CLI and decode over TCP."""
    ckpt1 = os.path.join(workdir, "FAST", "sub-01", "best_subject.npz")
    ckpt2 = os.path.join(workdir, "FAST", "sub-02", "best_subject.npz")
    save_model_npz(ckpt1, params1, {"head": {}})
    save_model_npz(ckpt2, params2, {"head": {}})
    server = build_server(build_parser().parse_args(["--checkpoint", ckpt1, "--port", "0"]))
    # One untimed warm-up request per batch size, then REQUESTS timed ones.
    sizes = [1, MAIN_BATCH] + [1] * REQUESTS + [MAIN_BATCH] * REQUESTS
    batches = [rng.normal(size=(b, 64, 800)).astype(np.float32) for b in sizes]

    sosfilt_time_major.launches = 0
    fused_conv4_head.launches = 0
    latencies, posts = [], []
    with server, DecoderClient(*server.address) as client:
        info = client.info()
        for x in batches:
            t0 = time.perf_counter()
            posts.append(client.decode(x))
            latencies.append(time.perf_counter() - t0)
        client.reload(ckpt2)
        post_reloaded = client.decode(batches[-1])
    launches = {"iir": sosfilt_time_major.launches, "conv4head": fused_conv4_head.launches}
    print(f"main path: INFO {json.dumps(info)}", flush=True)
    print(f"main path: kernel launches during the requests {launches}", flush=True)
    for name, n in launches.items():
        if n < 1:
            raise RuntimeError(f"the main path never launched the {name} kernel")
    if info["device"] != "cuda" or info["n_channels"] != 64 or info["n_classes"] != cfg.n_classes:
        raise RuntimeError(f"unexpected INFO {info}")

    verify_against_cpu(cfg, params1, params2, batches, posts, post_reloaded)
    for b in (1, MAIN_BATCH):
        ms = [1e3 * t for t, x in zip(latencies[2:], batches[2:]) if x.shape[0] == b]
        p50, p90, p99 = np.percentile(ms, [50, 90, 99])
        print(f"main path: DECODE B={b} over TCP, closed loop, one client, host clock: "
              f"p50 {p50:.3f} ms, p90 {p90:.3f} ms, p99 {p99:.3f} ms, max {max(ms):.3f} ms "
              f"({len(ms)} requests)", flush=True)
    print("main path: posteriors finite, sum to 1, match the plain CPU forward "
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

    cfg = FASTConfig.default()
    rng = np.random.default_rng(SEED)
    params1 = init_jax_layout_params(cfg, SEED)
    params2 = init_jax_layout_params(cfg, SEED + 1)
    model = FAST(cfg, device=dev)
    model.load_state_dict(from_jax_params(params1))

    with torch.inference_mode():
        iir = phase_iir(dev, rng)
        head = phase_head(model, dev, rng)
    with tempfile.TemporaryDirectory() as workdir:
        launches = phase_main_path(cfg, params1, params2, rng, workdir)
    phase_device_time(cfg, params1, dev, rng)

    kernels = [
        {"name": "iir_sosfilt_time_major", "route": "cuda",
         "source": "imagined_speech_decoding_tpu_torch/csrc/iir.cu",
         "replaces": "imagined_speech_decoding_tpu/ops/pallas/iir.py:67",
         "launches": launches["iir"], **{k: iir[MAIN_BATCH][k] for k in ("max_abs_err", "ms", "plain_ms")}},
        {"name": "conv4head_fwd", "route": "cuda",
         "source": "imagined_speech_decoding_tpu_torch/csrc/conv4head.cu",
         "replaces": "imagined_speech_decoding_tpu/ops/pallas/conv4head.py:303",
         "launches": launches["conv4head"], **head[MAIN_BATCH]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
