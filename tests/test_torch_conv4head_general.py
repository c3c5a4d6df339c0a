"""The general-geometry head kernels B2f-g, B2w-g and B2x-g
(``csrc/conv4head_general.cu``), run on the CPU, against the JAX package.

The kernels' device code uses nothing but barriers, so it builds with the
host compiler against the stand-in headers of ``tests/cuda_host/`` and
runs block by block, each block's 256 threads as fibers switched at
every ``__syncthreads`` (``tests/cuda_host/general_host.cpp``). That runs
the kernels' own blocking: 32 x 64 output tiles, reductions in chunks of
32 channels (or of O, or of time), the taps' shifted reads that cross a
tile's edge into the next tile's columns of the workspace, zeros at the
window's true ends, the persistent grid walking units through fewer
workspace slots than units, B2w-g's trial ranges written into their own
partials (the first trial writes) and summed here in the order of
``sum_partials.cuh``, B2x-g's zones added in order into the window's
slice, and the wrapper's overlap-add. Every workspace, partial and output
buffer starts as NaN, so a read of an element no phase wrote shows.

Held against ``jax.grad`` through the JAX package's ``fused_conv4_head``
(its Pallas kernels in interpret mode): in f32 at rtol 1e-4, atol 1e-4 *
max|ref| (``chip_smoke.py``'s head tolerances); in bf16 at
``tests/test_torch_bf16.py``'s: per tensor max|err| / max|ref| <= 1.5e-3
for dw12 and 5e-4 for db12, dw3 and dw4, dx within 1e-3 in relative L2,
and the features within 3e-4 of max|ref| (``chip_smoke.py``'s
``BF16_FWD_REL``; ``test_torch_bf16.py`` holds 2e-5 absolute on features
of max ~0.07), each asserted to sit under the same tensor's bf16-vs-f32
gap. Then FAST at ``window_len=500, slide_step=150`` (the geometry the
tuned plans do not reach), the port's plain path against JAX: logits and
the head's gradients.
"""

import ctypes
import dataclasses
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from imagined_speech_decoding_tpu.config import FASTConfig as JaxFASTConfig
from imagined_speech_decoding_tpu.models.fast import fast_apply, fast_init
from imagined_speech_decoding_tpu.ops.pallas.conv4head import fused_conv4_head as pallas_head
from imagined_speech_decoding_tpu_torch.config import FASTConfig
from imagined_speech_decoding_tpu_torch.models.fast import FAST
from imagined_speech_decoding_tpu_torch.ops.cuda.conv4head import (
    GENERAL_OPS,
    _overlap_add,
    general_plan,
)
from imagined_speech_decoding_tpu_torch.transplant import from_jax_params

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST = os.path.join(ROOT, "tests", "cuda_host")
CSRC = os.path.join(ROOT, "imagined_speech_decoding_tpu_torch", "csrc")
K = 5
F32_REL = 1e-4  # rtol, and atol = F32_REL * max|ref|
BF16_REL = {"out": 3e-4, "dw12": 1.5e-3, "db12": 5e-4, "dw3": 5e-4, "dw4": 5e-4}
BF16_DX_L2 = 1e-3
NAMES = ("out", "dx", "dw12", "db12", "dw3", "dw4")

# (C, O, T, W, step, Z, B): C = 10 in one channel chunk, C = 80 in three (the
# last partial); O = 16 and 48 (48 in two row tiles); t1 = 146 and 126 in
# three and two column tiles, each 'same' conv reading across their edges.
GEOMETRIES = {
    "c10_o16": dict(c=10, o=16, t=200, w=150, step=25, z=2, b=2),
    "c80_o48": dict(c=80, o=48, t=160, w=130, step=30, z=2, b=1),
}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/conv4head_general.cu's device code built with the host compiler."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "the general kernels' CPU run needs a C++ compiler (g++)"
    out = str(tmp_path_factory.mktemp("general_host") / "libgeneral_host.so")
    subprocess.run([cxx, "-O2", "-std=c++17", "-fno-strict-aliasing", "-fPIC", "-shared",
                    "-I", HOST, "-I", CSRC, os.path.join(HOST, "general_host.cpp"), "-o", out],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(out)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.emu_fwd_general.argtypes = [i] + [p] * 7 + [i] * 10
    lib.emu_bwd_w_general.argtypes = [i] + [p] * 11 + [i] * 11
    lib.emu_bwd_x_general.argtypes = [i] + [p] * 8 + [i] * 10
    lib.isd_conv4head_general_slot_floats.argtypes = [i] * 3
    lib.isd_conv4head_general_slot_floats.restype = ctypes.c_longlong
    return lib


def nan(*shape):
    return torch.full(shape, float("nan"))


def emulate(lib, op, g, x, w12, b12, w3, w4, window, step, slots):
    """``op`` through the general kernel on the CPU with ``slots`` resident
    blocks: what ``conv4head._launch_general`` returns."""
    m, b, c, t = x.shape
    z, o = w3.shape[1:3]
    n = (t - window) // step + 1
    plan = general_plan(op, m, b, z, n, slots)
    work = nan(plan["grid"] * lib.isd_conv4head_general_slot_floats(GENERAL_OPS.index(op), o,
                                                                     window))
    geo = (m, b, c, t, z, o, window, step, n)
    bf16 = int(x.dtype == torch.bfloat16)
    ptr = [a.data_ptr() for a in (x, w12, b12, w3, w4)]
    if op == "fwd":
        out = nan(m, b, n, z * o)
        assert lib.emu_fwd_general(bf16, *ptr, out.data_ptr(), work.data_ptr(), *geo,
                                   plan["grid"]) == 0
        return out
    if op == "bwd_w":
        p = n * plan["splits"]
        parts = [nan(m, p, *a.shape[1:]) for a in (w12, b12, w3, w4)]
        assert lib.emu_bwd_w_general(bf16, g.data_ptr(), *ptr, *(a.data_ptr() for a in parts),
                                     work.data_ptr(), *geo, plan["splits"], plan["grid"]) == 0
        sums = []
        for part in parts:  # sum_partials.cuh: from 0, partial after partial
            acc = torch.zeros_like(part[:, 0])
            for q in range(p):
                acc = acc + part[:, q]
            sums.append(acc)
        return tuple(sums)
    dxw = nan(m, b, n, c, window)
    assert lib.emu_bwd_x_general(bf16, g.data_ptr(), *ptr, dxw.data_ptr(), work.data_ptr(),
                                 *geo, plan["grid"]) == 0
    return _overlap_add(dxw, x, step)


def operands(c, o, t, w, step, z, b, m=1, seed=0):
    """(g, x, w12, b12, w3, w4) from a numpy seed, f32, the weights at the
    scales of a trained head."""
    rng = np.random.default_rng(seed)
    n = (t - w) // step + 1
    f32 = lambda shape, s=1.0: torch.from_numpy((s * rng.normal(size=shape)).astype(np.float32))  # noqa: E731
    return (f32((m, b, n, z * o)), f32((m, b, c, t)), f32((m, z * o, K * c), (K * c) ** -0.5),
            f32((m, z * o, 1), 0.1), f32((m, z, o, K * o), (K * o) ** -0.5),
            f32((m, z, o, K * o), (K * o) ** -0.5))


def jax_reference(g, x, w12, b12, w3, w4, window, step, bf16):
    """Model 0's features and ``(dx, dw12, db12, dw3, dw4)`` from the JAX
    package's Pallas head in interpret mode, in bf16 or f32."""
    ops = [jnp.asarray(a[0].numpy()) for a in (w12, b12, w3, w4)]
    xx = jnp.asarray(x[0].numpy(), jnp.bfloat16 if bf16 else jnp.float32)
    gg = jnp.asarray(g[0].numpy())

    def loss(xv, *wv):
        return jnp.sum(pallas_head(xv, *wv, window, step) * gg)

    with pltpu.force_tpu_interpret_mode():
        out = pallas_head(xx, *ops, window, step)
        grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(xx, *ops)
    return [np.asarray(a, np.float32) for a in (out, *grads)]


def rel_max(a, r) -> float:
    return float(np.abs(a - r).max() / np.abs(r).max())


def l2(a, r) -> float:
    return float(np.linalg.norm(a - r) / np.linalg.norm(r))


@pytest.fixture(scope="module", params=sorted(GEOMETRIES))
def case(request):
    """One geometry's operands and JAX's f32 and bf16 results."""
    geo = GEOMETRIES[request.param]
    ops = operands(**geo)
    ref = {bf16: jax_reference(*ops, geo["w"], geo["step"], bf16) for bf16 in (False, True)}
    return geo, ops, ref


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_general_kernels_match_jax(host_lib, case, precision):
    """B2f-g, B2w-g and B2x-g in one precision on a geometry, with fewer
    workspace slots (3) than units: the features, the weight gradients and
    dx against the Pallas head's custom VJP."""
    geo, ops, ref = case
    bf16 = precision == "bf16"
    g, x, *weights = ops
    x = x.to(torch.bfloat16) if bf16 else x
    window, step = geo["w"], geo["step"]
    out = emulate(host_lib, "fwd", g, x, *weights, window, step, slots=3)
    dx = emulate(host_lib, "bwd_x", g, x, *weights, window, step, slots=3)
    dw = emulate(host_lib, "bwd_w", g, x, *weights, window, step, slots=3)
    assert dx.dtype == x.dtype
    got = [out[0].numpy(), dx[0].float().numpy(), dw[0][0].numpy(), dw[1][0].numpy(), dw[2][0].numpy(),
           dw[3][0].numpy()]
    for name, a, r, r32 in zip(NAMES, got, ref[bf16], ref[False]):
        r = r.reshape(a.shape)
        if not bf16:
            np.testing.assert_allclose(a, r, rtol=F32_REL, atol=F32_REL * np.abs(r).max(),
                                       err_msg=name)
            continue
        measure, tol = (l2, BF16_DX_L2) if name == "dx" else (rel_max, BF16_REL[name])
        err, gap = measure(a, r), measure(r32.reshape(a.shape), r)
        assert err <= tol < gap, (name, err, tol, gap)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_slots_and_trial_ranges(host_lib, precision):
    """The persistent grid's slot count changes no bit of B2f-g's or
    B2x-g's results (a unit's arithmetic does not depend on its block),
    and B2w-g with S = 2 trial ranges a (zone, window) (64 slots) agrees
    with S = 1 (2 slots) within the f32 tolerance: only the order of the
    partials' sum moves."""
    geo = GEOMETRIES["c10_o16"]
    g, x, *weights = operands(**geo, seed=3)
    x = x.to(torch.bfloat16) if precision == "bf16" else x
    window, step = geo["w"], geo["step"]
    n = (geo["t"] - window) // step + 1
    assert general_plan("bwd_w", 1, geo["b"], geo["z"], n, 64)["splits"] == 2
    assert general_plan("bwd_w", 1, geo["b"], geo["z"], n, 2)["splits"] == 1
    for op in ("fwd", "bwd_x"):
        a, b = (emulate(host_lib, op, g, x, *weights, window, step, slots=s) for s in (2, 64))
        assert torch.equal(a, b), op
    split = emulate(host_lib, "bwd_w", g, x, *weights, window, step, slots=64)
    whole = emulate(host_lib, "bwd_w", g, x, *weights, window, step, slots=2)
    for a, r in zip(split, whole):
        torch.testing.assert_close(a, r, rtol=F32_REL, atol=F32_REL * float(r.abs().max()))


@pytest.mark.parametrize("op,m,b,z,n,slots,want", [
    ("fwd", 75, 64, 8, 3, 528, dict(units=115200, grid=528, splits=1)),
    ("bwd_w", 75, 64, 8, 3, 528, dict(units=1800, grid=528, splits=1)),
    ("bwd_w", 2, 8, 8, 1, 528, dict(units=128, grid=128, splits=8)),
    ("bwd_w", 1, 100, 8, 5, 528, dict(units=520, grid=520, splits=13)),
    ("bwd_w", 1, 2, 8, 1, 528, dict(units=16, grid=16, splits=2)),
    ("bwd_x", 1, 100, 8, 5, 528, dict(units=500, grid=500, splits=1)),
])
def test_general_plan(op, m, b, z, n, slots, want):
    """Units, grid and B2w-g's trial ranges: at most one block a slot, and
    B2w-g splits a (model, zone, window)'s trials as far as its units fit
    the slots in one wave (never past one trial a range)."""
    assert general_plan(op, m, b, z, n, slots) == want


# FAST at 2-second windows: the geometry section 14 of chip_smoke.py trains.
W500 = dict(window_len=500, slide_step=150, dropout=0.0)


def test_fast_window_500_matches_jax():
    """FAST (``FASTConfig.default()`` at windows of 500, step 150: 3 windows
    of 800 samples, 64 channels, 8 zones, dim 32), the port's plain path on
    the CPU against the JAX package: eval logits at rtol 1e-4 / atol 1e-5
    (``tests/test_torch_fast.py``), and the gradients of the head's
    parameters and of x under a random cotangent of the logits at 1e-4 of
    max|ref| per tensor (``tests/test_torch_conv4head_grad.py``)."""
    jcfg = JaxFASTConfig.default().replace(**W500)
    params, state = fast_init(jax.random.PRNGKey(11), jcfg)
    params = jax.tree.map(np.asarray, params)
    cfg = dataclasses.replace(FASTConfig.default(), **W500)
    assert cfg.n_tokens == 3
    model = FAST(cfg).eval()
    model.load_state_dict(from_jax_params(params))
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 64, 800)).astype(np.float32)
    cot = rng.normal(size=(2, cfg.n_classes)).astype(np.float32)

    def loss(p, xx):
        return jnp.sum(fast_apply(p, state, xx, jcfg, train=False)[0] * cot)

    ref = fast_apply(params, state, jnp.asarray(x), jcfg, train=False)[0]
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    logits = model(xt)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    (logits * torch.from_numpy(cot)).sum().backward()
    grads = {"x": (xt.grad.numpy(), np.asarray(gx))}
    for leaf, name in (("cnn1", "cnn1_weight"), ("cnn2", "cnn2_weight"), ("cnn3", "cnn3_weight"),
                       ("cnn4", "cnn4_weight")):
        grads[leaf] = (getattr(model.head, name).grad.numpy(), np.asarray(gp["head"][leaf]["w"]))
    for name, (a, r) in grads.items():
        assert a.shape == r.shape, name
        assert rel_max(a, r) < 1e-4, (name, rel_max(a, r))
