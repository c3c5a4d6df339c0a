"""B2w-bf16's wgmma route, emulated on the CPU, against the plain bf16
backward and the JAX package.

Kernel B2w-bf16 (``csrc/conv4head_bwd_w_bf16.cu``) runs every product as
a warpgroup GEMM (wgmma m64n32k16) whose operands it reads from shared
memory through descriptors: the time-major buffers in chunks of 8
channels, h1 and h2 with a copy one row down, the weight gradients held
in f32 accumulator tiles across a block's trials, a window past 260
samples in column tiles with an 8-row halo and masked edge chunks.
``ops/cuda/conv4head.py`` mirrors its plan (``bwd_w_bf16_plan``, its
column tiles ``bwd_w_bf16_col_tiles``) and descriptors
(``bwd_w_bf16_conv_descs``, ``bwd_w_bf16_dw_descs``);
``tests/wgmma_emulation.py`` gathers every operand tile through those
descriptors from a flat image of shared memory and multiplies it in f32,
k16 step by k16 step, in the kernel's order. This file holds that the
plan fits, that every descriptor is legal and stays inside its operand,
and that the emulation equals the plain bf16 backward
(``conv4head_bwd_bf16_plain``, at the card tests' tolerance) and the
JAX package's Pallas head in bf16 (interpret mode, at
``tests/test_torch_bf16.py``'s tolerances). On the card,
``tests/test_torch_cuda.py`` runs the same descriptors through wgmma.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from imagined_speech_decoding_tpu.ops.pallas.conv4head import fused_conv4_head as pallas_head
from imagined_speech_decoding_tpu_torch.ops.cuda.conv4head import (
    MAX_SMEM_BYTES,
    WG_GROUPS,
    WG_ROWS,
    WG_SLOTS,
    BWD_W_BF16_PHASES,
    _check_smem,
    bwd_w_bf16_col_tiles,
    bwd_w_bf16_conv_descs,
    bwd_w_bf16_edge,
    bwd_w_bf16_dw_descs,
    bwd_w_bf16_plan,
    bwd_w_bf16_smem_bytes,
    bwd_w_bf16_tiles,
    conv4head_bwd_bf16_plain,
)
from wgmma_emulation import _slots, emulate_bwd_w_bf16, selftest_cases, wgmma

torch.set_num_threads(1)

BF16_BWD_REL = 1e-3  # tests/test_torch_cuda.py: |err| <= REL * max|ref| per tensor, card vs plain
# tests/test_torch_bf16.py: the plain bf16 backward against the Pallas VJP in bf16, max|err| /
# max|ref| per tensor (bf16(dh1) flips one ulp where dp3's f32 sums round near a boundary).
PALLAS_REL = {"dw12": 1.5e-3, "db12": 5e-4, "dw3": 5e-4, "dw4": 5e-4}
NAMES = ("dw12", "db12", "dw3", "dw4")
FULL = dict(c=64, z=8, t=800, w=250, step=125)  # FASTConfig.default()'s head
SMALL = dict(c=10, z=4, t=200, w=100, step=50)  # tests/test_torch_bf16.py's head
EDGE = dict(c=64, z=2, t=230, w=120, step=37)  # t1 = 116, windows of odd parity
LONG = dict(c=10, z=2, t=650, w=500, step=150)  # 2-second windows: two column tiles
LONG_WINDOWS = (261, 280, 292, 500, 800)  # past 260 samples: column tiles
CLOCK_BYTES = 16 * 8 * len(BWD_W_BF16_PHASES)  # the debug instantiation's counters


def operands(m, b, c, z, t, w, step, seed, o=32, k=5):
    """``(g, x bf16, w12, b12, w3, w4)`` with the model axis, from numpy."""
    rng = np.random.default_rng(seed)
    n = (t - w) // step + 1

    def normal(shape, scale):
        return torch.tensor((scale * rng.normal(size=shape)).astype(np.float32))

    x = normal((m, b, c, t), 1.0).to(torch.bfloat16)
    return (normal((m, b, n, z * o), 1.0), x, normal((m, z * o, k * c), (k * c) ** -0.5),
            normal((m, z * o, 1), 0.1), normal((m, z, o, k * o), (k * o) ** -0.5),
            normal((m, z, o, k * o), (k * o) ** -0.5))


def rel_max(a, ref) -> float:
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("c,w", [(64, 250), (10, 250), (64, 120), (1, 250), (33, 260),
                                 (64, 261), (64, 500), (1, 800)])
def test_plan_fits_shared_memory(c, w):
    """The plan at full width (225,280 bytes, one column tile, as before
    column tiles), C = 10, the t1 = 116 edge and others fits one block's
    227 KB, and its tiles fit the registers; past 260 samples the plan of a
    column tile (230,656 bytes at C = 64, the debug instantiation's
    counters too)."""
    plan = bwd_w_bf16_plan(c, w)
    assert plan["total"] <= MAX_SMEM_BYTES
    assert len(bwd_w_bf16_tiles(plan)) <= WG_SLOTS * WG_GROUPS
    assert bwd_w_bf16_smem_bytes(c, w, 32, 5) == plan["total"]
    assert plan["tiles"] == (1 if w <= 260 else -(-(w - 4 - 16) // 240))
    if (c, w) == (64, 250):
        assert plan["total"] == 225280 and len(bwd_w_bf16_tiles(plan)) == 11
        assert plan["nt"] == 4 * WG_ROWS and plan["rows"] == 260 and plan["mk"] == plan["total"]
    if (c, w) == (64, 500):
        assert plan["total"] == 230656 and plan["total"] + CLOCK_BYTES <= MAX_SMEM_BYTES
        assert [(t["s"], t["nt"], t["lo"], t["hi"]) for t in bwd_w_bf16_col_tiles(plan)] == [
            (0, 256, 0, 248), (240, 256, 8, 256)]


def test_admitted_geometries():
    """Every C up to 64 at every window up to 800 samples (column tiles
    past 260) fits both the shared memory, the debug instantiation's
    counters included, and the accumulator slots (11 tiles, 3 a
    warpgroup); the column tiles own every row of the window once. Past
    C = 64 the wrapper refuses: C = 65 at W = 250 by shared memory, C = 130
    at W = 60 (which fits it) by registers."""
    for c in range(1, 65):
        for w in (60, 120, 250, 260, 261, 280, 292, 300, 500, 501, 737, 800):
            plan = bwd_w_bf16_plan(c, w)
            assert plan["total"] + CLOCK_BYTES <= MAX_SMEM_BYTES, (c, w)
            assert bwd_w_bf16_smem_bytes(c, w, 32, 5) == plan["total"]
            owned = [t["s"] + r for t in bwd_w_bf16_col_tiles(plan)
                     for r in range(t["lo"], t["hi"])]
            assert owned == list(range(plan["t1"])), (c, w)
    assert -(-len(bwd_w_bf16_tiles(bwd_w_bf16_plan(64, 250))) // WG_GROUPS) == 3
    assert bwd_w_bf16_plan(65, 250)["total"] > MAX_SMEM_BYTES
    assert bwd_w_bf16_plan(130, 60)["total"] <= MAX_SMEM_BYTES
    assert bwd_w_bf16_smem_bytes(130, 60, 32, 5) == -1  # the library's size: not built
    with pytest.raises(ValueError, match="B2w-bf16 is not built"):
        _check_smem(bwd_w_bf16_smem_bytes(130, 60, 32, 5), "B2w-bf16")


def _regions(plan):
    names = ("xs", "raw", "h1", "h2", "d3", "d2", "d1", "w12", "w3", "w4", "bias")
    regions = {a: (plan[a], plan[b]) for a, b in zip(names, names[1:])}
    if plan["tiles"] > 1:  # each masked edge chunk on its own
        size = (plan["o"] // 8) * 256
        for d in ("d3", "d2"):
            for side in ("left", "right"):
                start = bwd_w_bf16_edge(plan, d, side)
                regions[f"{d} {side}"] = (start, start + size)
        assert plan["mk"] + 4 * size == plan["total"]
    return regions


def _check_operand(plan, desc, n_mn, mn_major, region):
    start, k_step, mn_step = desc
    assert start % 16 == 0 and k_step % 16 == 0 and mn_step % 16 == 0
    assert 0 < k_step < 16 << 14 and 0 < mn_step < 16 << 14 and start < 16 << 14
    slots = _slots(start, k_step, mn_step, n_mn, mn_major)
    lo, hi = _regions(plan)[region]
    assert lo <= 2 * int(slots.min()) and 2 * int(slots.max()) + 2 <= hi, (desc, region)


@pytest.mark.parametrize("geo", [FULL, SMALL, EDGE, LONG, dict(c=64, w=800), dict(c=33, w=280)],
                         ids=["full", "small", "edge", "long", "w800", "w280"])
def test_descriptors_are_aligned_and_stay_in_their_operands(geo):
    """Every k16 step of every conv tile and weight-gradient tile of every
    column tile: starts and steps in whole 16-byte units (each tap's shift
    included), inside the descriptor's 14-bit fields, and every byte it
    reads inside the operand's own buffer; the edge steps of dw4 and dw3
    inside their own masked chunk of dh3c or dh2c, on the tile's interior
    edges only."""
    plan = bwd_w_bf16_plan(geo["c"], geo["w"])
    weights = {"xs": "w12", "h1": "w3", "h2": "w4", "d3": "w4", "d2": "w3"}
    for src, transposed in (("xs", False), ("h1", False), ("h2", False), ("d3", True),
                            ("d2", True)):
        for tile in range(plan["nt"] // WG_ROWS):
            steps = bwd_w_bf16_conv_descs(plan, src, tile, transposed)
            assert len(steps) == plan["k"] * (plan["cp"] if src == "xs" else plan["o"]) // 16
            for a, b in steps:
                _check_operand(plan, a, WG_ROWS, False, src)
                _check_operand(plan, b, plan["o"], transposed, weights[src])
    sources = {"dw4": ("h2", "d3"), "dw3": ("h1", "d2"), "dw12": ("xs", "d1")}
    for ct in bwd_w_bf16_col_tiles(plan):
        for kind, index in bwd_w_bf16_tiles(plan):
            steps = bwd_w_bf16_dw_descs(plan, kind, index, ct)
            assert len(steps) == ct["nt"] // 16
            for i, (a, b) in enumerate(steps):
                _check_operand(plan, a, WG_ROWS, True, sources[kind][0])
                d = sources[kind][1]
                side = ("left" if i == 0 and ct["left"] else
                        "right" if i == len(steps) - 1 and ct["right"] else None)
                _check_operand(plan, b, plan["o"], True,
                               d if kind == "dw12" or side is None else f"{d} {side}")


@pytest.mark.parametrize("case", range(5))
def test_selftest_cases_match_their_logical_products(case):
    """The card's one-tile descriptor self-tests, emulated: gathering the
    image through the mirror's descriptors gives the product written from
    the logical matrices (so the card test compares like with like)."""
    img, cases = selftest_cases(bwd_w_bf16_plan(64, 250))
    name, steps, a_mn_major, b_mn_major, expected = cases[case]
    got = wgmma(img, steps, a_mn_major, b_mn_major)[0].double()
    assert float((got - expected).abs().max()) <= 1e-5 * float(expected.abs().max()), name


@pytest.mark.parametrize("geo,m,b,s", [(SMALL, 2, 5, 2), (FULL, 1, 3, 1), (EDGE, 1, 3, 3)],
                         ids=["small", "full", "edge"])
def test_emulation_matches_plain_bf16_backward(geo, m, b, s):
    """The emulated kernel (trial ranges of ``s``, weight gradients carried
    across each range's trials) against ``conv4head_bwd_bf16_plain``: the
    same rounding points, f32 sums in another order, so within the card
    tests' 1e-3 x max|ref| per tensor."""
    ops = operands(m, b, **geo, seed=geo["c"] + b)
    got = emulate_bwd_w_bf16(*ops, geo["w"], geo["step"], s=s)
    ref = conv4head_bwd_bf16_plain(*ops, geo["w"], geo["step"])[1:]
    for name, a, r in zip(NAMES, got, ref):
        assert a.shape == r.shape, name
        assert rel_max(a, r) <= BF16_BWD_REL, (name, rel_max(a, r))


@pytest.mark.parametrize("c", [1, 10, 33, 64])
@pytest.mark.parametrize("w", LONG_WINDOWS)
def test_column_tiles_match_plain_bf16_backward(w, c):
    """Windows past 260 samples (two column tiles up to 496 conv rows, four
    at 800; the last one short at 261, 280 and 292), the emulated kernel
    with its halos, masked edge chunks and weight gradients carried across
    tiles and trials (two trial ranges at 280) against
    ``conv4head_bwd_bf16_plain``, at the card tests' 1e-3 x max|ref| per
    tensor."""
    step = {261: 130, 280: 130, 292: 127, 500: 150, 800: 1}[w]
    ops = operands(1, 2 if w == 280 else 1, c, 1, 800 if w > 500 else w + step, w, step,
                   seed=w + c)
    got = emulate_bwd_w_bf16(*ops, w, step, s=2 if w == 280 else 1)
    ref = conv4head_bwd_bf16_plain(*ops, w, step)[1:]
    for name, a, r in zip(NAMES, got, ref):
        assert a.shape == r.shape, name
        assert rel_max(a, r) <= BF16_BWD_REL, (name, rel_max(a, r))


def test_column_tiles_without_masked_edges_double_count(monkeypatch):
    """The masked edge chunks matter: with dh3c's and dh2c's own rows read
    at the interior edges instead, the 8 rows each side of an edge enter dw4
    and dw3 twice, far outside the tolerance (a check of the check)."""
    import wgmma_emulation

    geo = LONG
    ops = operands(1, 2, **geo, seed=3)
    ref = conv4head_bwd_bf16_plain(*ops, geo["w"], geo["step"])[1:]
    monkeypatch.setattr(wgmma_emulation, "bwd_w_bf16_dw_descs",
                        lambda plan, kind, index, tile: bwd_w_bf16_dw_descs(
                            plan, kind, index, dict(tile, left=False, right=False)))
    got = emulate_bwd_w_bf16(*ops, geo["w"], geo["step"])
    assert min(rel_max(got[3], ref[3]), rel_max(got[2], ref[2])) > 10 * BF16_BWD_REL
    assert rel_max(got[0], ref[0]) <= BF16_BWD_REL  # dw12 reads bf16(dh1), stored masked


def test_emulation_matches_pallas_vjp_in_bf16():
    """The emulated kernel against ``jax.grad`` through the JAX package's
    Pallas head (interpret mode) in bf16, at tests/test_torch_bf16.py's
    tolerances, each under the same tensor's bf16-vs-f32 gap."""
    geo, b = SMALL, 4
    g, x, w12, b12, w3, w4 = operands(1, b, **geo, seed=5)
    got = emulate_bwd_w_bf16(g, x, w12, b12, w3, w4, geo["w"], geo["step"], s=2)
    jw = [jnp.asarray(t[0].numpy()) for t in (w12, b12, w3, w4)]
    gj = jnp.asarray(g[0].numpy())

    def grads(dt):
        xx = jnp.asarray(x[0].float().numpy(), dt)

        def loss(*w):
            return jnp.sum(pallas_head(xx, *w, geo["w"], geo["step"]) * gj)

        with pltpu.force_tpu_interpret_mode():
            return [np.asarray(t, np.float32) for t in jax.grad(loss, argnums=(0, 1, 2, 3))(*jw)]

    ref16, ref32 = grads(jnp.bfloat16), grads(jnp.float32)
    for name, a, r16, r32 in zip(NAMES, got, ref16, ref32):
        err, gap = rel_max(a[0].numpy().reshape(r16.shape), r16), rel_max(r32, r16)
        assert err <= PALLAS_REL[name] < gap, (name, err, gap)


def test_column_tiles_match_pallas_vjp_in_bf16():
    """Windows of 500 (two column tiles): the emulated kernel against
    ``jax.grad`` through the JAX package's Pallas head (interpret mode) in
    bf16, at tests/test_torch_bf16.py's tolerances, each under the same
    tensor's bf16-vs-f32 gap."""
    geo, b = LONG, 2
    g, x, w12, b12, w3, w4 = operands(1, b, **geo, seed=7)
    got = emulate_bwd_w_bf16(g, x, w12, b12, w3, w4, geo["w"], geo["step"])
    jw = [jnp.asarray(t[0].numpy()) for t in (w12, b12, w3, w4)]
    gj = jnp.asarray(g[0].numpy())

    def grads(dt):
        xx = jnp.asarray(x[0].float().numpy(), dt)

        def loss(*w):
            return jnp.sum(pallas_head(xx, *w, geo["w"], geo["step"]) * gj)

        with pltpu.force_tpu_interpret_mode():
            return [np.asarray(t, np.float32) for t in jax.grad(loss, argnums=(0, 1, 2, 3))(*jw)]

    ref16, ref32 = grads(jnp.bfloat16), grads(jnp.float32)
    for name, a, r16, r32 in zip(NAMES, got, ref16, ref32):
        err, gap = rel_max(a[0].numpy().reshape(r16.shape), r16), rel_max(r32, r16)
        assert err <= PALLAS_REL[name] < gap, (name, err, gap)
