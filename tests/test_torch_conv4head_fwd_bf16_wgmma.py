"""B2f-bf16's wgmma route, emulated on the CPU, against the plain bf16
forward and the JAX package.

Kernel B2f-bf16 (``csrc/conv4head_fwd_bf16.cu``) runs a trial's first
conv once over the h1 columns its windows use, in sub-blocks of 256 rows,
stores each column into the rows of every window that holds it (windows
stacked with zero pads between them), and runs each window's two 'same'
convs on its own rows, every product a wgmma m64n32k16 from shared
memory. ``ops/cuda/conv4head.py`` mirrors its plan (``fwd_bf16_plan``),
the epilogue's walk over the windows (``fwd_bf16_h1_rows``), its
descriptors (``fwd_bf16_conv_descs``) and its GELU (``gelu_fit``);
``tests/wgmma_emulation.py`` replays them byte by byte on an image of
shared memory, and its ldmatrix.trans transpose lane by lane. This file
holds that the plan fits, that every descriptor is legal and stays in its
operand, that the emulation equals the plain bf16 forward
(``fused_conv4_head_plain`` on a bf16 x, at the card tests' 3e-4 x
max|ref|) and the JAX package's Pallas head in bf16 (interpret mode), with
windows that overlap (by one and by three) and windows that do not, and
that a layout without the windows' own pads would fail. On the card,
``tests/test_torch_cuda.py`` runs the same descriptors through wgmma.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from imagined_speech_decoding_tpu.ops.pallas.conv4head import fused_conv4_head as pallas_head
from imagined_speech_decoding_tpu_torch.ops.cuda import conv4head
from imagined_speech_decoding_tpu_torch.ops.cuda.conv4head import (
    FWD_BF16_PHASES,
    FWD_CLOCK_BYTES,
    FWD_SB,
    GELU_CLAMP,
    GELU_EXP2_POLY,
    MAX_SMEM_BYTES,
    WG_ROWS,
    _fwd_bf16_windows,
    fused_conv4_head_plain,
    fwd_bf16_conv_descs,
    fwd_bf16_h1_rows,
    fwd_bf16_plan,
    gelu_fit,
)
from wgmma_emulation import (
    _slots,
    emulate_fwd_bf16,
    fwd_selftest_cases,
    ldmatrix_transpose,
    wgmma,
)

torch.set_num_threads(1)

BF16_FWD_REL = 3e-4  # tests/test_torch_cuda.py: |err| <= REL * max|ref|, card vs plain
FULL = dict(c=64, z=8, t=800, w=250, step=125)  # FASTConfig.default()'s head: N = 5
OVERLAP = dict(c=16, z=2, t=40, w=20, step=10)  # N = 3, t1 = 16: each window overlaps the next
APART = dict(c=16, z=2, t=68, w=20, step=24)  # N = 3: gaps of 8 h1 columns between windows
DEEP = dict(c=10, z=2, t=400, w=120, step=37)  # N = 8: a column in up to 4 windows; 2 sub-blocks
ODD = dict(c=64, z=2, t=230, w=120, step=37)  # t1 = 116, windows of odd parity
LONG = dict(c=8, z=1, t=450, w=300, step=150)  # t1 = 296: five time tiles a window


def plan_bytes(c, w, step, n, o=32, k=5):
    """The library's ``isd_conv4head_fwd_bf16_smem_bytes``, from the mirror."""
    return fwd_bf16_plan(c, w, step, n, o, k)["total"]


def operands(m, b, c, z, t, w, step, seed, o=32, k=5):
    """``(x bf16, w12, b12, w3, w4)`` with the model axis, from numpy."""
    rng = np.random.default_rng(seed)

    def normal(shape, scale):
        return torch.tensor((scale * rng.normal(size=shape)).astype(np.float32))

    x = normal((m, b, c, t), 1.0).to(torch.bfloat16)
    return (x, normal((m, z * o, k * c), (k * c) ** -0.5), normal((m, z * o, 1), 0.1),
            normal((m, z, o, k * o), (k * o) ** -0.5), normal((m, z, o, k * o), (k * o) ** -0.5))


def rel_max(a, ref) -> float:
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def n_windows(geo) -> int:
    return (geo["t"] - geo["w"]) // geo["step"] + 1


@pytest.mark.parametrize("geo", [FULL, OVERLAP, APART, DEEP, ODD],
                         ids=["full", "overlap", "apart", "deep", "odd"])
def test_plan_fits_shared_memory(geo):
    """The plan, with the debug instantiation's counters, fits one block's
    227 KB; at full width it is the source's 224,640 bytes, the h1 rows
    5 windows of 250 (246 columns and 4 pad rows) and a tile's overrun."""
    plan = fwd_bf16_plan(geo["c"], geo["w"], geo["step"], n_windows(geo))
    assert plan["total"] + FWD_CLOCK_BYTES <= MAX_SMEM_BYTES
    if geo is FULL:
        assert plan["total"] == 224640 and plan["lh"] == 746 and plan["nsb"] == 3
        assert plan["rs"] == 250 and plan["rows_h1"] == 4 * 250 + 256 + 4
        assert plan["lx"] == 750 and plan["xr"] == 264


def test_windows_a_launch_takes():
    """Every C up to 64 at windows up to 260 fits the plan, with the debug
    instantiation's counters, for N = 5 windows a launch. A plan that does
    not fit takes fewer windows a launch (the wrapper runs groups of them):
    C = 72 at the shipped windows, and a trial of T = 1000 (N = 7); one
    window a launch holds C up to 104 at windows of 250, and windows of 300
    (t1 = 296: five time tiles, two rounds of the window teams) at C = 64.
    Past that (C = 112; windows of 600 at C = 64) the kernel is not built
    for the geometry and the wrapper raises."""
    for c in range(1, 65):
        for w in (20, 120, 250, 260):
            assert fwd_bf16_plan(c, w, w // 2, 5)["total"] + FWD_CLOCK_BYTES <= MAX_SMEM_BYTES
    assert _fwd_bf16_windows(64, 250, 125, 5, plan_bytes) == 5
    assert _fwd_bf16_windows(64, 250, 125, 7, plan_bytes) == 5
    assert 1 <= _fwd_bf16_windows(72, 250, 125, 5, plan_bytes) < 5
    assert _fwd_bf16_windows(104, 250, 125, 5, plan_bytes) == 1
    assert _fwd_bf16_windows(64, 300, 150, 2, plan_bytes) >= 1
    for c, w in ((112, 250), (64, 600)):
        with pytest.raises(ValueError, match="B2f-bf16 is not built"):
            _fwd_bf16_windows(c, w, w // 2, 5, plan_bytes)


@pytest.mark.parametrize("geo", [FULL, OVERLAP, APART, DEEP], ids=["full", "overlap", "apart",
                                                                  "deep"])
def test_h1_rows_hold_each_window_with_its_pads(geo):
    """The epilogue's walk stores column u into exactly the windows whose
    span holds it, at row i * rs + K/2 + (u - i * step); rows never stored
    are each window's K - 1 pads, which stay zero, and nothing lands past
    the buffer."""
    plan = fwd_bf16_plan(geo["c"], geo["w"], geo["step"], n_windows(geo))
    n, t1, step, rs, k = plan["n"], plan["t1"], plan["step"], plan["rs"], plan["k"]
    stored = set()
    for u in range(plan["lh"]):
        rows = fwd_bf16_h1_rows(plan, u)
        want = [i * rs + k // 2 + u - i * step for i in range(n) if 0 <= u - i * step < t1]
        assert sorted(rows) == sorted(want), u  # none in the gaps between windows apart
        stored.update(rows)
    for i in range(n):
        span = set(range(i * rs, (i + 1) * rs))
        assert span - stored == {i * rs + r for r in (0, 1, rs - 2, rs - 1)}
    assert max(stored) < plan["rows_h1"]


def _regions(plan):
    o = plan["o"]
    h2b = (o // 8) * plan["cs_h2"]
    return {"xs": (plan["xs"], plan["raw"]), "h1": (plan["h1"], plan["h2"]),
            "h2_0": (plan["h2"], plan["h2"] + h2b), "h2_1": (plan["h2"] + h2b, plan["w12"]),
            "w12": (plan["w12"], plan["w3"]), "w3": (plan["w3"], plan["w4"]),
            "w4": (plan["w4"], plan["bias"])}


def _check_operand(plan, desc, n_mn, region):
    start, k_step, mn_step = desc
    assert start % 16 == 0 and k_step % 16 == 0 and mn_step % 16 == 0
    assert 0 < k_step < 16 << 14 and 0 < mn_step < 16 << 14 and start < 16 << 14
    slots = _slots(start, k_step, mn_step, n_mn, False)
    lo, hi = _regions(plan)[region]
    assert lo <= 2 * int(slots.min()) and 2 * int(slots.max()) + 2 <= hi, (desc, region)


@pytest.mark.parametrize("geo", [FULL, OVERLAP, DEEP, ODD], ids=["full", "overlap", "deep", "odd"])
def test_descriptors_are_aligned_and_stay_in_their_operands(geo):
    """Every k16 step of every conv tile (h1 of each sub-block, h2 of each
    window, h3 from either h2 buffer): starts and steps in whole 16-byte
    units, inside the descriptor's 14-bit fields, every byte read inside
    the operand's own buffer; a conv2 tile of window i starts at its own
    rows, i * rs."""
    plan = fwd_bf16_plan(geo["c"], geo["w"], geo["step"], n_windows(geo))
    tiles = plan["nt"] // WG_ROWS
    cases = [("h1", sb, tile, "xs", "w12") for sb in range(plan["nsb"])
             for tile in range(FWD_SB // WG_ROWS)]
    cases += [("h2", i, tile, "h1", "w3") for i in range(plan["n"]) for tile in range(tiles)]
    cases += [("h3", i, tile, f"h2_{i % 2}", "w4") for i in range(2) for tile in range(tiles)]
    for conv, index, tile, a_region, b_region in cases:
        steps = fwd_bf16_conv_descs(plan, conv, index, tile)
        assert len(steps) == plan["k"] * (plan["cp"] if conv == "h1" else plan["o"]) // 16
        for a, b in steps:
            _check_operand(plan, a, WG_ROWS, a_region)
            _check_operand(plan, b, plan["o"], b_region)
        if conv == "h2":
            assert steps[0][0][0] == plan["h1"] + 16 * (index * plan["rs"] + WG_ROWS * tile)


@pytest.mark.parametrize("c", [64, 10, 16])
def test_ldmatrix_transpose_gives_the_time_major_window(c):
    """The kernel's raw_to_xs, lane by lane (ldmatrix .x4 .trans and the
    warp's stores): the chunks read back as the raw sub-block transposed,
    the channels past C zero."""
    plan = fwd_bf16_plan(c, 250, 125, 5)
    raw = torch.tensor(np.random.default_rng(c).normal(size=(c, plan["xr"])).astype(np.float32))
    got = ldmatrix_transpose(raw, plan)
    want = torch.zeros((plan["xr"], plan["cp"]))
    want[:, :c] = raw.T
    assert torch.equal(got, want)


def test_gelu_fit_is_within_its_bound():
    """The kernel's branch-free GELU, in f32, against the exact GELU in f64:
    |error| <= 7.5e-7 on [-7, 7] and on [-100, 100], below torch's own f32
    GELU's error (1.1e-6)."""
    for lim in (7, 100):
        v = torch.linspace(-lim, lim, 140001)
        exact = 0.5 * v.double() * (1 + torch.erf(v.double() / np.sqrt(2)))
        err = float((gelu_fit(v).double() - exact).abs().max())
        torch_err = float((torch.nn.functional.gelu(v).double() - exact).abs().max())
        assert err <= 7.5e-7 < torch_err, (lim, err, torch_err)


def test_kernel_source_holds_the_mirrors_constants():
    """csrc/conv4head_fwd_bf16.cu's GELU coefficients and clamp, and its
    phase enum, are the Python mirror's."""
    src = open(os.path.join(os.path.dirname(conv4head.__file__), "..", "..", "csrc",
                            "conv4head_fwd_bf16.cu")).read()
    table = re.search(r"kGeluP\[\d+\] = \{([^}]*)\}", src).group(1)
    assert [float(v.rstrip("f")) for v in table.replace("\n", " ").split(",")] == list(
        np.float32(GELU_EXP2_POLY))
    clamp = re.search(r"kGeluClamp = ([0-9.]+)f", src).group(1)
    assert np.float32(clamp) == np.float32(GELU_CLAMP)
    enum = re.search(r"enum FwdPhase \{(.*?)\};", src, re.S).group(1)
    assert len(re.findall(r"^\s*kFw\w+,", enum, re.M)) == len(FWD_BF16_PHASES)


@pytest.mark.parametrize("case", range(3))
def test_selftest_cases_match_their_logical_products(case):
    """The card's one-tile self-tests of B2f-bf16's descriptors, emulated:
    the gathers give the product written from the logical matrices."""
    img, cases = fwd_selftest_cases(fwd_bf16_plan(64, 250, 125, 5))
    name, steps, a_mn, b_mn, expected = cases[case]
    got = wgmma(img, steps, a_mn, b_mn)[0].double()
    assert float((got - expected).abs().max()) <= 1e-5 * float(expected.abs().max()), name


@pytest.mark.parametrize("geo,m,b", [(OVERLAP, 2, 3), (APART, 1, 2), (DEEP, 1, 2), (ODD, 1, 2),
                                     (FULL, 1, 1), (LONG, 1, 1)],
                         ids=["overlap", "apart", "deep", "odd", "full", "long"])
def test_emulation_matches_plain_bf16_forward(geo, m, b):
    """The emulated kernel (trials in order on one image per (model, zone),
    stale bytes and all) against ``fused_conv4_head_plain`` on a bf16 x:
    the same rounding points, f32 sums in another order, and the fitted
    GELU, so within the card tests' 3e-4 x max|ref|."""
    ops = operands(m, b, **geo, seed=geo["c"] + geo["w"] + b)
    got = emulate_fwd_bf16(*ops, geo["w"], geo["step"])
    ref = fused_conv4_head_plain(*ops, geo["w"], geo["step"])
    assert got.shape == ref.shape
    assert rel_max(got, ref) <= BF16_FWD_REL, rel_max(got, ref)


def test_windows_read_their_own_pads():
    """With h1 stored once over the sequence (a window's rows at stride
    ``step``: rs = step), conv2 reads the neighbouring windows' columns at
    each window's edges instead of its zero pads, and the emulation misses
    the plain forward by far more than the tolerance; with the plan's
    stacked rows it meets it."""
    geo = OVERLAP
    ops = operands(1, 2, **geo, seed=3)
    ref = fused_conv4_head_plain(*ops, geo["w"], geo["step"])
    assert rel_max(emulate_fwd_bf16(*ops, geo["w"], geo["step"]), ref) <= BF16_FWD_REL
    wrong = emulate_fwd_bf16(*ops, geo["w"], geo["step"], rs=geo["step"])
    assert rel_max(wrong, ref) > 10 * BF16_FWD_REL


@pytest.mark.parametrize("geo", [OVERLAP, APART], ids=["overlap", "apart"])
def test_emulation_matches_pallas_head_in_bf16(geo):
    """The emulated kernel against the JAX package's Pallas head on a bf16
    x (interpret mode, as its own tests run it), model by model: 3e-4 x
    max|ref|, under a fifth of the Pallas head's own bf16-vs-f32 gap."""
    ops = operands(2, 2, **geo, seed=11)
    got = emulate_fwd_bf16(*ops, geo["w"], geo["step"])
    x, w12, b12, w3, w4 = ops
    for i in range(2):
        jw = [jnp.asarray(t[i].numpy()) for t in (w12, b12, w3, w4)]
        with pltpu.force_tpu_interpret_mode():
            ref = {dt: np.asarray(pallas_head(jnp.asarray(x[i].float().numpy(), dt), *jw,
                                              geo["w"], geo["step"]), np.float32)
                   for dt in (jnp.bfloat16, jnp.float32)}
        err = rel_max(got[i].numpy().reshape(ref[jnp.bfloat16].shape), ref[jnp.bfloat16])
        gap = rel_max(ref[jnp.float32], ref[jnp.bfloat16])
        assert err <= BF16_FWD_REL < gap / 5, (err, gap)


def test_sub_blocks_cover_the_used_columns():
    """h1 runs in sub-blocks of FWD_SB = 256 columns, a 64-row tile a
    warpgroup; the x sub-block's rows reach every sample its tiles read,
    and the used samples end inside the trial."""
    for geo in (FULL, OVERLAP, APART, DEEP, ODD):
        plan = fwd_bf16_plan(geo["c"], geo["w"], geo["step"], n_windows(geo))
        assert plan["nsb"] * FWD_SB >= plan["lh"] > (plan["nsb"] - 1) * FWD_SB
        assert plan["xr"] >= FWD_SB + plan["k"] - 1 and plan["xr"] % 8 == 0
        assert plan["lx"] == plan["lh"] + plan["k"] - 1 <= geo["t"]
