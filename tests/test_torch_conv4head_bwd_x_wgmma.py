"""B2x-bf16's wgmma route, emulated on the CPU, against the plain bf16
backward and the JAX package.

Kernel B2x-bf16 (``csrc/conv4head_bwd_x_bf16.cu``) recomputes B2w-bf16's
phases h1 -> dh1 on wgmma m64n32k16 with both operands in shared memory
(the time-major buffers in chunks of 8 channels), stores bf16(dh1) from
row K - 1 between zero rows, and runs one GEMM more, the input gradient
D[w, c] = sum_{k, o} bf16(dh1)[w - k, o] w12[o, k*C + c], whose dx tiles
stay in f32 registers across a block's zones; the zones' weights
alternate between two staged sets. ``ops/cuda/conv4head.py`` mirrors its
plan (``bwd_x_bf16_plan``) and descriptors (``bwd_x_bf16_dx_descs``; the
convs are B2w-bf16's, ``bwd_w_bf16_conv_descs`` on the zone's weight set);
``tests/wgmma_emulation.py`` gathers every operand tile through them
from a flat image of shared memory and multiplies it in f32, k16 step by
k16 step, in the kernel's order. This file holds that the plan fits, that
every descriptor is legal and stays inside its operand, and that the
emulated kernel, with one zone range and several, equals the plain bf16
backward's dx (``conv4head_bwd_bf16_plain``) and ``jax.grad`` with
respect to a bf16 x of the JAX package's Pallas head (interpret mode),
within ``tests/test_torch_bf16.py``'s dx tolerance (1e-3 in relative L2),
under the bf16-vs-f32 gap. On the card, ``tests/test_torch_cuda.py``
holds the kernel against the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from imagined_speech_decoding_tpu.ops.pallas.conv4head import fused_conv4_head as pallas_head
from imagined_speech_decoding_tpu_torch.ops.cuda.conv4head import (
    BWD_X_BF16_PHASES,
    BWD_X_BF16_SLOTS,
    MAX_SMEM_BYTES,
    WG_GROUPS,
    WG_ROWS,
    _check_smem,
    bwd_w_bf16_conv_descs,
    bwd_x_bf16_dx_descs,
    bwd_x_bf16_dx_tiles,
    bwd_x_bf16_plan,
    bwd_x_bf16_smem_bytes,
    bwd_x_bf16_weights,
    conv4head_bwd_bf16_plain,
)
from wgmma_emulation import _slots, emulate_bwd_x_bf16

torch.set_num_threads(1)

DX_L2 = 1e-3  # tests/test_torch_bf16.py: a bf16 dx against the Pallas VJP's, relative L2
FULL = dict(c=64, z=8, t=800, w=250, step=125)  # FASTConfig.default()'s head
RAGGED = dict(c=33, z=3, t=231, w=117, step=37)  # t1 = 113: not a multiple of 8 or 16
WIDEST = dict(c=64, z=2, t=300, w=260, step=40)  # t1 = 256, 5 dx row tiles: 3 slots a warpgroup


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


def rel_l2(a, ref) -> float:
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(a - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("c,w", [(64, 250), (10, 250), (33, 117), (64, 260), (1, 5)])
def test_plan_fits_shared_memory(c, w):
    """The plan at full width (198,912 bytes: the window, h1, h2, dh3c,
    dh2c and dh1 in chunks, two sets of a zone's weights) fits one block's
    227 KB, and its dx tiles (8 of 64 rows x 32 channels at W <= 256, 10 at
    W <= 260) fit the registers, BWD_X_BF16_SLOTS a warpgroup."""
    plan = bwd_x_bf16_plan(c, w)
    assert plan["total"] == bwd_x_bf16_smem_bytes(c, w) <= MAX_SMEM_BYTES
    assert len(bwd_x_bf16_dx_tiles(plan)) <= BWD_X_BF16_SLOTS * WG_GROUPS
    assert plan["rx"] >= plan["rows"] and plan["nx"] * WG_ROWS >= w
    if (c, w) == (64, 250):
        assert plan["total"] == 198912 and plan["nt"] == 4 * WG_ROWS and plan["rows"] == 260
        assert len(bwd_x_bf16_dx_tiles(plan)) == 8
    if w == 260:
        assert plan["t1"] == 256 and len(bwd_x_bf16_dx_tiles(plan)) == 10


def test_admitted_geometries():
    """Every C up to 64 at every window up to 260 samples fits the shared
    memory and the dx slots; the plan is one layout for every C. Past
    windows of 260 (t1 > 256: a window in more than one tile) the column
    tiles' plan takes them (``tests/test_torch_conv4head_bwd_x_wgmma_col_tiles.py``);
    past C = 64 the library's size is -1, which the wrapper's check
    refuses."""
    for c in range(1, 65):
        for w in range(5, 261):
            nbytes = bwd_x_bf16_smem_bytes(c, w)
            assert 0 < nbytes <= MAX_SMEM_BYTES, (c, w)
            assert len(bwd_x_bf16_dx_tiles(bwd_x_bf16_plan(c, w))) <= BWD_X_BF16_SLOTS * WG_GROUPS
    assert bwd_x_bf16_smem_bytes(10, 250) == bwd_x_bf16_smem_bytes(64, 250)
    # the debug instantiation's phase counters (phase_clock.cuh) fit beside the widest plan
    assert bwd_x_bf16_smem_bytes(64, 260) + 16 * 8 * len(BWD_X_BF16_PHASES) <= MAX_SMEM_BYTES
    for c, w in ((65, 250), (65, 800), (128, 250), (64, 4)):
        assert bwd_x_bf16_smem_bytes(c, w) == -1, (c, w)
    for c, w in ((64, 261), (1, 800)):
        assert 0 < bwd_x_bf16_smem_bytes(c, w) <= MAX_SMEM_BYTES, (c, w)
    with pytest.raises(ValueError, match="B2x-bf16 is not built"):
        _check_smem(bwd_x_bf16_smem_bytes(65, 250), "B2x-bf16")


def _regions(plan):
    names = ("xs", "h1", "h2", "d3", "d2", "d1", "w12")
    regions = {a: (plan[a], plan[b]) for a, b in zip(names, names[1:])}
    for buf in (0, 1):
        wp = bwd_x_bf16_weights(plan, buf)
        for a, b in (("w12", "w3"), ("w3", "w4"), ("w4", "bias")):
            regions[f"{a}/{buf}"] = (wp[a], wp[b])
    assert bwd_x_bf16_weights(plan, 1)["gz"] + 4 * plan["o"] == plan["total"]
    return regions


def _check_operand(plan, desc, n_mn, mn_major, region):
    start, k_step, mn_step = desc
    assert start % 16 == 0 and k_step % 16 == 0 and mn_step % 16 == 0
    assert 0 < k_step < 16 << 14 and 0 < mn_step < 16 << 14 and start < 16 << 14
    slots = _slots(start, k_step, mn_step, n_mn, mn_major)
    lo, hi = _regions(plan)[region]
    assert lo <= 2 * int(slots.min()) and 2 * int(slots.max()) + 2 <= hi, (desc, region)


@pytest.mark.parametrize("geo", [FULL, RAGGED, WIDEST, dict(c=1, w=5), dict(c=64, w=800)],
                         ids=["full", "ragged", "widest", "w5", "tiled"])
def test_descriptors_are_aligned_and_stay_in_their_operands(geo):
    """Every k16 step of every conv tile and dx tile, on both weight sets:
    starts and steps in whole 16-byte units (each tap's shift included),
    inside the descriptor's 14-bit fields, and every byte it reads inside
    the operand's own buffer: the dx tiles' A inside dh1's zero-padded
    rows, their B inside the set's w12. In column tiles (windows of 800)
    the plan is that of windows of 260, whose descriptors every tile
    reads."""
    plan = bwd_x_bf16_plan(geo["c"], geo["w"])
    weights = {"xs": "w12", "h1": "w3", "h2": "w4", "d3": "w4", "d2": "w3"}
    for buf in (0, 1):
        wp = bwd_x_bf16_weights(plan, buf)
        for src, transposed in (("xs", False), ("h1", False), ("h2", False), ("d3", True),
                                ("d2", True)):
            for tile in range(plan["nt"] // WG_ROWS):
                steps = bwd_w_bf16_conv_descs(wp, src, tile, transposed)
                assert len(steps) == plan["k"] * (plan["cp"] if src == "xs" else plan["o"]) // 16
                for a, b in steps:
                    _check_operand(plan, a, WG_ROWS, False, src)
                    _check_operand(plan, b, plan["o"], transposed, f"{weights[src]}/{buf}")
        for tile in bwd_x_bf16_dx_tiles(plan):
            steps = bwd_x_bf16_dx_descs(plan, tile, buf)
            assert len(steps) == plan["k"] * plan["o"] // 16
            for a, b in steps:
                _check_operand(plan, a, WG_ROWS, False, "d1")
                _check_operand(plan, b, 32, True, f"w12/{buf}")


def test_dx_descriptors_read_the_logical_product():
    """One dx tile gathered through the mirror's descriptors from an image
    of random bf16 values equals the product written from the logical
    matrices, sum_k dh1[w - k] @ w12[:, k*Cp + 32 h : ... + 32] (rows of dh1
    before 0 and past its last row zero): the same operands the card's
    wgmma reads."""
    from wgmma_emulation import wgmma, write
    from imagined_speech_decoding_tpu_torch.ops.cuda.conv4head import _bf16

    plan = bwd_x_bf16_plan(64, 250)
    rng = np.random.default_rng(0)
    o, k, cp = plan["o"], plan["k"], plan["cp"]
    dh1 = _bf16(torch.tensor(rng.normal(size=(plan["nt"], o)).astype(np.float32)))
    w12 = _bf16(torch.tensor(rng.normal(size=(o, k * cp)).astype(np.float32)))
    img = torch.zeros((1, plan["total"] // 2))
    write(img, plan["d1"], plan["csx"], dh1[None], row0=k - 1)
    write(img, bwd_x_bf16_weights(plan, 1)["w12"], 16 * o, w12[None])
    padded = torch.cat([torch.zeros((k - 1, o)), dh1, torch.zeros((WG_ROWS, o))]).double()
    for mt, h in ((0, 0), (3, 1)):
        got = wgmma(img, bwd_x_bf16_dx_descs(plan, (mt, h), 1), False, True)[0].double()
        rows = torch.arange(WG_ROWS) + WG_ROWS * mt
        want = sum(padded[rows + k - 1 - tap] @ w12.double()[:, tap * cp + 32 * h:][:, :32]
                   for tap in range(k))
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("geo,m,b,sz", [(FULL, 1, 2, 1), (FULL, 1, 2, 3), (RAGGED, 2, 3, 1),
                                        (RAGGED, 2, 3, 2), (WIDEST, 1, 1, 1)],
                         ids=["full", "full-sz3", "ragged", "ragged-sz2", "widest"])
def test_emulation_matches_plain_bf16_backward(geo, m, b, sz):
    """The emulated kernel (``sz`` zone ranges a (trial, window), dx tiles
    carried in f32 across each range's zones, partials summed in order)
    against ``conv4head_bwd_bf16_plain``'s dx: the same rounding points, f32
    sums in another order, so a few elements one bf16 ulp apart, within
    1e-3 in relative L2."""
    ops = operands(m, b, **geo, seed=geo["c"] + b + sz)
    got = emulate_bwd_x_bf16(*ops, geo["w"], geo["step"], sz=sz)
    ref = conv4head_bwd_bf16_plain(*ops, geo["w"], geo["step"])[0]
    assert got.dtype == ref.dtype == torch.bfloat16 and got.shape == ref.shape
    err = rel_l2(got.float(), ref.float())
    assert err <= DX_L2, err


@pytest.mark.parametrize("geo,b,sz", [(FULL, 1, 1), (FULL, 1, 4), (RAGGED, 2, 1), (RAGGED, 2, 3)],
                         ids=["full", "full-sz4", "ragged", "ragged-sz3"])
def test_emulation_matches_pallas_vjp_in_bf16(geo, b, sz):
    """The emulated kernel against ``jax.grad`` with respect to a bf16 x
    through the JAX package's Pallas head (interpret mode) in bf16, within
    1e-3 in relative L2, under the same dx's bf16-vs-f32 gap (the Pallas
    VJP's in f32 against its bf16 one)."""
    g, x, w12, b12, w3, w4 = operands(1, b, **geo, seed=11 + sz)
    got = emulate_bwd_x_bf16(g, x, w12, b12, w3, w4, geo["w"], geo["step"], sz=sz)
    jw = [jnp.asarray(t[0].numpy()) for t in (w12, b12, w3, w4)]
    gj = jnp.asarray(g[0].numpy())

    def grad(dt):
        xx = jnp.asarray(x[0].float().numpy(), dt)

        def loss(xv):
            return jnp.sum(pallas_head(xv, *jw, geo["w"], geo["step"]) * gj)

        with pltpu.force_tpu_interpret_mode():
            dx = jax.grad(loss)(xx)
        assert dx.dtype == dt
        return np.asarray(dx, np.float32)

    ref16, ref32 = grad(jnp.bfloat16), grad(jnp.float32)
    err, gap = rel_l2(got[0].float().numpy(), ref16), rel_l2(ref32, ref16)
    assert err <= DX_L2 < gap, (err, gap)
