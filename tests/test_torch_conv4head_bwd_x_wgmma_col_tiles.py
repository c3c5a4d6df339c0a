"""B2x-bf16's wgmma route in column tiles, emulated on the CPU, against the
plain bf16 backward and the JAX package.

Kernel B2x-bf16 (``csrc/conv4head_bwd_x_bf16.cu``) holds at most 256 conv
rows a block, so a window past 260 samples runs in the column tiles of
B2w-bf16 (``ops.cuda.conv4head.col_tiles`` in 64-row tiles): tile j stages
the window's columns from s = 240 j on the plan of windows of 260 samples,
recomputes h1 .. dh1 over its rows (zero from the window's end on; g / t1
is the whole window's), keeps in bf16(dh1) only the rows it owns, [8, 248)
at an interior edge, and its dx GEMM reaches the tile's columns [lo, hi +
K - 1). Tiles run outside the zones: a block walks (tile, zone) units, the
tile's dx in f32 registers across its zones; after the tile's last zone
the tile is stored, its columns from lo + K - 1 written and the K - 1 seam
columns before them added onto what the tile before stored there. A short
last tile first zeroes the rows past its own that its convs and dx tiles
read. The Python mirror (``bwd_x_bf16_plan``, ``bwd_x_bf16_col_tiles``,
``bwd_x_bf16_dx_descs``; the convs ``bwd_w_bf16_conv_descs``) drives the
byte-level emulation of ``tests/wgmma_emulation.py`` through NaN-filled
shared memory and dxw (a byte read before it is written shows).

This file holds the emulation against ``conv4head_bwd_bf16_plain`` and
against ``jax.grad`` with respect to a bf16 x of the JAX package's Pallas
head (interpret mode), within ``SHARE`` of ``BF16_DX_L2`` (2e-3 relative
L2: the card's bound for every bf16 input gradient) and, against JAX, under
the bf16-vs-f32 gap; shows that an unmasked dh1, a seam written instead
of added, g divided by one tile's t1 and a short tile's stale rows each
miss by far more; and holds the mirror: every window column written by one
tile and reached by two at a seam, one plan for every tiled window.
On the card, ``tests/test_torch_cuda.py`` holds the kernel against the
plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from imagined_speech_decoding_tpu.ops.pallas.conv4head import fused_conv4_head as pallas_head
from imagined_speech_decoding_tpu_torch.ops.cuda.conv4head import (
    BWD_X_BF16_MAX_T1,
    BWD_X_BF16_PHASES,
    BWD_X_BF16_SLOTS,
    COL_HALO,
    COL_STEP,
    MAX_SMEM_BYTES,
    WG_GROUPS,
    WG_ROWS,
    bwd_w_bf16_col_tiles,
    bwd_w_bf16_plan,
    bwd_x_bf16_col_tiles,
    bwd_x_bf16_dx_tiles,
    bwd_x_bf16_plan,
    bwd_x_bf16_smem_bytes,
    conv4head_bwd_bf16_plain,
)
from wgmma_emulation import emulate_bwd_x_bf16

torch.set_num_threads(1)

BF16_DX_L2 = 2e-3  # tests/test_torch_cuda.py and chip_smoke.py: a bf16 dx, relative L2
# The emulation's bound, as a share of BF16_DX_L2. Both dx round h1, h2, the
# cotangents, bf16(dh1) and dx at the same points and sum in f32 in other
# orders, so they part by one-bf16-ulp flips: 2^-8 x sqrt(the share of
# elements flipped) in relative L2. At 8 zones in 8 ranges, where two windows
# overlap, up to 9% of the elements flip (1.1e-3); the whole window of 250
# samples at 8 zones shows 7.4e-4, and no tile's seam stands out.
SHARE = 0.75
K = 5
# (T, step) of each window: two windows of 285 and of 500 that overlap, one of 800
WINDOWS = {285: (400, 115), 500: (650, 150), 800: (800, 1)}


def operands(m, b, c, z, t, w, step, seed, o=32, k=K):
    """``(g, x bf16, w12, b12, w3, w4)`` with the model axis, from numpy, at
    the scales of a trained head."""
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


def share_of_plain(ops, w, step, **mutation) -> float:
    """The emulation's relative L2 from the plain bf16 backward's dx, as a
    share of BF16_DX_L2; the dx must be finite and of x's shape."""
    got = emulate_bwd_x_bf16(*ops, w, step, **mutation)
    ref = conv4head_bwd_bf16_plain(*ops, w, step)[0]
    assert got.dtype == ref.dtype == torch.bfloat16 and got.shape == ref.shape
    assert bool(torch.isfinite(got.float()).all())
    return rel_l2(got.float(), ref.float()) / BF16_DX_L2


@pytest.mark.parametrize("sz", [1, 2, 8])
@pytest.mark.parametrize("c", [13, 64])
@pytest.mark.parametrize("w", sorted(WINDOWS))
def test_column_tiles_match_plain_bf16_backward(w, c, sz):
    """Windows of 285 (two tiles, the last owning 33 rows), 500 (two) and
    800 (four, the last short: 128 rows computed), C = 13 and 64 (the
    window and w12 zero-padded to 64 channels), 8 zones in SZ = 1, 2 and 8
    ranges (each block's partial over all its tiles, summed in order):
    within SHARE of BF16_DX_L2 of the plain bf16 backward's dx."""
    t, step = WINDOWS[w]
    ops = operands(1, 1, c, 8, t, w, step, seed=w + c + sz)
    assert len(bwd_x_bf16_col_tiles(bwd_x_bf16_plan(c, w))) == {285: 2, 500: 2, 800: 4}[w]
    share = share_of_plain(ops, w, step, sz=sz)
    assert share <= SHARE, share


@pytest.mark.parametrize("c,w,step,t", [
    (64, 261, 13, 300), (64, 308, 2, 310), (33, 533, 1, 534), (8, 1000, 1, 1000),
], ids=["w261", "w308", "w533", "w1000"])
def test_column_tiles_at_their_edges_match_plain(c, w, step, t):
    """The first tiled window (261: t1 = 257, a last tile of one row), a
    last tile that reads its rows past its own (308: e = 64, so its convs
    and its second dx row tile reach rows the tile before wrote), three
    tiles (533) and five (1000), M = 2, B = 2, 3 zones in one range."""
    ops = operands(2, 2, c, 3, t, w, step, seed=c + w)
    share = share_of_plain(ops, w, step)
    assert share <= SHARE, share


@pytest.mark.parametrize("c,w,step,t,sz", [(13, 500, 150, 650, 1), (64, 500, 150, 650, 2),
                                           (13, 800, 1, 800, 1)],
                         ids=["w500-c13", "w500-c64-sz2", "w800"])
def test_column_tiles_match_pallas_vjp_in_bf16(c, w, step, t, sz):
    """The emulated tiles against ``jax.grad`` with respect to a bf16 x
    through the JAX package's Pallas head (interpret mode) in bf16, two
    zones: within SHARE of BF16_DX_L2 in relative L2, and under the same
    dx's bf16-vs-f32 gap (the Pallas VJP's in f32 against its bf16 one)."""
    g, x, w12, b12, w3, w4 = operands(1, 1, c, 2, t, w, step, seed=7 + w + c)
    got = emulate_bwd_x_bf16(g, x, w12, b12, w3, w4, w, step, sz=sz)
    jw = [jnp.asarray(a[0].numpy()) for a in (w12, b12, w3, w4)]
    gj = jnp.asarray(g[0].numpy())

    def grad(dt):
        xx = jnp.asarray(x[0].float().numpy(), dt)

        def loss(xv):
            return jnp.sum(pallas_head(xv, *jw, w, step) * gj)

        with pltpu.force_tpu_interpret_mode():
            dx = jax.grad(loss)(xx)
        assert dx.dtype == dt
        return np.asarray(dx, np.float32)

    ref16, ref32 = grad(jnp.bfloat16), grad(jnp.float32)
    err, gap = rel_l2(got[0].float().numpy(), ref16), rel_l2(ref32, ref16)
    assert err <= SHARE * BF16_DX_L2 < gap, (err, gap)


@pytest.mark.parametrize("w,step,t,mutation", [
    (800, 1, 800, dict(owned=False)), (800, 1, 800, dict(seam_adds=False)),
    (800, 1, 800, dict(whole_t1=False)), (308, 2, 310, dict(zero_short=False)),
], ids=["unmasked-dh1", "seam-written", "tile-t1", "stale-rows"])
def test_each_rule_of_the_tiles_is_needed(w, step, t, mutation):
    """The same emulation with one rule broken misses by far more than the
    tolerance (at least 10 x BF16_DX_L2): dh1 keeping its halo rows (each
    counted by two tiles), the first K - 1 columns of a tile written over
    what the tile before stored, g divided by one tile's t1 (256) instead
    of the window's, and a short last tile reading the rows past its own
    as the tile before left them."""
    ops = operands(1, 1, 64, 2, t, w, step, seed=w + len(str(mutation)))
    assert share_of_plain(ops, w, step) <= SHARE
    share = share_of_plain(ops, w, step, **mutation)
    assert share > 10.0, (mutation, share)


@pytest.mark.parametrize("c", [1, 13, 64])
def test_every_column_is_written_once_and_the_seams_reached_twice(c):
    """At windows from 250 to 1000 samples: one tile up to t1 = 256, else
    ceil((t1 - 16) / 240), whose kept rows cover [0, t1) once, whose dx
    columns [wf, w1) (written) cover the window once, and whose reach [lo,
    w1) covers each column once, or twice at a seam, the K - 1 columns
    from 240 j + 8 for j > 0 (added); every tile's reach lies inside its
    nx dx row tiles, which fit the registers."""
    for w in list(range(250, 320)) + [400, 500, 533, 600, 800, 1000]:
        plan = bwd_x_bf16_plan(c, w)
        t1 = w - K + 1
        tiles = bwd_x_bf16_col_tiles(plan)
        assert len(tiles) == (1 if t1 <= BWD_X_BF16_MAX_T1
                              else -(-(t1 - 2 * COL_HALO) // COL_STEP))
        kept = [tl["s"] + r for tl in tiles for r in range(tl["lo"], tl["hi"])]
        assert kept == list(range(t1))
        reached = np.zeros(w, dtype=int)
        written = np.zeros(w, dtype=int)
        seam = np.zeros(w, dtype=int)
        for j, tl in enumerate(tiles):
            reached[tl["s"] + tl["lo"]:tl["s"] + tl["w1"]] += 1
            written[tl["s"] + tl["wf"]:tl["s"] + tl["w1"]] += 1
            if j:
                assert tl["wf"] - tl["lo"] == K - 1
                seam[COL_STEP * j + COL_HALO:COL_STEP * j + COL_HALO + K - 1] = 1
            assert tl["w1"] <= WG_ROWS * tl["nx"] and tl["nx"] <= plan["nx"]
            assert tl["nt"] <= plan["nt"] and tl["cols"] <= plan["rows"]
        assert (written == 1).all() and (reached == 1 + seam).all(), w
        assert len(bwd_x_bf16_dx_tiles(plan)) <= BWD_X_BF16_SLOTS * WG_GROUPS


def test_tiled_windows_share_one_plan():
    """Every window past 260 samples at every C <= 64 takes one plan, the
    plan of windows of 260 (203,008 bytes with the debug counters' slots
    still inside the card's 227 KB; 5 dx row tiles, 10 dx tiles), whose
    tiles are B2w-bf16's; the whole-window plans are as they were (198,912
    bytes at the shipped geometry); C > 64 has none (-1)."""
    wide = bwd_x_bf16_plan(64, 260)
    layout = {key: v for key, v in wide.items() if key not in ("c", "w", "t1", "tiles")}
    assert wide["total"] == 203008 and wide["nx"] == 5 and wide["tiles"] == 1
    for c in (1, 13, 33, 64):
        for w in (261, 285, 300, 500, 533, 800, 1000, 2000):
            plan = bwd_x_bf16_plan(c, w)
            assert {key: v for key, v in plan.items() if key in layout} == layout, (c, w)
            assert bwd_x_bf16_smem_bytes(c, w) == 203008 and plan["tiles"] >= 2
            keys = ("s", "nt", "e", "lo", "hi", "cols", "left", "right")
            assert ([{key: tl[key] for key in keys} for tl in bwd_x_bf16_col_tiles(plan)]
                    == [{key: tl[key] for key in keys}
                        for tl in bwd_w_bf16_col_tiles(bwd_w_bf16_plan(c, w))])
    assert 203008 + 16 * 8 * len(BWD_X_BF16_PHASES) <= MAX_SMEM_BYTES
    assert bwd_x_bf16_smem_bytes(64, 250) == 198912
    assert bwd_x_bf16_smem_bytes(65, 800) == bwd_x_bf16_smem_bytes(128, 250) == -1
