"""B2f's tensor-core route in column tiles, emulated on the CPU, against the
JAX package.

Kernel B2f (``conv4head_fwd_kernel`` in ``csrc/conv4head.cu``) holds a
block's window and activations in shared memory. Where that plan does not
fit a block (C = 64 past windows of 284 samples, C = 72 past 260, C = 8
past 636) a (trial, window, zone) runs its window in column tiles of at
most 256 conv rows (``ops.cuda.conv4head.col_tiles``, B2w's geometry):
tile j stages the window's columns from s = 240 j, computes h1, h2 and
gelu(h3) over its rows (zero from the window's end on), and adds to the
time-mean only the rows it owns, [8, 248) at an interior edge: the two
'same' convs reach two rows each, so gelu(h3) is exact 4 rows inside an
edge. The mean's sums are the only state across tiles; each output is
written once, after a trial's last tile, as sum / t1. Each product is
3xTF32 (``tests/tf32_emulation.py``).

This file emulates exactly that in f32 on the CPU, through the Python
mirror of the kernel's plan (``fwd_col_tiles``, ``fwd_smem_bytes``), and
holds it against the JAX package's ``fused_conv4_head`` (its Pallas
kernel in interpret mode) at windows of 500 (two tiles) and 800 (four) at
``chip_smoke.py``'s tolerance for B2f, rtol 1e-4 / atol 1e-5, and against
the port's plain forward at the tiles' edges; and shows that tiles summing
every row they compute, halos included, miss it.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from imagined_speech_decoding_tpu.ops.pallas.conv4head import fused_conv4_head as pallas_head
from imagined_speech_decoding_tpu_torch.ops.cuda.conv4head import (
    COL_HALO,
    COL_SPAN,
    COL_STEP,
    MAX_SMEM_BYTES,
    bwd_w_col_tiles,
    fused_conv4_head_plain,
    fwd_col_tiles,
    fwd_plan_bytes,
    fwd_smem_bytes,
)
from tf32_emulation import im2col, mma

torch.set_num_threads(1)

HEAD_RTOL, HEAD_ATOL = 1e-4, 1e-5  # chip_smoke.py's B2f tolerance
O, K = 32, 5
GEOMETRIES = {  # C not a multiple of 8 (B2f pads it to 24 and 16 inside the block)
    "w500": dict(c=20, z=2, t=650, window=500, step=150),  # 2 windows, 2 tiles each
    "w800": dict(c=13, z=2, t=800, window=800, step=1),  # 1 window, 4 tiles
}


def tile_rows(xs, w12p, b12, w3, w4, tile, passes=3):
    """gelu(h3) of one column tile of every (trial, window) in ``xs (B, N,
    1, Cp, nt + K - 1)`` (the tile's window columns from column 0, zeros
    after): (B, N, Z, O, nt), zero from the window's end on."""
    nt, e = tile["nt"], tile["e"]
    live = torch.arange(nt) < e  # the epilogues' zeros past the window's end
    taps = range(K)

    def same(h):  # an activation (O, nt) stored from column K/2 between zeros
        return torch.nn.functional.pad(h, (K // 2, K // 2))

    h1 = torch.where(live, mma(w12p, im2col(xs, nt, taps), passes) + b12.view(-1, O, 1), 0.0)
    h2 = torch.where(live, mma(w3, im2col(same(h1), nt, taps), passes), 0.0)
    h3 = mma(w4, im2col(same(h2), nt, taps), passes)
    return torch.where(live, torch.nn.functional.gelu(h3), 0.0)


def b2f_emulated(x, w12, b12, w3, w4, window, step, splits=1, owned=True, passes=3):
    """The features (B, N, Z*O) of one model on B2f's route: x (B, C, T),
    weights without the model axis; ``splits`` trial ranges a (zone,
    window), each block walking its (trial, tile) units in order.
    ``owned``: each tile adds the rows it owns to the mean; else every row
    it computes."""
    b, c, t = x.shape
    z = w3.shape[0]
    n = (t - window) // step + 1
    t1 = window - K + 1
    cp = -(-c // 8) * 8  # zero rows in the staged window, zero columns in w12
    xp = torch.nn.functional.pad(x, (0, 0, 0, cp - c))
    w12p = torch.nn.functional.pad(w12.view(z, O, K, c), (0, cp - c)).view(z, O, K * cp)
    rows = []  # per tile: (B, N, Z, O) sums over the rows it adds to the mean
    for tile in fwd_col_tiles(c, window):
        s, cols = tile["s"], tile["cols"]
        xs = torch.zeros((b, n, 1, cp, tile["nt"] + K - 1))
        for i in range(n):
            xs[:, i, 0, :, :cols] = xp[..., i * step + s:i * step + s + cols]
        g3 = tile_rows(xs, w12p, b12, w3, w4, tile, passes)
        r0, r1 = (tile["lo"], tile["hi"]) if owned else (0, tile["nt"])
        rows.append(g3[..., r0:r1].sum(-1))
    out = torch.empty((b, n, z, O))
    for i in range(n):
        for r in range(splits):
            for bi in range(r * b // splits, (r + 1) * b // splits):
                acc = torch.zeros((z, O))  # the block's running sums over the trial's tiles
                for tile_sum in rows:
                    acc = acc + tile_sum[bi, i]
                out[bi, i] = acc / t1  # written once, after the trial's last tile
    return out.reshape(b, n, z * O)


def _operands(geo, batch: int, seed: int):
    """x (B, C, T) and one model's head operands at the scales of a trained
    head (unit-variance activations)."""
    rng = np.random.default_rng(seed)
    f32 = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    c, z, t = geo["c"], geo["z"], geo["t"]
    return (f32(batch, c, t), f32(z * O, K * c) / math.sqrt(K * c), 0.1 * f32(z * O, 1),
            f32(z, O, K * O) / math.sqrt(K * O), f32(z, O, K * O) / math.sqrt(K * O))


@pytest.fixture(scope="module", params=sorted(GEOMETRIES))
def case(request):
    """Operands (B = 2) and JAX's features, through the Pallas head in
    interpret mode."""
    geo = GEOMETRIES[request.param]
    ops = _operands(geo, 2, 21 if request.param == "w500" else 22)
    with pltpu.force_tpu_interpret_mode():
        ref = pallas_head(*(jnp.asarray(a) for a in ops), geo["window"], geo["step"])
    return geo, [torch.from_numpy(a) for a in ops], np.asarray(ref)


def tolerance_share(got, ref) -> float:
    """The worst element's error over its tolerance (<= 1 passes)."""
    return float(np.max(np.abs(got - ref) / (HEAD_ATOL + HEAD_RTOL * np.abs(ref))))


@pytest.mark.parametrize("splits", [1, 2])
def test_column_tiles_match_jax(case, splits):
    """B2f's column tiles (two at windows of 500, four at 800), with one and
    two trial ranges a (zone, window), against the Pallas forward."""
    geo, ops, ref = case
    assert len(fwd_col_tiles(geo["c"], geo["window"])) == (2 if geo["window"] == 500 else 4)
    got = b2f_emulated(*ops, geo["window"], geo["step"], splits=splits)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=HEAD_RTOL, atol=HEAD_ATOL)


def test_without_owned_rows_the_halo_counts_twice(case):
    """The same tiles adding every row they compute to the mean, halos
    included, miss the tolerance by far: the reason for the owned-row
    bounds."""
    geo, ops, ref = case
    got = b2f_emulated(*ops, geo["window"], geo["step"], owned=False)
    assert tolerance_share(got.numpy(), ref) > 5.0


@pytest.mark.parametrize("c,window,step,t", [
    (8, 637, 100, 800), (64, 285, 107, 400), (72, 261, 131, 400), (24, 533, 1, 534),
], ids=["c8-w637", "c64-w285", "c72-w261", "c24-w533"])
def test_column_tiles_match_plain(c, window, step, t):
    """Tiles at the edges of their reach, against the port's plain f32
    forward on the CPU: the first windows past the whole-window plan at C =
    8 (637: three tiles, the last owning 145 rows), C = 64 (285: 33 rows)
    and C = 72 (261: 9 rows), and three tiles at 533 (the last owning 41
    rows); B = 2, 1 zone, at rtol 1e-4 / atol 1e-5."""
    geo = dict(c=c, z=1, t=t, window=window, step=step)
    x, *weights = [torch.from_numpy(a) for a in _operands(geo, 2, c + window)]
    tiles = fwd_col_tiles(c, window)
    assert len(tiles) == (3 if window in (533, 637) else 2)
    got = b2f_emulated(x, *weights, window, step)
    ref = fused_conv4_head_plain(x[None], *(w[None] for w in weights), window, step)[0]
    torch.testing.assert_close(got, ref, rtol=HEAD_RTOL, atol=HEAD_ATOL)


@pytest.mark.parametrize("c", range(8, 73, 8))
def test_tile_mirror_covers_every_row_once(c):
    """At C = 8 to 72 and windows from 250 to 1000 samples: the whole
    window where its plan fits a block (one unit, owning [0, t1)), else
    ceil((t1 - 16) / 240) column tiles of at most 256 rows whose owned
    ranges cover [0, t1) exactly once, each tile's rows within the columns
    it reads, and the plan's bytes (``fwd_smem_bytes``, the column tiles'
    past the whole window's) within the card's shared memory."""
    for window in list(range(250, 300)) + [400, 500, 533, 600, 636, 637, 800, 1000]:
        t1 = window - K + 1
        whole = fwd_plan_bytes(c, window) <= MAX_SMEM_BYTES
        tiles = fwd_col_tiles(c, window)
        nbytes = fwd_smem_bytes(c, window)
        assert nbytes <= MAX_SMEM_BYTES
        if whole:
            assert nbytes == fwd_plan_bytes(c, window) and len(tiles) == 1
        else:
            assert nbytes == fwd_plan_bytes(c, COL_SPAN + K - 1)
            assert len(tiles) == -(-(t1 - 2 * COL_HALO) // COL_STEP) >= 2
        owned = [tl["s"] + r for tl in tiles for r in range(tl["lo"], tl["hi"])]
        assert owned == list(range(t1))
        for tl in tiles:
            assert tl["nt"] % 8 == 0 and (tl["right"] or tl["e"] <= tl["nt"])
            assert tl["nt"] <= (COL_SPAN if not whole else t1 + 7)
            assert tl["cols"] == min(tl["nt"] + K - 1, window - tl["s"])
            assert tl["lo"] == (COL_HALO if tl["left"] else 0)
            assert tl["hi"] == (COL_SPAN - COL_HALO if tl["right"] else tl["e"])


def test_tiles_begin_where_the_whole_window_ends():
    """The whole window's plan holds up to windows of 284 at C = 64, 260 at
    C = 72 and 636 at C = 8 (228,992, 230,144 and 230,912 bytes); the first
    window past it takes the tiles' plan, 216,704 bytes at C = 64 and
    230,144 at C = 72; the shipped geometry keeps its plan (212,608 bytes);
    C = 80 fits neither plan (243,584 bytes tiled)."""
    for c, last in ((8, 636), (64, 284), (72, 260)):
        assert len(fwd_col_tiles(c, last)) == 1 and len(fwd_col_tiles(c, last + 1)) >= 2
        assert fwd_plan_bytes(c, last) <= MAX_SMEM_BYTES < fwd_plan_bytes(c, last + 1)
    assert fwd_smem_bytes(64, 284) == 228992 and fwd_smem_bytes(8, 636) == 230912
    assert fwd_smem_bytes(64, 285) == fwd_smem_bytes(64, 800) == 216704
    assert fwd_smem_bytes(72, 260) == fwd_smem_bytes(72, 261) == fwd_smem_bytes(72, 800) == 230144
    assert fwd_smem_bytes(64, 250) == fwd_plan_bytes(64, 250) == 212608
    assert fwd_smem_bytes(80, 500) == 243584 > MAX_SMEM_BYTES  # C = 80 stays on B2f-g


@pytest.mark.parametrize("window", [293, 500, 533, 800])
def test_f32_forward_and_weight_gradient_tiles_are_one_geometry(window):
    """B2f's and B2w's column tiles start at the same columns, compute and
    own the same rows and read the same columns, wherever both run in
    tiles (B2w's whole window reaches 292 samples, B2f's 284)."""
    assert fwd_col_tiles(64, window) == bwd_w_col_tiles(64, window)
    assert len(fwd_col_tiles(64, window)) >= 2
