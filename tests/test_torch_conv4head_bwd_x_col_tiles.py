"""B2x's tensor-core route in column tiles, emulated on the CPU, against the
JAX package.

Kernel B2x (``conv4head_bwd_x_kernel`` in ``csrc/conv4head_bwd.cu``) holds a
block's window, activations and zone weights in shared memory. Where that
plan does not fit a block (C = 33-64 past windows of 284 samples, C <= 32
past 436) a (trial, window, zone) runs its window in column tiles of at
most 256 conv rows (``ops.cuda.conv4head.col_tiles``, B2w's and B2f's
geometry): tile j stages the window's columns from s = 240 j, recomputes
h1, h2, h3, dh3, dh2 and dh1 over its rows (zero from the window's end on;
gz is g / t1 of the whole window), keeps in dh1 only the rows it owns,
[8, 248) at an interior edge (the two 'same' convs and their transposes
reach two rows each, so dh1 is exact 8 rows inside an edge), and adds
their reach, dx columns [lo, hi + K - 1) of the tile, into the window's
columns from s + lo. Two neighbouring tiles both reach the K - 1 = 4 seam
columns [240 j + 8, 240 j + 12): there tile j always adds onto what tile
j - 1 wrote. A block runs its zones in turn and each zone's tiles in turn;
its first zone writes every other column, later zones add. With SZ zone
ranges a fixed-order pass sums the SZ partials; the wrapper overlap-adds
the windows in order. Each product is 3xTF32 (``tests/tf32_emulation.py``).

This file emulates exactly that in f32 on the CPU, through the Python
mirror of the kernel's plan (``bwd_x_col_tiles``, ``bwd_x_smem_bytes``),
into NaN-filled buffers (a column read before it is written shows), and
holds it against ``jax.grad`` w.r.t. x of the JAX package's
``fused_conv4_head`` (its Pallas kernels in interpret mode) at windows of
500 (two tiles) and 800 (four) at ``chip_smoke.py``'s tolerance for B2x:
rtol 1e-4, atol 1e-4 * max|ref|; shows that dh1 without the owned-row mask
(the halo counted twice) and a seam written instead of added miss it; and
holds the mirror: every window column reached by one tile, or two at a
seam, and written by one.
"""

import math

import jax
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
    bwd_x_col_tiles,
    bwd_x_plan_bytes,
    bwd_x_smem_bytes,
    conv4head_bwd_x_plain,
    fwd_col_tiles,
)
from tf32_emulation import im2col, mma

torch.set_num_threads(1)

BWD_RTOL = 1e-4  # atol = BWD_RTOL * max|ref| (chip_smoke.py)
O, K = 32, 5
GEOMETRIES = {  # C not a multiple of 32 (B2x pads it to 32 inside the block)
    "w500": dict(c=20, z=2, t=650, window=500, step=150),  # 2 windows, 2 tiles each
    "w800": dict(c=13, z=2, t=800, window=800, step=1),  # 1 window, 4 tiles
}


def gelu_grad(v: torch.Tensor) -> torch.Tensor:
    return torch.special.ndtr(v) + v * torch.exp(-0.5 * v * v) / math.sqrt(2 * math.pi)


def dx_reach(tile, window: int):
    """The tile's dx columns [w0, w1) in its own columns: the reach of the
    rows it owns, clipped to the window."""
    return tile["lo"], min(tile["hi"] + K - 1, window - tile["s"])


def tile_dx(xs, gz, w12p, b12, w3, w4, tile, window, c, owned=True, passes=3):
    """dx of one column tile of every (trial, window, zone) in ``xs (B, N,
    1, Cp, nt + K - 1)`` (the tile's window columns from column 0, zeros
    after): (B, N, Z, C, w1 - w0) over its dx columns [w0, w1). ``owned``:
    dh1 keeps the rows [lo, hi) the tile owns; else every row before the
    window's end, halo rows included."""
    nt, e = tile["nt"], tile["e"]
    live = torch.arange(nt) < e  # the epilogues' zeros past the window's end

    def same(h):  # an activation (O, nt) stored from column K/2 between zeros
        return torch.nn.functional.pad(h, (K // 2, K // 2))

    def transposed(w):  # A[o, k*O + o'] = w[o', k*O + o]
        return w.view(-1, O, K, O).permute(0, 3, 2, 1).reshape(-1, O, K * O)

    fwd, bwd = range(K), range(K - 1, -1, -1)
    h1 = torch.where(live, mma(w12p, im2col(xs, nt, fwd), passes) + b12.view(-1, O, 1), 0.0)
    h2 = torch.where(live, mma(w3, im2col(same(h1), nt, fwd), passes), 0.0)
    dh3 = torch.where(live, gz * gelu_grad(mma(w4, im2col(same(h2), nt, fwd), passes)), 0.0)
    dh2 = torch.where(live, mma(transposed(w4), im2col(same(dh3), nt, bwd), passes), 0.0)
    rows = torch.arange(nt)
    keep = (rows >= tile["lo"]) & (rows < tile["hi"]) if owned else live
    dh1 = torch.where(keep, mma(transposed(w3), im2col(same(dh2), nt, bwd), passes), 0.0)
    w0, w1 = dx_reach(tile, window)
    wcols = -(-w1 // 8) * 8  # whole 8-column tiles, from column 0 here
    # dh1 from column K - 1 between zeros; A[c, k*O + o] = w12z[o, k*Cp + c]
    dh1x = torch.nn.functional.pad(dh1, (K - 1, max(0, wcols - nt)))
    cp = w12p.shape[-1] // K
    a_dx = w12p.view(-1, O, K, cp).permute(0, 3, 2, 1).reshape(-1, cp, K * O)
    return mma(a_dx, im2col(dh1x, wcols, bwd), passes)[..., :c, w0:w1]


def b2x_emulated(g, x, w12, b12, w3, w4, window, step, sz=1, owned=True, seam_adds=True,
                 passes=3):
    """dx (B, C, T) of one model on B2x's tiled route: g (B, N, Z*O), x (B,
    C, T), weights without the model axis; ``sz`` zone ranges a window.
    ``owned``: dh1 keeps only owned rows; ``seam_adds``: the first zone's
    tile j > 0 adds onto the K - 1 seam columns (else writes them)."""
    b, c, t = x.shape
    z = w3.shape[0]
    n = (t - window) // step + 1
    t1 = window - K + 1
    cp = -(-c // 32) * 32  # zero rows in the staged window, zero columns in w12
    xp = torch.nn.functional.pad(x, (0, 0, 0, cp - c))
    w12p = torch.nn.functional.pad(w12.view(z, O, K, c), (0, cp - c)).view(z, O, K * cp)
    gz = g.view(b, n, z, O, 1) / t1
    tiles = bwd_x_col_tiles(c, window)
    dxt = []  # per tile: (B, N, Z, C, w1 - w0)
    for tile in tiles:
        s, cols = tile["s"], tile["cols"]
        xs = torch.zeros((b, n, 1, cp, tile["nt"] + K - 1))
        for i in range(n):
            xs[:, i, 0, :, :cols] = xp[..., i * step + s:i * step + s + cols]
        dxt.append(tile_dx(xs, gz, w12p, b12, w3, w4, tile, window, c, owned, passes))
    parts = []
    for zs in range(sz):  # each block: its zones in turn, each zone's tiles in turn
        z0, z1 = zs * z // sz, (zs + 1) * z // sz
        buf = torch.full((b, n, c, window), float("nan"))  # the block's dxw slice
        for zi in range(z0, z1):
            for tile, d in zip(tiles, dxt):
                w0, w1 = dx_reach(tile, window)
                s = tile["s"]
                wf = w0 + K - 1 if tile["left"] and seam_adds else w0
                if zi == z0:  # the first zone: the seam columns add, the rest are written
                    buf[..., s + w0:s + wf] += d[:, :, zi, :, :wf - w0]
                    buf[..., s + wf:s + w1] = d[:, :, zi, :, wf - w0:]
                else:
                    buf[..., s + w0:s + w1] += d[:, :, zi]
        parts.append(buf)
    dxw = parts[0]
    if sz > 1:  # the fixed-order pass over the partials
        dxw = torch.zeros_like(parts[0])
        for p in parts:
            dxw = dxw + p
    dx = torch.zeros_like(x)
    for i in range(n):
        dx[..., i * step:i * step + window] += dxw[:, i]
    return dx


def _operands(geo, batch: int, seed: int):
    """A cotangent g (B, N, Z*O), x (B, C, T) and one model's head operands
    at the scales of a trained head (unit-variance activations)."""
    rng = np.random.default_rng(seed)
    f32 = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    c, z, t = geo["c"], geo["z"], geo["t"]
    n = (t - geo["window"]) // geo["step"] + 1
    return (f32(batch, n, z * O), f32(batch, c, t), f32(z * O, K * c) / math.sqrt(K * c),
            0.1 * f32(z * O, 1), f32(z, O, K * O) / math.sqrt(K * O),
            f32(z, O, K * O) / math.sqrt(K * O))


@pytest.fixture(scope="module", params=sorted(GEOMETRIES))
def case(request):
    """Operands (B = 2) and JAX's dx, through the Pallas head in interpret
    mode."""
    geo = GEOMETRIES[request.param]
    g, x, *weights = _operands(geo, 2, 31 if request.param == "w500" else 32)
    wj = [jnp.asarray(w) for w in weights]

    def loss(xx):
        return jnp.sum(pallas_head(xx, *wj, geo["window"], geo["step"]) * g)

    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    return geo, [torch.from_numpy(a) for a in (g, x, *weights)], ref


def tolerance_share(got, ref) -> float:
    """The worst element's error over its tolerance (<= 1 passes)."""
    tol = BWD_RTOL * (np.abs(ref).max() + np.abs(ref))
    return float(np.max(np.abs(got - ref) / tol))


@pytest.mark.parametrize("sz", [1, 2])
def test_column_tiles_match_jax(case, sz):
    """B2x's column tiles (two at windows of 500, four at 800), with one
    and two zone ranges a window, against the Pallas head's input gradient."""
    geo, ops, ref = case
    assert len(bwd_x_col_tiles(geo["c"], geo["window"])) == (2 if geo["window"] == 500 else 4)
    got = b2x_emulated(*ops, geo["window"], geo["step"], sz=sz)
    assert got.shape == ref.shape and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), ref, rtol=BWD_RTOL,
                               atol=BWD_RTOL * np.abs(ref).max())


def test_without_owned_rows_the_halo_counts_twice(case):
    """The same tiles keeping every row of dh1 before the window's end,
    halo rows included, miss the tolerance by far: the reason for the mask
    in dh1's epilogue."""
    geo, ops, ref = case
    got = b2x_emulated(*ops, geo["window"], geo["step"], owned=False)
    assert tolerance_share(got.numpy(), ref) > 5.0


def test_a_seam_written_instead_of_added_misses(case):
    """The first zone's tile j > 0 writing its K - 1 seam columns, where
    tile j - 1 wrote before it, drops that tile's share there and misses
    the tolerance by far: the reason the seam always adds."""
    geo, ops, ref = case
    got = b2x_emulated(*ops, geo["window"], geo["step"], seam_adds=False)
    assert tolerance_share(got.numpy(), ref) > 5.0


@pytest.mark.parametrize("c,window,step,t", [
    (64, 285, 107, 400), (64, 533, 1, 534), (40, 300, 100, 400), (8, 437, 363, 800),
], ids=["c64-w285", "c64-w533", "c40-w300", "c8-w437"])
def test_column_tiles_match_plain(c, window, step, t):
    """Tiles at the edges of their reach, against the port's plain input
    gradient on the CPU: the first windows past the whole-window plan at C
    = 64 (285: two tiles, the last owning 33 rows) and C = 8 (437, where C
    <= 32 leaves it), three tiles at 533 (the last owning 41 rows), and C =
    40 at 300 (C rounded up to 64 inside the block); B = 2, 2 zones in one
    range, at rtol 1e-4 / atol 1e-4 * max|ref|."""
    geo = dict(c=c, z=2, t=t, window=window, step=step)
    g, x, *weights = [torch.from_numpy(a) for a in _operands(geo, 2, c + window)]
    tiles = bwd_x_col_tiles(c, window)
    assert len(tiles) == (3 if window == 533 else 2)
    got = b2x_emulated(g, x, *weights, window, step)
    ref = conv4head_bwd_x_plain(g[None], x[None], *(w[None] for w in weights), window, step)[0]
    torch.testing.assert_close(got, ref, rtol=BWD_RTOL, atol=BWD_RTOL * float(ref.abs().max()))


@pytest.mark.parametrize("c", [1, 13, 32, 33, 64])
def test_every_column_is_reached_by_the_tiles_the_rule_says(c):
    """At windows from 250 to 1000 samples: the whole window where its plan
    fits a block (one unit, reaching every column), else ceil((t1 - 16) /
    240) column tiles whose owned rows cover [0, t1) once, whose dx
    columns reach every window column once, or twice at a seam (the K - 1
    columns from 240 j + 8, for j > 0), and of which exactly one writes
    each column (the first zone's tile j > 0 adds at its seam)."""
    for window in list(range(250, 300)) + [400, 436, 437, 500, 533, 600, 800, 1000]:
        t1 = window - K + 1
        tiles = bwd_x_col_tiles(c, window)
        whole = bwd_x_plan_bytes(c, window) <= MAX_SMEM_BYTES
        assert len(tiles) == (1 if whole else -(-(t1 - 2 * COL_HALO) // COL_STEP))
        owned = [tl["s"] + r for tl in tiles for r in range(tl["lo"], tl["hi"])]
        assert owned == list(range(t1))
        reached = np.zeros(window, dtype=int)
        written = np.zeros(window, dtype=int)
        for tl in tiles:
            w0, w1 = dx_reach(tl, window)
            reached[tl["s"] + w0:tl["s"] + w1] += 1
            written[tl["s"] + w0 + (K - 1 if tl["left"] else 0):tl["s"] + w1] += 1
        seam = np.zeros(window, dtype=int)
        for j in range(1, len(tiles)):
            seam[COL_STEP * j + COL_HALO:COL_STEP * j + COL_HALO + K - 1] = 1
        assert (reached == 1 + seam).all() and (written == 1).all()


def test_tiles_begin_where_the_whole_window_ends():
    """The whole window's plan holds windows up to 284 samples at C = 33-64
    (230,144 bytes) and 436 at C <= 32 (231,680 bytes); the first window
    past it takes the tiles' plan, 217,856 bytes at C = 64 (the plan of
    windows of 260), whatever the window; the shipped geometry keeps its
    plan (213,760 bytes); C = 65-96 fits neither plan (271,616 bytes
    tiled) and stays on B2x-g."""
    for c, last in ((64, 284), (33, 284), (32, 436), (1, 436)):
        assert len(bwd_x_col_tiles(c, last)) == 1 and len(bwd_x_col_tiles(c, last + 1)) == 2
        assert bwd_x_plan_bytes(c, last) <= MAX_SMEM_BYTES < bwd_x_plan_bytes(c, last + 1)
    assert bwd_x_smem_bytes(64, 284) == 230144 and bwd_x_smem_bytes(32, 436) == 231680
    assert (bwd_x_smem_bytes(64, 285) == bwd_x_smem_bytes(64, 800)
            == bwd_x_plan_bytes(64, COL_SPAN + K - 1) == 217856)
    assert bwd_x_smem_bytes(64, 250) == bwd_x_plan_bytes(64, 250) == 213760
    assert bwd_x_smem_bytes(65, 500) == bwd_x_smem_bytes(96, 285) == 271616 > MAX_SMEM_BYTES


@pytest.mark.parametrize("window", [293, 500, 533, 800])
def test_input_gradient_tiles_are_the_forward_and_weight_gradient_tiles(window):
    """B2x's column tiles start at the same columns, compute and own the
    same rows and read the same columns as B2f's and B2w's, wherever all
    three run in tiles (B2w's whole window reaches 292 samples)."""
    assert bwd_x_col_tiles(64, window) == fwd_col_tiles(64, window) == bwd_w_col_tiles(64, window)
    assert len(bwd_x_col_tiles(64, window)) >= 2
