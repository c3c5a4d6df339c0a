"""B2w's tensor-core route in column tiles, emulated on the CPU, against the
JAX package.

Kernel B2w (``conv4head_bwd_w_kernel`` in ``csrc/conv4head_bwd.cu``) holds a
block's window and activations in shared memory. Where that plan does not
fit a block (C <= 64 past windows of 292 samples, C = 65-72 past 268) a
(trial, window, zone) runs its window in column tiles of at most 256 conv
rows (``ops.cuda.conv4head.col_tiles``, B2w-bf16's geometry): tile j
stages the window's columns from s = 240 j, recomputes the forward and the
cotangents over its rows, and adds to the weight gradients only the rows
it owns, [8, 248) at an interior edge, since the two 'same' convs and their
transposes reach two rows each and dh1 is exact 8 rows inside an edge. B2w
reduces over time in steps of 8, so an owned edge only moves the bounds
of the reduction. Each product is 3xTF32 (``tests/tf32_emulation.py``).
A block adds each (trial, tile)'s sums into its partial in that order (the
first writes); a fixed-order pass sums the partials of the windows and
trial ranges.

This file emulates exactly that in f32 on the CPU, through the Python
mirror of the kernel's plan (``bwd_w_col_tiles``, ``bwd_w_smem_bytes``), and
holds it against ``jax.grad`` w.r.t. the weights of the JAX package's
``fused_conv4_head`` (its Pallas kernels in interpret mode) at windows of
500 (two tiles) and 800 (four) at ``chip_smoke.py``'s tolerance for the
backward kernels: rtol 1e-4, atol 1e-4 * max|ref| per tensor; and shows
that without the owned-row bounds the halo rows count twice and miss it.
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
    bwd_w_bf16_col_tiles,
    bwd_w_bf16_plan,
    bwd_w_col_tiles,
    bwd_w_plan_bytes,
    bwd_w_smem_bytes,
    conv4head_bwd_plain,
)
from tf32_emulation import im2col, mma

torch.set_num_threads(1)

BWD_RTOL = 1e-4  # atol = BWD_RTOL * max|ref| per tensor (chip_smoke.py)
O, K = 32, 5
GEOMETRIES = {  # C not a multiple of 8 at 500 (padded to 16, as the wrapper does)
    "w500": dict(c=10, z=2, t=650, window=500, step=150),  # 2 windows, 2 tiles each
    "w800": dict(c=16, z=2, t=800, window=800, step=1),  # 1 window, 4 tiles
}
NAMES = ("dw12", "db12", "dw3", "dw4")


def gelu_grad(v: torch.Tensor) -> torch.Tensor:
    return torch.special.ndtr(v) + v * torch.exp(-0.5 * v * v) / math.sqrt(2 * math.pi)


def tile_sums(xs, gz, w12p, b12, w3, w4, tile, owned=True, passes=3):
    """One column tile of every (trial, window) in ``xs (B, N, 1, Cp,
    nt + K - 1)`` (the tile's window columns from column 0, zeros after):
    the f32 sums over its rows of (dw12, db12, dw3, dw4), (B, N, Z, ...).
    ``owned``: over the rows it owns, [lo, hi) rounded up to 8 (the
    kernel's reduction bounds); else over every row it computes."""
    nt, e = tile["nt"], tile["e"]
    live = torch.arange(nt) < e  # the epilogues' zeros past the window's end

    def same(h):  # an activation (O, nt) stored from column K/2 between zeros
        return torch.nn.functional.pad(h, (K // 2, K // 2))

    def transposed(w):  # A[o, k*O + o'] = w[o', k*O + o]
        return w.view(-1, O, K, O).permute(0, 3, 2, 1).reshape(-1, O, K * O)

    fwd, bwd = range(K), range(K - 1, -1, -1)
    p1 = im2col(xs, nt, fwd)
    h1 = torch.where(live, mma(w12p, p1, passes) + b12.view(-1, O, 1), 0.0)
    p2 = im2col(same(h1), nt, fwd)
    h2 = torch.where(live, mma(w3, p2, passes), 0.0)
    p3 = im2col(same(h2), nt, fwd)
    dh3 = torch.where(live, gz * gelu_grad(mma(w4, p3, passes)), 0.0)
    dh2 = torch.where(live, mma(transposed(w4), im2col(same(dh3), nt, bwd), passes), 0.0)
    dh1 = torch.where(live, mma(transposed(w3), im2col(same(dh2), nt, bwd), passes), 0.0)
    r0, r1 = (tile["lo"], -(-tile["hi"] // 8) * 8) if owned else (0, nt)

    def dw(d, p):  # dw[o, n] = sum_t d[o, t] p[n, t] in steps of 8 from r0
        return mma(d[..., r0:r1], p[..., r0:r1].transpose(-1, -2), passes)

    return dw(dh1, p1), dh1[..., r0:r1].sum(-1), dw(dh2, p2), dw(dh3, p3)


def b2w_emulated(g, x, w12, b12, w3, w4, window, step, splits=1, owned=True, passes=3):
    """(dw12, db12, dw3, dw4) of one model on B2w's route: g (B, N, Z*O), x
    (B, C, T), weights without the model axis; ``splits`` trial ranges a
    (zone, window)."""
    b, c, t = x.shape
    z = w3.shape[0]
    n = (t - window) // step + 1
    t1 = window - K + 1
    cp = -(-c // 8) * 8  # _adapted pads f32 B2w's C to a multiple of 8
    xp = torch.nn.functional.pad(x, (0, 0, 0, cp - c))
    w12p = torch.nn.functional.pad(w12.view(z, O, K, c), (0, cp - c)).view(z, O, K * cp)
    gz = g.view(b, n, z, O, 1) / t1
    sums = []  # per tile: (B, N, Z, ...) tensors
    for tile in bwd_w_col_tiles(cp, window):
        s, cols = tile["s"], tile["cols"]
        xs = torch.zeros((b, n, 1, cp, tile["nt"] + K - 1))
        for i in range(n):
            xs[:, i, 0, :, :cols] = xp[..., i * step + s:i * step + s + cols]
        sums.append(tile_sums(xs, gz, w12p, b12, w3, w4, tile, owned, passes))
    parts = []  # the blocks' partials, p = window * splits + range
    for i in range(n):
        for r in range(splits):
            acc = None
            for bi in range(r * b // splits, (r + 1) * b // splits):
                for tile in sums:  # the block's units: (trial, tile) in turn, the first writes
                    unit = [a[bi, i] for a in tile]
                    acc = unit if acc is None else [a + u for a, u in zip(acc, unit)]
            parts.append(acc)
    out = [torch.zeros_like(a) for a in parts[0]]  # the fixed-order pass over the partials
    for part in parts:
        out = [o + p for o, p in zip(out, part)]
    dw12, db12, dw3, dw4 = out
    return (dw12.view(z, O, K, cp)[..., :c].reshape(z * O, K * c), db12.reshape(z * O, 1),
            dw3, dw4)


def _operands(geo, batch: int, seed: int):
    """One model's head operands at the scales of a trained head, x (B, C,
    T), and a cotangent g (B, N, Z*O)."""
    rng = np.random.default_rng(seed)
    f32 = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    c, z, t = geo["c"], geo["z"], geo["t"]
    n = (t - geo["window"]) // geo["step"] + 1
    return (f32(batch, n, z * O), f32(batch, c, t), f32(z * O, K * c) / math.sqrt(K * c),
            0.1 * f32(z * O, 1), f32(z, O, K * O) / math.sqrt(K * O),
            f32(z, O, K * O) / math.sqrt(K * O))


@pytest.fixture(scope="module", params=sorted(GEOMETRIES))
def case(request):
    """Operands (B = 2) and JAX's weight gradients, through the Pallas head
    in interpret mode."""
    geo = GEOMETRIES[request.param]
    g, x, *weights = _operands(geo, 2, 11 if request.param == "w500" else 12)

    def loss(*ws):
        return jnp.sum(pallas_head(jnp.asarray(x), *ws, geo["window"], geo["step"]) * g)

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(w) for w in weights))
    return geo, [torch.from_numpy(a) for a in (g, x, *weights)], [np.asarray(r) for r in ref]


def tolerance_share(got, ref) -> float:
    """The worst element's error over its tolerance (<= 1 passes)."""
    tol = BWD_RTOL * (np.abs(ref) + np.abs(ref).max())
    return float(np.max(np.abs(got - ref) / tol))


@pytest.mark.parametrize("splits", [1, 2])
def test_column_tiles_match_jax(case, splits):
    """B2w's column tiles (two at windows of 500, four at 800), with one and
    two trial ranges a (zone, window), against the Pallas VJP."""
    geo, ops, ref = case
    assert len(bwd_w_col_tiles(-(-geo["c"] // 8) * 8, geo["window"])) == (
        2 if geo["window"] == 500 else 4)
    got = b2w_emulated(*ops, geo["window"], geo["step"], splits=splits)
    for name, a, r in zip(NAMES, got, ref):
        assert a.shape == r.shape, name
        np.testing.assert_allclose(a.numpy(), r, rtol=BWD_RTOL, atol=BWD_RTOL * np.abs(r).max(),
                                   err_msg=name)


def test_without_owned_rows_the_halo_counts_twice(case):
    """The same tiles summing every row they compute, halos included, miss
    the tolerance by far in every weight gradient: the reason for the
    owned-row bounds."""
    geo, ops, ref = case
    got = b2w_emulated(*ops, geo["window"], geo["step"], owned=False)
    shares = {name: tolerance_share(a.numpy(), r) for name, a, r in zip(NAMES, got, ref)}
    assert min(shares.values()) > 5.0, shares


@pytest.mark.parametrize("c,window,step,t", [
    (8, 293, 100, 400), (64, 293, 107, 400), (72, 269, 131, 400), (72, 500, 150, 650),
    (24, 533, 1, 534),
], ids=["c8-w293", "c64-w293", "c72-w269", "c72-w500", "c24-w533"])
def test_column_tiles_match_plain(c, window, step, t):
    """Tiles at the edges of their reach, against the port's plain f32
    backward (autograd on the CPU): the first windows past the whole-window
    plan at C = 8 and 64 (293; a last tile of 49 rows) and at C = 72 (269:
    a last tile of 25 rows), C = 72 at windows of 500, and three tiles at
    533 (the last 37 rows); B = 2, 1 zone, each at BWD_RTOL."""
    geo = dict(c=c, z=1, t=t, window=window, step=step)
    g, x, *weights = [torch.from_numpy(a) for a in _operands(geo, 2, c + window)]
    tiles = bwd_w_col_tiles(c, window)
    assert len(tiles) == (3 if window == 533 else 2)
    got = b2w_emulated(g, x, *weights, window, step)
    ref = conv4head_bwd_plain(g[None], x[None], *(w[None] for w in weights), window, step)[1:]
    for name, a, r in zip(NAMES, got, ref):
        torch.testing.assert_close(a, r[0], rtol=BWD_RTOL, atol=BWD_RTOL * float(r.abs().max()),
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("c", range(8, 73, 8))
def test_tile_mirror_covers_every_row_once(c):
    """At every C the wrapper hands B2w (multiples of 8 up to 72) and
    windows from 250 to 1000 samples: the whole window where its plan fits
    a block (one unit, owning [0, t1)), else ceil((t1 - 16) / 240) column
    tiles of at most 256 rows whose owned ranges cover [0, t1) exactly
    once, each tile's rows within the columns it reads, and the plan's
    bytes (``bwd_w_smem_bytes``, the column tiles' past the whole window's)
    within the card's shared memory."""
    for window in list(range(250, 320)) + [400, 500, 533, 600, 800, 1000]:
        t1 = window - K + 1
        whole = bwd_w_plan_bytes(c, window) <= MAX_SMEM_BYTES
        tiles = bwd_w_col_tiles(c, window)
        nbytes = bwd_w_smem_bytes(c, window)
        assert nbytes <= MAX_SMEM_BYTES
        if whole:
            assert nbytes == bwd_w_plan_bytes(c, window) and len(tiles) == 1
        else:
            assert nbytes == bwd_w_plan_bytes(c, COL_SPAN + K - 1)
            assert len(tiles) == -(-(t1 - 2 * COL_HALO) // COL_STEP) >= 2
        owned = [tl["s"] + r for tl in tiles for r in range(tl["lo"], tl["hi"])]
        assert owned == list(range(t1))
        for tl in tiles:
            assert tl["nt"] % 8 == 0 and (tl["right"] or tl["e"] <= tl["nt"])
            assert tl["nt"] <= (COL_SPAN if not whole else t1 + 7)
            assert tl["cols"] == min(tl["nt"] + K - 1, window - tl["s"])


def test_tiles_begin_where_the_whole_window_ends():
    """The whole window's plan holds up to windows of 292 at C <= 64 and of
    268 at C = 72 (229,120 and 230,912 bytes); the first window past it
    takes the tiles' plan, 208,640 bytes at C <= 64 and 225,280 at C = 72;
    the shipped geometry keeps its plan (203,520 bytes)."""
    for c, last in ((8, 292), (64, 292), (72, 268)):
        assert len(bwd_w_col_tiles(c, last)) == 1 and len(bwd_w_col_tiles(c, last + 1)) == 2
    assert bwd_w_smem_bytes(64, 292) == 229120 and bwd_w_smem_bytes(72, 268) == 230912
    assert bwd_w_smem_bytes(64, 293) == bwd_w_smem_bytes(64, 800) == 208640
    assert bwd_w_smem_bytes(72, 269) == bwd_w_smem_bytes(72, 800) == 225280
    assert bwd_w_smem_bytes(64, 250) == bwd_w_plan_bytes(64, 250) == 203520
    assert bwd_w_smem_bytes(80, 250) > MAX_SMEM_BYTES  # C = 80 stays on B2w-g


@pytest.mark.parametrize("window", [261, 293, 500, 800])
def test_f32_and_bf16_tiles_are_one_geometry(window):
    """B2w's and B2w-bf16's column tiles start at the same columns and own
    the same rows; only the rows a short last tile computes round up to
    different tile heights (8 and 64)."""
    f32 = bwd_w_col_tiles(64, window)
    bf16 = bwd_w_bf16_col_tiles(bwd_w_bf16_plan(64, window))
    if len(f32) == 1:  # the f32 whole-window plan holds up to 292 samples
        assert window <= 292 and len(bf16) == 2
        return
    key = lambda tl: (tl["s"], tl["e"], tl["lo"], tl["hi"], tl["left"], tl["right"])  # noqa: E731
    assert [key(tl) for tl in f32] == [key(tl) for tl in bf16]
