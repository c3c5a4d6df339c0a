"""Byte-level emulation of kernels B2w-bf16's and B2f-bf16's wgmma
routes, shared by ``tests/test_torch_conv4head_bwd_w_wgmma.py`` and
``tests/test_torch_conv4head_fwd_bf16_wgmma.py`` (on the CPU) and the
one-tile descriptor self-tests of ``tests/test_torch_cuda.py`` (on the
card).

Shared memory is modelled as an image of 2-byte slots (a float tensor of
bf16 values, one row per block), laid out by the Python mirror of the
kernel's plan (``ops.cuda.conv4head.bwd_w_bf16_plan`` with its column
tiles ``bwd_w_bf16_col_tiles``, or ``fwd_bf16_plan``; ``chunk_offset``).
A wgmma k16 step is emulated by gathering its two operand tiles from the
image through their descriptors (start, byte step between core matrices
along K and along M or N), as the PTX ISA defines the no-swizzle layout,
and multiplying them in f32. The block emulation runs the kernel's
phases on those gathers with the kernel's epilogues, trial after trial
(and in B2w-bf16 column tile after column tile), holding the weight
gradients in f32 accumulator tiles across them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from imagined_speech_decoding_tpu_torch.ops.cuda import conv4head
from imagined_speech_decoding_tpu_torch.ops.cuda.conv4head import (
    FWD_SB,
    WG_EDGE_ROWS,
    COL_HALO,
    WG_ROWS,
    bwd_w_bf16_col_tiles,
    bwd_w_bf16_conv_descs,
    bwd_w_bf16_dw_descs,
    bwd_w_bf16_edge,
    bwd_w_bf16_plan,
    bwd_w_bf16_tiles,
    chunk_offset,
    fwd_bf16_conv_descs,
    fwd_bf16_h1_rows,
    fwd_bf16_plan,
    gelu_fit,
)
from imagined_speech_decoding_tpu_torch.ops.cuda.conv4head import _bf16 as bf16


@functools.lru_cache(maxsize=None)
def _slots(start: int, k_step: int, mn_step: int, n_mn: int, mn_major: bool) -> torch.Tensor:
    """Slot indices ``(n_mn, 16)`` of an operand tile [m or n][k]: core
    matrices of 8 rows x 16 bytes, rows along K (MN-major) or along M / N
    (K-major)."""
    mn = torch.arange(n_mn)[:, None]
    kk = torch.arange(16)[None, :]
    if mn_major:
        byte = start + (kk // 8) * k_step + (kk % 8) * 16 + (mn // 8) * mn_step + (mn % 8) * 2
    else:
        byte = start + (mn // 8) * mn_step + (mn % 8) * 16 + (kk // 8) * k_step + (kk % 8) * 2
    assert int(byte.min()) >= 0 and start % 16 == 0
    return byte // 2


def wgmma(img: torch.Tensor, steps, a_mn_major: bool, b_mn_major: bool,
          acc: torch.Tensor = None) -> torch.Tensor:
    """``acc (U, 64, 32) += A (64 x 16) B (16 x 32)`` over the k16 steps,
    each ``((a_start, k_step, mn_step), (b_start, k_step, mn_step))``."""
    if acc is None:
        acc = torch.zeros((img.shape[0], WG_ROWS, 32))
    for a, b in steps:
        acc = acc + img[:, _slots(*a, WG_ROWS, a_mn_major)] @ img[:, _slots(*b, 32, b_mn_major)].mT
    return acc


@functools.lru_cache(maxsize=None)
def _matrix_slots(base: int, cs: int, rows: int, ch: int, row0: int) -> torch.Tensor:
    r = torch.arange(rows)[:, None] + row0
    c = torch.arange(ch)[None, :]
    return ((base + chunk_offset(cs, r, c)) // 2).flatten()


def write(img: torch.Tensor, base: int, cs: int, mat: torch.Tensor, row0: int = 0,
          ch0: int = 0) -> None:
    """Logical ``mat (U, rows, ch)`` into the chunked buffer at ``base``
    (chunk stride ``cs``), from row ``row0`` and channel ``ch0``."""
    u, rows, ch = mat.shape
    idx = _matrix_slots(base + chunk_offset(cs, 0, ch0), cs, rows, ch, row0)
    img[:, idx] = mat.reshape(u, -1)


def stage_weights(img, base: int, w: torch.Tensor, k: int, ch: int, chp: int) -> None:
    """``w (U, O, K*ch)`` f32 as the kernel stages it: bf16, [chunk of
    (tap, channel)][o][8], channels ch..chp-1 zero."""
    u, o, _ = w.shape
    wp = torch.zeros((u, o, k, chp))
    wp[..., :ch] = w.reshape(u, o, k, ch)
    write(img, base, 16 * o, bf16(wp.reshape(u, o, k * chp)))


def emulate_bwd_w_bf16(g, x, w12, b12, w3, w4, window_len: int, step: int, s: int = 1):
    """B2w-bf16 on the CPU: ``(dw12, db12, dw3, dw4)`` f32 as the kernel
    computes them, with ``s`` trial ranges per (model, zone, window), each
    window in the plan's column tiles (``bwd_w_bf16_col_tiles``): the
    tile's columns into the chunks (the buffer's later rows zero), a short
    last tile's trailing rows zeroed, the convs over its rows, rows past
    the window's end zero, the masked edge chunks of dh3c and dh2c, dh1
    and db12 on the owned rows only, and the weight gradients carried
    across the tiles and trials of a range."""
    m, b, c, _, z, o, k, _, n = conv4head._geometry(x, w12, w3, window_len, step)
    plan = bwd_w_bf16_plan(c, window_len, o, k)
    t1, cs, cp, half = plan["t1"], plan["cs"], plan["cp"], k // 2
    tiles = bwd_w_bf16_tiles(plan)
    u = m * z * n  # one image row per block (model, zone, window) of a trial range
    per_block = lambda t: t.repeat_interleave(n, dim=0)  # noqa: E731  (m*z, ...) -> (u, ...)
    img0 = torch.zeros((u, plan["total"] // 2))
    stage_weights(img0, plan["w12"], per_block(w12.reshape(m * z, o, k * c)), k, c, cp)
    stage_weights(img0, plan["w3"], per_block(w3.reshape(m * z, o, k * o)), k, o, o)
    stage_weights(img0, plan["w4"], per_block(w4.reshape(m * z, o, k * o)), k, o, o)
    bias = per_block(b12.reshape(m * z, 1, o))
    xf = x.float()
    edge_cs = 16 * WG_EDGE_ROWS

    def conv(img, src, transposed, nt):
        return torch.cat([wgmma(img, bwd_w_bf16_conv_descs(plan, src, tile, transposed), False,
                                transposed) for tile in range(nt // WG_ROWS)], dim=1)

    def store(img, name, v, real, shifted=False, ct=None):  # an epilogue: rows K/2 + t
        v = torch.where(real, v, 0.0)
        write(img, plan[name], cs, v, row0=half)
        if shifted:  # the copy one row down, channels O..2O-1
            write(img, plan[name], cs, v, row0=half - 1, ch0=o)
        if ct is not None and ct["left"]:  # rows 0..15, owned from COL_HALO on
            keep = (torch.arange(WG_EDGE_ROWS) >= COL_HALO)[None, :, None]
            write(img, bwd_w_bf16_edge(plan, name, "left"), edge_cs,
                  torch.where(keep, v[:, :WG_EDGE_ROWS], 0.0))
        if ct is not None and ct["right"]:  # the last 16 rows, owned up to nt - COL_HALO
            r0 = plan["nt"] - WG_EDGE_ROWS
            keep = (torch.arange(r0, plan["nt"]) < plan["nt"] - COL_HALO)[None, :, None]
            write(img, bwd_w_bf16_edge(plan, name, "right"), edge_cs,
                  torch.where(keep, v[:, r0:], 0.0))

    parts = {key: [] for key in ("dw12", "db12", "dw3", "dw4")}
    for si in range(s):
        img = img0.clone()
        acc = [torch.zeros((u, WG_ROWS, 32)) for _ in tiles]
        db = torch.zeros((u, o))
        for bi in range(si * b // s, (si + 1) * b // s):
            win = torch.stack([xf[:, bi, :, ni * step : ni * step + window_len]
                               for ni in range(n)], dim=1)  # (m, n, C, W)
            win = win[:, None].expand(m, z, n, c, window_len).reshape(u, c, window_len)
            gz = g[:, bi].reshape(m, n, z, o).transpose(1, 2).reshape(u, 1, o) / t1
            for ct in bwd_w_bf16_col_tiles(plan):
                nt, rows = ct["nt"], torch.arange(ct["nt"])[None, :, None]
                write(img, plan["xs"], cs, win[:, :, ct["s"] : ct["s"] + ct["cols"]].mT)
                if plan["tiles"] > 1:  # column tiles: the buffer's rows past the columns zero
                    write(img, plan["xs"], cs, torch.zeros((u, plan["rows"] - ct["cols"], c)),
                          row0=ct["cols"])
                if nt < plan["nt"]:  # the rows past its own that a short tile's convs read
                    for ch in range((plan["d1"] - plan["h1"]) // cs):
                        write(img, plan["h1"] + ch * cs, cs, torch.zeros((u, half + 1, 8)),
                              row0=nt + half - 1)
                past = rows < ct["e"]
                owned = (rows >= ct["lo"]) & (rows < ct["hi"])
                store(img, "h1", bf16(conv(img, "xs", False, nt) + bias), past, shifted=True)
                store(img, "h2", bf16(conv(img, "h1", False, nt)), past, shifted=True)
                store(img, "d3", bf16(gz * conv4head._gelu_grad(conv(img, "h2", False, nt))),
                      past, ct=ct)
                store(img, "d2", bf16(conv(img, "d3", True, nt)), past, ct=ct)
                dh1 = conv(img, "d2", True, nt)
                db = db + torch.where(owned, dh1, 0.0).sum(dim=1)
                store(img, "d1", bf16(dh1), owned)
                for i, (kind, index) in enumerate(tiles):
                    acc[i] = wgmma(img, bwd_w_bf16_dw_descs(plan, kind, index, ct), True, True,
                                   acc[i])
        dw12 = torch.zeros((u, o, k, c))
        dw3 = torch.zeros((u, o, k, o))
        dw4 = torch.zeros((u, o, k, o))
        for (kind, index), a in zip(tiles, acc):
            if kind == "dw12":
                tap, block = index
                live = min(c - WG_ROWS * block, WG_ROWS)
                dw12[:, :, tap, WG_ROWS * block : WG_ROWS * block + live] = a[:, :live].mT
            else:
                dst = dw3 if kind == "dw3" else dw4
                for half_tile in range(2):
                    tap = 2 * index + half_tile
                    if tap < k:
                        dst[:, :, tap] = a[:, o * half_tile : o * (half_tile + 1)].mT
        for key, v in (("dw12", dw12), ("db12", db), ("dw3", dw3), ("dw4", dw4)):
            parts[key].append(v.reshape(m, z, n, -1))
    out = []
    for key, shape in (("dw12", w12.shape), ("db12", b12.shape), ("dw3", w3.shape),
                       ("dw4", w4.shape)):
        p = torch.stack(parts[key], dim=3).reshape(m, z, n * s, -1)  # partial q = n * S + s
        total = p[:, :, 0]
        for q in range(1, n * s):
            total = total + p[:, :, q]
        out.append(total.reshape(shape))
    return tuple(out)


def selftest_cases(plan: dict, seed: int = 0):
    """One full-size shared-memory image of random bf16 values laid out by
    ``plan`` and, for each descriptor form that B2w-bf16 issues, one tile:
    ``(name, steps, a_mn_major, b_mn_major, expected (64, 32) f64)``, the
    expected product written from the logical matrices alone."""
    rng = np.random.default_rng(seed)
    o, k, rows, cs, cp, nt = (plan[key] for key in ("o", "k", "rows", "cs", "cp", "nt"))
    half = k // 2

    def rand(*shape):
        return bf16(torch.tensor(rng.normal(size=shape).astype(np.float32)))

    xs, h1, d1, d2, d3 = rand(rows, cp), rand(rows, o), rand(rows, o), rand(rows, o), rand(rows, o)
    w12, w3, w4 = rand(o, k * cp), rand(o, k * o), rand(o, k * o)
    h1_down = torch.cat([h1[1:], torch.zeros((1, o))])  # the copy one row down
    img = torch.zeros((1, plan["total"] // 2))
    for name, mat in (("xs", xs), ("h1", torch.cat([h1, h1_down], dim=1)), ("d1", d1),
                      ("d2", d2), ("d3", d3)):
        write(img, plan[name], cs, mat[None])
    for name, mat in (("w12", w12), ("w3", w3), ("w4", w4)):
        write(img, plan[name], 16 * o, mat[None])
    x64, h64, w12_64, w3_64, w4_64 = (a.double() for a in (xs, h1, w12, w3, w4))
    t0 = WG_ROWS * (nt // WG_ROWS - 1)  # the last time tile: the farthest rows
    t = torch.arange(WG_ROWS)
    conv = sum(x64[t0 + t + tap] @ w12_64[:, tap * cp : (tap + 1) * cp].T for tap in range(k))
    conv2 = sum(h64[t + tap] @ w3_64[:, tap * o : (tap + 1) * o].T for tap in range(k))
    conv_t = sum(d3.double()[t0 + t + k - 1 - tap] @ w4_64[:, tap * o : (tap + 1) * o]
                 for tap in range(k))
    tt = torch.arange(nt)
    dw12 = x64[tt + k - 1, :WG_ROWS].T @ d1.double()[half + tt]
    h_pad = torch.cat([h64, torch.zeros((1, o), dtype=torch.float64)])
    p = plan["n34"] - 1  # the last pair: taps 2p and 2p + 1 (past K: the zero rows)
    dw3 = torch.cat([h_pad[tt + 2 * p].T, h_pad[tt + 2 * p + 1].T]) @ d2.double()[half + tt]
    cases = [
        ("conv: A K-major (window), B K-major (w12)",
         bwd_w_bf16_conv_descs(plan, "xs", nt // WG_ROWS - 1, False), False, False, conv),
        ("conv: A K-major (h1), B K-major (w3)",
         bwd_w_bf16_conv_descs(plan, "h1", 0, False), False, False, conv2),
        ("conv^T: A K-major (dh3), B MN-major (w4)",
         bwd_w_bf16_conv_descs(plan, "d3", nt // WG_ROWS - 1, True), False, True, conv_t),
        ("dw12: A MN-major (window), B MN-major (dh1)",
         bwd_w_bf16_dw_descs(plan, "dw12", (k - 1, 0)), True, True, dw12),
        ("dw3: A MN-major (h1 and its copy), B MN-major (dh2)",
         bwd_w_bf16_dw_descs(plan, "dw3", p), True, True, dw3),
    ]
    return img, cases


def emulate_fwd_bf16(x, w12, b12, w3, w4, window_len: int, step: int, rs: int = None):
    """B2f-bf16 on the CPU: ``(M, B, N, Z*O)`` f32 as the kernel computes
    it, one image of shared memory per (model, zone) carried through its
    trials in order. ``rs`` replaces the plan's h1 rows a window (a test
    sets it to ``step``: every window then reads the sequence's own
    columns around its edges instead of its zero pads)."""
    m, b, c, _, z, o, k, _, n = conv4head._geometry(x, w12, w3, window_len, step)
    plan = fwd_bf16_plan(c, window_len, step, n, o, k)
    if rs is not None:
        plan = dict(plan, rs=rs)
    t1, nt, lh, lx, xr, cp = (plan[key] for key in ("t1", "nt", "lh", "lx", "xr", "cp"))
    u = m * z
    img = torch.zeros((u, plan["total"] // 2))
    stage_weights(img, plan["w12"], w12.reshape(u, o, k * c), k, c, cp)
    stage_weights(img, plan["w3"], w3.reshape(u, o, k * o), k, o, o)
    stage_weights(img, plan["w4"], w4.reshape(u, o, k * o), k, o, o)
    bias = b12.reshape(u, 1, o)
    xf = x.float()
    out = torch.zeros((m, b, n, z, o))
    real = (torch.arange(nt) < t1)[None, :, None]
    # the h1 slots of every (column, window) pair the epilogue writes
    pairs = [(col, row) for col in range(lh) for row in fwd_bf16_h1_rows(plan, col)]
    cols = torch.tensor([p[0] for p in pairs])
    h1_slots = _matrix_slots_rows(plan["h1"], plan["cs_h1"], [p[1] for p in pairs], o)

    def conv(name, index):
        tiles = range(FWD_SB // WG_ROWS) if name == "h1" else range(nt // WG_ROWS)
        return torch.cat([wgmma(img, fwd_bf16_conv_descs(plan, name, index, tile), False, False)
                          for tile in tiles], dim=1)

    for bi in range(b):
        trial = xf[:, bi][:, None].expand(m, z, c, xf.shape[-1]).reshape(u, c, -1)
        h1 = torch.zeros((u, plan["nsb"] * FWD_SB, o))
        for sb in range(plan["nsb"]):
            rows = min(xr, lx - FWD_SB * sb)  # the staged samples; the rest keep older bytes
            write(img, plan["xs"], plan["cs_x"], trial[:, :, FWD_SB * sb : FWD_SB * sb + rows].mT)
            h1[:, FWD_SB * sb : FWD_SB * (sb + 1)] = conv("h1", sb)
        h1 = bf16(h1[:, :lh] + bias)
        img[:, h1_slots] = h1[:, cols].reshape(u, -1)
        h2_cs = plan["cs_h2"]
        for i in range(n):
            h2 = torch.where(real, bf16(conv("h2", i)), 0.0)
            write(img, plan["h2"] + (i % 2) * (o // 8) * h2_cs, h2_cs, h2, row0=k // 2)
            h3 = conv("h3", i)
            g = torch.where(real, gelu_fit(h3), 0.0)
            out[:, bi, i] = (g.sum(dim=1) / t1).reshape(m, z, o)
    return out.reshape(m, b, n, z * o)


def _matrix_slots_rows(base: int, cs: int, rows, ch: int) -> torch.Tensor:
    """Slot indices of channels 0..ch-1 of each of ``rows``, row after row."""
    r = torch.tensor(rows)[:, None]
    cc = torch.arange(ch)[None, :]
    return ((base + chunk_offset(cs, r, cc)) // 2).flatten()


def ldmatrix_transpose(raw: torch.Tensor, plan: dict) -> torch.Tensor:
    """B2f-bf16's transpose of a raw x sub-block (``raw (C, xr)``, channel
    rows of xr samples) into its time-major chunks, lane by lane as the
    kernel's raw_to_xs issues it: ldmatrix .x4 .trans (lane l gives the
    address of row l % 8 of matrix l / 8 and receives of each matrix i the
    pair (rows 2 (l % 4), 2 (l % 4) + 1; column l / 4)), then stmatrix .x4
    (lane l gives the address of row l % 8 of matrix l / 8; row r of matrix
    i takes the pairs of lanes 4 r .. 4 r + 3). Returns the logical
    ``(xr, cp)`` matrix read back from the chunks' bytes."""
    c, xr, cp, cs = raw.shape[0], plan["xr"], plan["cp"], plan["cs_x"]
    assert plan["raw"] - plan["xs"] >= -(-cp // 32) * 4 * cs  # four chunks a store fit
    xs = torch.full(((plan["raw"] - plan["xs"]) // 2,), float("nan"))
    for grp in range(-(-cp // 32)):
        rows = [min(8 * (4 * grp + lane // 8) + lane % 8, c - 1) for lane in range(32)]
        for tb in range(xr // 8):
            regs = [[None] * 4 for _ in range(32)]  # regs[lane][i]: a (lo, hi) pair
            for lane in range(32):
                for i in range(4):
                    src = [rows[8 * i + 2 * (lane % 4) + e] for e in range(2)]
                    pair = [float(raw[r, 8 * tb + lane // 4]) for r in src]
                    c0 = 8 * (4 * grp + i) + 2 * (lane % 4)
                    regs[lane][i] = [v if c0 + e < c else 0.0 for e, v in enumerate(pair)]
            for lane in range(32):  # stmatrix: this lane's address is row r of matrix i
                i, r = divmod(lane, 8)
                byte = (4 * grp + i) * cs + 16 * (8 * tb + r)
                row = [v for q in range(4) for v in regs[4 * r + q][i]]
                xs[byte // 2 : byte // 2 + 8] = torch.tensor(row)
    t = torch.arange(xr)[:, None]
    ch = torch.arange(cp)[None, :]
    return xs[chunk_offset(cs, t, ch) // 2]


def fwd_selftest_cases(plan: dict, seed: int = 0):
    """One shared-memory image of random bf16 values laid out by B2f-bf16's
    ``plan`` and, for each of its conv tiles' sources (the x sub-block, a
    window's stacked h1 rows, h2's second buffer), the last tile:
    ``(name, steps, a_mn_major, b_mn_major, expected (64, 32) f64)``."""
    rng = np.random.default_rng(seed)
    o, k, cp = plan["o"], plan["k"], plan["cp"]

    def rand(*shape):
        return bf16(torch.tensor(rng.normal(size=shape).astype(np.float32)))

    xs, h1, h2 = rand(plan["xr"], cp), rand(plan["rows_h1"], o), rand(plan["rows_h2"], o)
    w12, w3, w4 = rand(o, k * cp), rand(o, k * o), rand(o, k * o)
    img = torch.zeros((1, plan["total"] // 2))
    write(img, plan["xs"], plan["cs_x"], xs[None])
    write(img, plan["h1"], plan["cs_h1"], h1[None])
    write(img, plan["h2"] + (o // 8) * plan["cs_h2"], plan["cs_h2"], h2[None])
    for name, mat in (("w12", w12), ("w3", w3), ("w4", w4)):
        write(img, plan[name], 16 * o, mat[None])
    t = torch.arange(WG_ROWS)
    last, window = plan["nt"] // WG_ROWS - 1, plan["n"] - 1

    def product(src, row0, w, ch):
        src, w = src.double(), w.double()
        return sum(src[row0 + t + tap] @ w[:, tap * ch : (tap + 1) * ch].T for tap in range(k))

    return img, [
        ("h1: A the x sub-block (K-major), B w12",
         fwd_bf16_conv_descs(plan, "h1", 0, FWD_SB // WG_ROWS - 1), False, False,
         product(xs, FWD_SB - WG_ROWS, w12, cp)),
        ("h2: A the last window's h1 rows (K-major), B w3",
         fwd_bf16_conv_descs(plan, "h2", window, last), False, False,
         product(h1, window * plan["rs"] + WG_ROWS * last, w3, o)),
        ("h3: A h2's second buffer (K-major), B w4",
         fwd_bf16_conv_descs(plan, "h3", 1, last), False, False,
         product(h2, WG_ROWS * last, w4, o)),
    ]
