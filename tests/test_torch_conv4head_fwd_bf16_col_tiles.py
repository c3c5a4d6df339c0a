"""B2f-bf16's column tiles, emulated on the CPU, against the plain bf16
forward and the JAX package.

Where one window's plan does not fit a block (past 580 samples at C = 64,
260 at C = 104), kernel B2f-bf16 (``csrc/conv4head_fwd_bf16.cu``) runs the
window in the column tiles of B2f, B2w-bf16 and B2x-bf16: 256 conv rows,
240 apart, on the plan of one window of 260 samples whatever W is. A
(trial, zone) item takes its (window, tile) units in order; each stages the
trial's columns from the tile's first (from the even column below where
that is odd), runs h1 over the tile's 256 rows (zero from the window's end
on), h2 and h3 with zero pads at the tile's ends, and adds GELU of h3 over
the rows the tile owns only; after the window's last tile the sums are
divided by the window's t1. ``ops/cuda/conv4head.py`` mirrors the plan
(``fwd_bf16_block_plan``, ``fwd_bf16_tile_plan``, ``fwd_bf16_smem_bytes``),
the tiles (``fwd_bf16_col_tiles``), the copies (``fwd_bf16_unit_copy``) and
the descriptors (``fwd_bf16_conv_descs``); ``tests/wgmma_emulation.py``
replays them byte by byte (``emulate_fwd_bf16(..., tiled=True)``). This
file holds the emulation to the plain bf16 forward (3e-4 x max|ref|, the
card tests' bound) and to the Pallas head in bf16 (interpret mode), shows
that each of four faults misses by more than ten times that bound, and
holds the mirror: every conv row owned once, one plan for every tiled
window, every copy and descriptor inside its buffer, and the whole-window
route unchanged wherever its plan fits. A layout forced to the tiles (C =
8 or 16, windows of 285 at C = 64) is what the tiled instantiation would
compute there: its code is the same at every C. On the card,
``tests/test_torch_cuda.py`` runs the kernel itself.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from imagined_speech_decoding_tpu.ops.pallas.conv4head import fused_conv4_head as pallas_head
from imagined_speech_decoding_tpu_torch.ops.cuda.conv4head import (
    COL_HALO,
    COL_SPAN,
    MAX_SMEM_BYTES,
    WG_ROWS,
    fused_conv4_head_plain,
    fwd_bf16_block_plan,
    fwd_bf16_col_tiles,
    fwd_bf16_conv_descs,
    fwd_bf16_plan,
    fwd_bf16_smem_bytes,
    fwd_bf16_tile_plan,
    fwd_bf16_unit_copy,
)
from wgmma_emulation import _slots, emulate_fwd_bf16

torch.set_num_threads(1)

BF16_FWD_REL = 3e-4  # tests/test_torch_cuda.py: |err| <= REL * max|ref|, card vs plain
# (c, z, t, w, step, m, b): two tiles at an odd step (C = 13), a short last
# tile (305-308: 61-64 rows owned), four tiles at C = 8 (one window, 16-byte
# copies), C = 104 past its whole window (260), two windows at a step of 8s
# (16-byte copies), and chip_smoke.py's (64, 581) at an odd step.
GEOMETRIES = {
    "w285-c13-odd": (13, 2, 570, 285, 143, 2, 1),
    "w305": (16, 1, 456, 305, 151, 1, 2),
    "w306": (16, 1, 458, 306, 151, 1, 1),
    "w307": (16, 1, 458, 307, 151, 1, 1),
    "w308": (16, 1, 460, 308, 151, 1, 1),
    "w800-c8": (8, 1, 800, 800, 1, 1, 1),
    "w300-c104": (104, 1, 426, 300, 125, 1, 1),
    "w600-step200": (16, 2, 800, 600, 200, 1, 1),
    "w581-c64": (64, 1, 800, 581, 219, 1, 1),
}


def operands(m, b, c, z, t, seed, o=32, k=5):
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


def geometry_operands(name):
    c, z, t, w, step, m, b = GEOMETRIES[name]
    return operands(m, b, c, z, t, seed=c + w + b), w, step


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_emulation_matches_plain_bf16_forward(name):
    """The emulated column tiles (forced where the whole window's plan would
    fit: the tiled instantiation's code is the same at every C) against
    ``fused_conv4_head_plain`` on a bf16 x: the same rounding points, f32
    sums in another order and the fitted GELU, within 3e-4 x max|ref|."""
    ops, w, step = geometry_operands(name)
    got = emulate_fwd_bf16(*ops, w, step, tiled=True)
    ref = fused_conv4_head_plain(*ops, w, step)
    assert got.shape == ref.shape
    assert rel_max(got, ref) <= BF16_FWD_REL, rel_max(got, ref)


def test_emulation_matches_pallas_head_in_bf16():
    """The emulated column tiles at windows of 285 (two tiles, an odd step)
    against the JAX package's Pallas head on a bf16 x (interpret mode, as
    its own tests run it), model by model: within 3e-4 x max|ref|, under a
    fifth of the Pallas head's own bf16-vs-f32 gap."""
    ops, w, step = geometry_operands("w285-c13-odd")
    got = emulate_fwd_bf16(*ops, w, step, tiled=True)
    x, w12, b12, w3, w4 = ops
    for i in range(x.shape[0]):
        jw = [jnp.asarray(t[i].numpy()) for t in (w12, b12, w3, w4)]
        with pltpu.force_tpu_interpret_mode():
            ref = {dt: np.asarray(pallas_head(jnp.asarray(x[i].float().numpy(), dt), *jw, w,
                                              step), np.float32)
                   for dt in (jnp.bfloat16, jnp.float32)}
        err = rel_max(got[i].numpy().reshape(ref[jnp.bfloat16].shape), ref[jnp.bfloat16])
        gap = rel_max(ref[jnp.float32], ref[jnp.bfloat16])
        assert err <= BF16_FWD_REL < gap / 5, (err, gap)


@pytest.mark.parametrize("fault", [dict(owned=False), dict(whole_t1=False), dict(past="stale"),
                                   dict(past="bias")],
                         ids=["unmasked", "tile_rows", "stale_rows", "b12_past_t1"])
@pytest.mark.parametrize("name", ["w285-c13-odd", "w308", "w581-c64"])
def test_faults_miss_by_far(name, fault):
    """Each fault the design guards against misses the plain forward by more
    than ten times the tolerance: GELU summed over every row a tile
    computes (the halos count twice, the rows past the window's end add
    in), the mean over a tile's 256 rows instead of the window's t1, h1's
    and h2's rows past the window's end left as the tile before wrote them
    (a short last tile's convs read them), and b12 in h1's rows there
    instead of zero."""
    ops, w, step = geometry_operands(name)
    ref = fused_conv4_head_plain(*ops, w, step)
    assert rel_max(emulate_fwd_bf16(*ops, w, step, tiled=True), ref) <= BF16_FWD_REL
    assert rel_max(emulate_fwd_bf16(*ops, w, step, tiled=True, **fault), ref) > 10 * BF16_FWD_REL


@pytest.mark.parametrize("c,w", [(64, 581), (64, 800), (72, 453), (72, 500), (104, 261),
                                 (104, 300), (106, 800), (13, 1000), (64, 285)])
def test_every_conv_row_is_owned_once(c, w):
    """The tiles of a window (forced where the whole window's plan fits)
    own its conv rows [0, t1) once, each inside the rows it computes (every
    tile all COL_SPAN, h1 and h2 zero from ``e`` on), at least COL_HALO rows
    from an interior edge; a tile's columns stay in the window and in the
    staged sub-block, and the last tile's end ``e`` is past its halo."""
    plan = fwd_bf16_tile_plan(c, w, 137, 2)
    t1 = w - plan["k"] + 1
    tiles = fwd_bf16_col_tiles(plan)
    owned = [r for tile in tiles for r in range(tile["s"] + tile["lo"], tile["s"] + tile["hi"])]
    assert sorted(owned) == list(range(t1))
    for tile in tiles:
        assert tile["nt"] == COL_SPAN and tile["cols"] <= min(plan["xr"] - 1, w - tile["s"])
        assert tile["lo"] >= (COL_HALO if tile["left"] else 0)
        assert tile["hi"] <= (COL_SPAN - COL_HALO if tile["right"] else tile["e"])
        assert tile["e"] > 2 * COL_HALO
    step = COL_SPAN - 2 * COL_HALO
    assert len(tiles) == (1 if t1 <= COL_SPAN else -(-(t1 - 2 * COL_HALO) // step))


def test_one_plan_for_every_tiled_window():
    """Past one window's plan the launch takes the column tiles' plan, the
    plan of one window of 260 samples, whatever W and N are: 160,640 bytes
    at C = 64, 186,880 at 72, 230,912 at 104 and 231,968 at 106 (of
    232,448); at C = 107 it no longer fits, and B2f-bf16 refuses. The whole
    window's reach at each C is where the tiles take over."""
    for c, nbytes in ((64, 160640), (72, 186880), (104, 230912), (106, 231968)):
        for w, step, n in ((581, 219, 2), (800, 1, 1), (1000, 250, 3), (261, 131, 5)):
            plan = fwd_bf16_block_plan(c, w, step, n)
            if fwd_bf16_plan(c, w, step, 1)["total"] > MAX_SMEM_BYTES:
                assert plan["tiled"] and fwd_bf16_smem_bytes(c, w, step, n) == nbytes
                assert plan["total"] == fwd_bf16_plan(c, COL_SPAN + 4, 1, 1)["total"]
    assert fwd_bf16_smem_bytes(107, 800, 1, 1) == 232496 > MAX_SMEM_BYTES
    reach = {8: 900, 32: 836, 64: 580, 72: 452, 96: 388, 104: 260, 112: 196, 128: 132}
    for c, w in reach.items():
        assert not fwd_bf16_block_plan(c, w, 1, 1)["tiled"]
        assert fwd_bf16_block_plan(c, w + 1, 1, 1)["tiled"]


@pytest.mark.parametrize("c,w,step,n", [(64, 250, 125, 5), (64, 580, 110, 2), (8, 900, 1, 1),
                                        (72, 250, 125, 3), (104, 250, 125, 1), (13, 120, 37, 8)])
def test_whole_window_plans_are_unchanged(c, w, step, n):
    """Wherever one window's plan fits a block the launch keeps the whole
    window's plan (``fwd_bf16_plan`` of its N windows) and one unit a
    window; the shipped geometry's is the source's 224,640 bytes."""
    plan = fwd_bf16_block_plan(c, w, step, n)
    assert not plan["tiled"] and fwd_bf16_smem_bytes(c, w, step, n) == fwd_bf16_plan(
        c, w, step, n)["total"]
    assert fwd_bf16_col_tiles(plan) == [{"s": 0, "nt": plan["nt"], "e": w - 4, "lo": 0,
                                         "hi": w - 4, "cols": w, "left": False, "right": False}]
    if (c, w, n) == (64, 250, 5):
        assert plan["total"] == 224640


@pytest.mark.parametrize("c,t,w,step", [(64, 800, 581, 219), (64, 800, 600, 200),
                                        (104, 426, 300, 125), (8, 800, 800, 1),
                                        (16, 802, 600, 201), (16, 806, 600, 200)])
def test_copies_and_descriptors_stay_in_their_buffers(c, t, w, step):
    """Each unit's copy starts on an even sample (on 8 with 16-byte copies:
    T and every unit's start multiples of 8, the last copy inside the
    trial), holds the tile's columns from its shift on and stays inside the
    trial and the staged sub-block; every k16 step of h1 (from either
    shift), h2 and h3 (either buffer) reads inside its operand's buffer."""
    n = (t - w) // step + 1
    plan = fwd_bf16_tile_plan(c, w, step, n)
    vec = t % 8 == 0 and (n == 1 or step % 8 == 0)
    for i in range(n):
        for tile in fwd_bf16_col_tiles(plan):
            cp = fwd_bf16_unit_copy(plan, t, i, tile)
            first = i * step + tile["s"]
            assert cp["vec"] == vec and cp["s0"] % (8 if vec else 2) == 0
            assert cp["s0"] + cp["shift"] == first and cp["shift"] == (0 if vec else first % 2)
            assert cp["cnt"] >= cp["shift"] + tile["cols"] and cp["s0"] + cp["cnt"] <= t
            assert cp["cnt"] <= plan["xr"]
    o = plan["o"]
    h2b = (o // 8) * plan["cs_h2"]
    regions = {"xs": (plan["xs"], plan["raw"]), "h1": (plan["h1"], plan["h2"]),
               "h2_0": (plan["h2"], plan["h2"] + h2b), "h2_1": (plan["h2"] + h2b, plan["w12"]),
               "w12": (plan["w12"], plan["w3"]), "w3": (plan["w3"], plan["w4"]),
               "w4": (plan["w4"], plan["bias"])}
    cases = [("h1", 0, shift, "xs", "w12") for shift in (0, 1)]
    cases += [("h2", 0, 0, "h1", "w3"), ("h3", 0, 0, "h2_0", "w4"), ("h3", 1, 0, "h2_1", "w4")]
    for conv, index, shift, a_region, b_region in cases:
        for tile in range(COL_SPAN // WG_ROWS):
            for a, b in fwd_bf16_conv_descs(plan, conv, index, tile, shift):
                for desc, n_mn, region in ((a, WG_ROWS, a_region), (b, o, b_region)):
                    assert desc[0] % 16 == 0
                    slots = _slots(*desc, n_mn, False)
                    lo, hi = regions[region]
                    assert lo <= 2 * int(slots.min()) and 2 * int(slots.max()) + 2 <= hi
