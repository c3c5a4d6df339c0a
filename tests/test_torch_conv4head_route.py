"""The head wrappers on geometries the kernels are not built for: off the
CPU they launch the kernels on operands zero-padded or split to a
geometry the kernels take (``ops/cuda/conv4head.py::_adapted``), counted
in each wrapper's ``adapted``, or raise; nothing runs the plain version
on the card.

The tuned kernels are built for O = 32 and K1 = K2 = 5, an even T in
bf16 (B2f-bf16 and B2w-bf16; B2x-bf16 takes any T), C % 8 == 0 in f32
B2w, and their plans fitting a block. B2w-bf16
takes every window at C <= 64 (past 260 samples in column tiles), f32 B2f
and B2w every window at C <= 72, f32 B2x every window at C <= 64 (past the
whole window's plan in column tiles). A
bf16 geometry that B2f-bf16 or B2w-bf16 has no plan for runs the f32
kernel on the bf16 kernel's operands where the f32 whole-window plan fits
(B2w-bf16 at C = 68 and 72, windows up to 268): that route is held to the
plain bf16 version at 1e-2 in relative L2 (the f32 kernel skips the bf16
roundings of h1, h2 and the cotangents; measured <= 3.4e-3); its column
tiles do not widen that route. A bf16 input gradient takes B2x-bf16 at C
<= 64 at every window (past 260 samples in column tiles), at any T, and a
bf16 forward B2f-bf16 at C <= 106 at every window (past one window's plan
in column tiles, all windows in one launch). What
no tuned plan takes (C = 80 or 128, f32 input gradients at C = 65-96 past
windows of 284, a bf16 forward at C = 107 past its whole window or at C =
112, O = 64, a bf16 input
gradient at C = 65 or 80, bf16 weight gradients at C = 65-72 past windows
of 268) goes to the
general kernel of x's precision
(B2f-g, B2w-g, B2x-g), unadapted and counted in
``launches_general`` / ``launches_general_bf16``; only K != 5 raises.
The JAX package trains other widths (``dim_cnn`` 8 in
``cli/zero_shot.py``, 16 in ``tests/test_trajectory_parity.py``). Here,
on the CPU, a stand-in for the launch checks that every geometry it is
handed is one the kernels take and computes it with the plain version:
the adapted result must equal the plain version on the original
operands (f32 route in float64 to 1e-12; bf16 route 1e-3 in relative L2,
since a reordered f32 sum may move a bf16 rounding). Meta tensors then
show the wrappers' counts without a card. ``tests/test_torch_cuda.py``
runs the same geometries through the kernels on the card against the
CPU.
"""

import numpy as np
import pytest
import torch

from imagined_speech_decoding_tpu_torch.ops.cuda import conv4head
from imagined_speech_decoding_tpu_torch.ops.cuda.conv4head import (
    KERNEL_TAPS,
    KERNEL_WIDTH,
    _adapted,
    _bf16,
    _check_smem,
    _geometry,
    bwd_w_bf16_smem_bytes,
    bwd_w_col_tiles,
    bwd_w_plan_bytes,
    bwd_w_smem_bytes,
    bwd_x_bf16_smem_bytes,
    bwd_x_col_tiles,
    bwd_x_plan_bytes,
    bwd_x_smem_bytes,
    conv4head_bwd_bf16_plain,
    conv4head_bwd_plain,
    conv4head_bwd_w,
    conv4head_bwd_x,
    conv4head_bwd_x_plain,
    fused_conv4_head,
    fused_conv4_head_plain,
    fwd_bf16_block_plan,
    fwd_bf16_smem_bytes,
    fwd_col_tiles,
    fwd_plan_bytes,
    fwd_smem_bytes,
    general_reason,
)

torch.set_num_threads(1)

SHIPPED = dict(c=64, t=800, z=8, o=32, w=250, step=125)
BF16_REL_L2 = 1e-3
F32_ROUTE_REL_L2 = 1e-2


def plan_bytes(c, w, step, n, o=32, k=5):
    """The library's ``isd_conv4head_fwd_bf16_smem_bytes``, from the mirror."""
    return fwd_bf16_smem_bytes(c, w, step, n, o, k)


def operands(m=1, b=2, c=10, t=200, z=3, o=32, w=100, step=50, dtype=torch.float64, k=5,
             seed=0):
    """``(g, x, w12, b12, w3, w4)`` from a numpy seed, and the geometry."""
    rng = np.random.default_rng(seed)
    n = (t - w) // step + 1
    wdt = torch.float32 if dtype == torch.bfloat16 else dtype

    def arr(shape, scale=1.0, dt=wdt):
        return torch.tensor(rng.normal(scale=scale, size=shape)).to(dt)

    return ((arr((m, b, n, z * o)), arr((m, b, c, t), dt=dtype),
             arr((m, z * o, k * c), (k * c) ** -0.5), arr((m, z * o, 1), 0.1),
             arr((m, z, o, k * o), (k * o) ** -0.5), arr((m, z, o, k * o), (k * o) ** -0.5)),
            (w, step))


def stand_in(op, calls, dtypes=None):
    """A launch of ``op``'s kernel on the CPU: refuses what the kernel
    refuses (its plan's bytes from the Python mirrors of the library's),
    then computes the plain version. ``dtypes`` collects x's dtype a launch."""

    def launch(g, x, w12, b12, w3, w4, window_len, step):
        _, _, c, t, _, o, k1, k2, n = _geometry(x, w12, w3, window_len, step)
        bf16 = x.dtype == torch.bfloat16
        assert o == KERNEL_WIDTH and k1 == k2 == KERNEL_TAPS
        assert not bf16 or op == "bwd_x" or t % 2 == 0
        assert bf16 or op != "bwd_w" or c % 8 == 0
        if bf16 and op == "bwd_w":
            _check_smem(bwd_w_bf16_smem_bytes(c, window_len), "B2w-bf16")
        if bf16 and op == "fwd":
            _check_smem(plan_bytes(c, window_len, step, n), "B2f-bf16")
        if not bf16 and op == "fwd":
            _check_smem(fwd_smem_bytes(c, window_len), "B2f")
        if not bf16 and op == "bwd_w":
            _check_smem(bwd_w_smem_bytes(c, window_len), "B2w")
        if bf16 and op == "bwd_x":
            _check_smem(bwd_x_bf16_smem_bytes(c, window_len), "B2x-bf16")
        if not bf16 and op == "bwd_x":
            _check_smem(bwd_x_smem_bytes(c, window_len), "B2x")
        calls.append(dict(c=c, t=t, n=n))
        if dtypes is not None:
            dtypes.append(x.dtype)
        if op == "fwd":
            return fused_conv4_head_plain(x, w12, b12, w3, w4, window_len, step)
        if op == "bwd_w":
            return conv4head_bwd_plain(g, x, w12, b12, w3, w4, window_len, step)[1:]
        return conv4head_bwd_x_plain(g, x, w12, b12, w3, w4, window_len, step)

    return launch


def general_stand_in(calls):
    """A general kernel's launch on the CPU (``_launch_general``'s
    arguments): takes any geometry with K = 5, records it, computes the
    plain version."""

    def launch(op, g, x, w12, b12, w3, w4, window_len, step):
        _, _, c, t, _, o, k1, k2, n = _geometry(x, w12, w3, window_len, step)
        assert k1 == k2 == KERNEL_TAPS
        calls.append(dict(op=op, c=c, t=t, o=o, n=n, dtype=x.dtype))
        return plain(op, g, x, w12, b12, w3, w4, (window_len, step))[0 if op != "bwd_w" else
                                                                     slice(None)]

    return launch


def plain(op, g, x, w12, b12, w3, w4, geo):
    if op == "fwd":
        return (fused_conv4_head_plain(x, w12, b12, w3, w4, *geo),)
    if op == "bwd_w":
        return conv4head_bwd_plain(g, x, w12, b12, w3, w4, *geo)[1:]
    return (conv4head_bwd_x_plain(g, x, w12, b12, w3, w4, *geo),)


def assert_matches(got, want, bf16):
    got = got if isinstance(got, tuple) else (got,)
    assert [t.shape for t in got] == [t.shape for t in want]
    for a, r in zip(got, want):
        a, r = a.double(), r.double()
        if bf16:
            assert float((a - r).norm() / r.norm()) <= BF16_REL_L2
        else:
            torch.testing.assert_close(a, r, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("op,geometry,dtype,launches", [
    ("fwd", dict(o=8), torch.float64, [dict(c=10, t=200, n=3)]),
    ("bwd_w", dict(o=8), torch.float64, [dict(c=16, t=200, n=3)]),
    ("bwd_x", dict(o=8), torch.float64, [dict(c=10, t=200, n=3)]),
    ("fwd", dict(o=16), torch.float64, [dict(c=10, t=200, n=3)]),
    ("bwd_w", dict(o=16), torch.float64, [dict(c=16, t=200, n=3)]),
    ("bwd_x", dict(o=16), torch.float64, [dict(c=10, t=200, n=3)]),
    ("fwd", dict(o=8), torch.bfloat16, [dict(c=10, t=200, n=3)]),
    ("bwd_w", dict(o=16), torch.bfloat16, [dict(c=10, t=200, n=3)]),
    ("bwd_w", dict(c=60), torch.float64, [dict(c=64, t=200, n=3)]),
    ("fwd", dict(t=201), torch.bfloat16, [dict(c=10, t=200, n=3)]),
    ("bwd_w", dict(t=201), torch.bfloat16, [dict(c=10, t=200, n=3)]),
    ("fwd", dict(t=199, step=1, w=193), torch.bfloat16, [dict(c=10, t=200, n=8)]),
    ("bwd_w", dict(t=199, step=1, w=193), torch.bfloat16, [dict(c=10, t=200, n=8)]),
    ("fwd", dict(SHIPPED, c=72, b=1, z=1), torch.bfloat16,
     [dict(c=72, t=500, n=3), dict(c=72, t=376, n=2)]),
    ("fwd", dict(SHIPPED, t=1001, b=1, z=1), torch.bfloat16,
     [dict(c=64, t=750, n=5), dict(c=64, t=376, n=2)]),
    ("fwd", dict(SHIPPED, step=25, b=1, z=1), torch.bfloat16,
     [dict(c=64, t=350, n=5)] * 4 + [dict(c=64, t=300, n=3)]),
])
def test_adapted_geometry_launches_the_kernels_exactly(op, geometry, dtype, launches):
    """dim_cnn 8 and 16 (zones zero-padded to 32 channels), f32 B2w at C =
    60 (padded to 64), an odd T in bf16 (the windows' samples in an even
    copy; at step 1 one more, zero-cotangent window), C = 72 and T = 1001
    in bf16 (B2f-bf16 in groups of the windows its plan holds), and dense
    tokens at step 25 in bf16 (``forward_head(step_override=25)``: 23
    windows in groups of 5, 5, 5, 5 and 3): every launch gets a geometry
    its kernel takes, and the result is the plain version's on the
    original operands."""
    ops, geo = operands(dtype=dtype, **geometry)
    calls = []
    got, adapted = _adapted(op, stand_in(op, calls), *ops, *geo, smem_bytes=plan_bytes,
                            bwd_w_smem_bytes=bwd_w_bf16_smem_bytes)
    assert adapted and calls == launches
    assert_matches(got, plain(op, *ops, geo), dtype == torch.bfloat16)


@pytest.mark.parametrize("op,dtype", [("fwd", torch.float64), ("bwd_w", torch.float64),
                                      ("bwd_x", torch.float64), ("fwd", torch.bfloat16),
                                      ("bwd_w", torch.bfloat16)])
def test_empty_batch_launches_nothing(op, dtype):
    """A rank's empty share of a batch (``parallel``'s data axis, a tail
    shorter than the axis): no launch, and the plain version's zeros (no
    feature, zero weight gradients)."""
    ops, geo = operands(b=0, dtype=dtype)
    calls = []
    got, adapted = _adapted(op, stand_in(op, calls), *ops, *geo)
    assert not adapted and calls == []
    got = got if isinstance(got, tuple) else (got,)
    want = plain(op, *ops, geo)
    assert [t.shape for t in got] == [t.shape for t in want]
    assert all(not t.any() for t in got + want)


@pytest.mark.parametrize("op,dtype", [("fwd", torch.float64), ("bwd_w", torch.float64),
                                      ("bwd_x", torch.float64), ("fwd", torch.bfloat16),
                                      ("bwd_w", torch.bfloat16), ("bwd_x", torch.bfloat16)])
def test_shipped_geometry_launches_unadapted(op, dtype):
    """FASTConfig.default()'s head (C = 64, O = 32, K = 5, T = 800, windows
    of 250 step 125; one trial, one zone here), and C = 10 in B2f and B2x
    (which take any C), and dense tokens at step 25 (23 windows; B2f-bf16
    groups them, above): one launch on the operands as they are (a bf16
    B2x: B2x-bf16)."""
    for geometry in (dict(SHIPPED, b=1, z=1), dict(c=10), dict(SHIPPED, step=25, b=1, z=1)):
        if geometry.get("step") == 25 and dtype == torch.bfloat16 and op == "fwd":
            continue  # dense tokens: B2f-bf16 groups their windows (above)
        if geometry["c"] == 10 and (op == "bwd_w" or (dtype == torch.bfloat16
                                                       and op != "bwd_x")):
            continue
        ops, geo = operands(dtype=dtype, **geometry)
        calls = []
        got, adapted = _adapted(op, stand_in(op, calls), *ops, *geo,
                                smem_bytes=plan_bytes, bwd_w_smem_bytes=bwd_w_bf16_smem_bytes)
        t = geometry.get("t", 200)
        assert not adapted and calls == [dict(c=geometry["c"], t=t, n=(t - geo[0]) // geo[1] + 1)]
        assert_matches(got, plain(op, *ops, geo), False)


@pytest.mark.parametrize("op,geometry,dtype,why", [
    ("fwd", dict(k=3), torch.float64, "K1 = K2 = 5"),
    ("bwd_w", dict(o=64, z=1), torch.float64, "O = 64 > 32"),
    ("bwd_w", dict(SHIPPED, c=128, b=1, z=1), torch.bfloat16, "B2w-bf16 is not built"),
    ("fwd", dict(c=112, t=800, w=250, step=125, b=1, z=1), torch.bfloat16,
     "B2f-bf16 is not built"),
    ("fwd", dict(c=107, t=800, w=800, step=1, b=1, z=1), torch.bfloat16,
     "B2f-bf16 is not built"),
])
def test_geometry_no_padding_reaches_raises(op, geometry, dtype, why):
    """Taps other than 5 raise, with no launch. The geometries that raised
    before the general kernels, O > 32, C = 128 in B2w-bf16 (its
    weight-gradient tiles exceed the registers), C = 112 at windows of 250
    or C = 107 at a window of 800 in B2f-bf16 (one window's plan, and its
    column tiles' past that, exceed the shared memory), where the
    f32 route's plan does not fit a block either, launch the general
    kernel of x's precision once, on the operands as they are, with the
    reason naming the limits (both kernels' for a bf16 geometry); the
    result is the plain version's."""
    ops, geo = operands(dtype=dtype, **geometry)
    calls, general = [], []
    if "K1" in why:
        with pytest.raises(ValueError, match=why):
            _adapted(op, stand_in(op, calls), *ops, *geo, smem_bytes=plan_bytes,
                     bwd_w_smem_bytes=bwd_w_bf16_smem_bytes, general=general_stand_in(general))
        assert calls == general == []
        return
    got, adapted = _adapted(op, stand_in(op, calls), *ops, *geo, smem_bytes=plan_bytes,
                            bwd_w_smem_bytes=bwd_w_bf16_smem_bytes,
                            general=general_stand_in(general))
    _, x, w12, _, w3, _ = ops
    _, _, c, t, _, o, _, _, n = _geometry(x, w12, w3, *geo)
    assert not adapted and calls == []
    assert general == [dict(op=op, c=c, t=t, o=o, n=n, dtype=dtype)]
    bf16 = dtype == torch.bfloat16
    refusal = conv4head._bf16_refusal(op, c, geo[0], geo[1], n, plan_bytes,
                                      bwd_w_bf16_smem_bytes) if bf16 else None
    reason = general_reason(op, bf16, c, o, geo[0], refusal)
    assert why in reason and (not bf16 or "the f32 plan does not fit" in reason)
    assert_matches(got, plain(op, *ops, geo), bf16)


@pytest.mark.parametrize("op", ["fwd", "bwd_w", "bwd_x"])
@pytest.mark.parametrize("geometry,dtype", [
    (dict(SHIPPED, c=80, b=1, z=1), torch.float64),
    (dict(SHIPPED, w=500, step=150, b=1, z=1), torch.float64),
    (dict(SHIPPED, w=500, step=150, b=1, z=1), torch.bfloat16),
    (dict(o=64, z=1), torch.bfloat16),
], ids=["f32-c80", "f32-w500", "bf16-w500", "bf16-o64"])
def test_general_route_geometries(op, geometry, dtype):
    """Geometries no tuned plan takes, in f32 (C = 80 at windows of 250) and
    in bf16 (O = 64):
    one launch of the general kernel of x's precision on the operands as
    they are, none of a tuned one, the plain version's result. At windows of
    500 a bf16 forward stays on B2f-bf16 (one window a launch), and weight
    gradients on B2w-bf16 or, in f32, on B2w; an f32 forward takes B2f, an
    f32 input gradient B2x and a bf16 one B2x-bf16 (each in column tiles:
    one launch, unadapted)."""
    ops, geo = operands(dtype=dtype, **geometry)
    calls, general = [], []
    got, adapted = _adapted(op, stand_in(op, calls), *ops, *geo, smem_bytes=plan_bytes,
                            bwd_w_smem_bytes=bwd_w_bf16_smem_bytes,
                            general=general_stand_in(general))
    bf16 = dtype == torch.bfloat16
    if bf16 and op == "fwd" and geometry.get("o", 32) == 32:
        assert adapted and general == [] and len(calls) == 3  # B2f-bf16, a window a launch
    elif geometry.get("o", 32) == 32 and geometry.get("c") == 64:
        assert not adapted and general == [] and calls == [dict(c=64, t=800, n=3)]
    else:
        assert not adapted and calls == [] and [d["dtype"] for d in general] == [dtype]
    assert_matches(got, plain(op, *ops, geo), bf16)


def test_bf16_input_gradient_takes_the_general_kernel():
    """A bf16 x's input gradient that B2x-bf16 has no plan for (C = 65 at
    windows of 250, C = 80 at windows of 500: past its 64 channels, at any
    window) or O = 64: B2x-g bf16, unadapted, no tuned launch, dx in bf16
    equal to the plain bf16 backward's, the reason naming B2x-bf16's limits
    (or O)."""
    for geometry, why in ((dict(SHIPPED, c=65, b=1, z=1), "B2x-bf16 is not built for C=65"),
                          (dict(SHIPPED, c=80, w=500, step=150, b=1, z=1),
                           "B2x-bf16 is not built for C=80 at windows of 500"),
                          (dict(o=64, z=1), "O = 64 > 32")):
        ops, geo = operands(dtype=torch.bfloat16, **geometry)
        calls, general = [], []
        got, adapted = _adapted("bwd_x", stand_in("bwd_x", calls), *ops, *geo,
                                general=general_stand_in(general))
        assert not adapted and calls == [] and [d["op"] for d in general] == ["bwd_x"]
        want = conv4head_bwd_bf16_plain(*ops, *geo)[0]
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)
        c, o = geometry.get("c", 10), geometry.get("o", 32)
        assert why in general_reason("bwd_x", True, c, o, geo[0], None)


@pytest.mark.parametrize("geometry", [
    dict(SHIPPED, b=1, z=1), dict(c=10), dict(SHIPPED, t=300, w=260, step=40, b=1, z=1),
    dict(c=1, t=21, w=5, step=4), dict(t=201), dict(o=16),
    dict(SHIPPED, t=400, w=261, step=130, b=1, z=1), dict(SHIPPED, w=500, step=150, b=1, z=1),
    dict(c=13, t=801, w=801, step=1, b=1, z=2),
], ids=["shipped", "c10", "w260", "w5-c1", "odd-t", "o16", "w261", "w500", "w801-odd-t"])
def test_bf16_input_gradient_takes_b2x_bf16(geometry):
    """A bf16 x's input gradient at C <= 64, at any window (past 260
    samples in column tiles: 261, 500, and one window of an odd T = 801):
    one B2x-bf16 launch (a stand-in that refuses what its plan's mirror
    refuses) on bf16 x as it is, also at an odd T (B2x-bf16 reads x by
    2-byte loads: no even copy), no general kernel; dim_cnn 16 with zones
    zero-padded to 32 channels (adapted). dx in bf16 within 1e-3 in relative
    L2 of the plain bf16 backward's (the stand-in's plain version is
    autograd through the bf16 forward)."""
    ops, geo = operands(dtype=torch.bfloat16, **geometry)
    calls, dtypes, general = [], [], []
    got, adapted = _adapted("bwd_x", stand_in("bwd_x", calls, dtypes), *ops, *geo,
                            general=general_stand_in(general))
    t = geometry.get("t", 200)
    assert adapted == (geometry.get("o", 32) < 32) and general == []
    assert dtypes == [torch.bfloat16]
    assert calls == [dict(c=geometry.get("c", 10), t=t, n=(t - geo[0]) // geo[1] + 1)]
    want = conv4head_bwd_bf16_plain(*ops, *geo)[0]
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert_matches(got, (want,), True)


@pytest.mark.parametrize("op,geometry", [
    ("bwd_w", dict(SHIPPED, c=72, b=2, z=2)),
    ("bwd_w", dict(SHIPPED, c=68, b=1, z=2)),
], ids=["c72", "c68"])
def test_bf16_refusal_routes_to_the_f32_kernel(op, geometry):
    """A bf16 geometry B2w-bf16 has no plan for (C = 72 and 68: its
    weight-gradient tiles exceed the registers) where B2w's f32 plan fits:
    one f32 launch (C padded to a multiple of 8), on f32 x and bf16-rounded
    weights, adapted; the result
    is the plain f32 version on those operands and within
    ``F32_ROUTE_REL_L2`` of the plain bf16 version."""
    ops, geo = operands(dtype=torch.bfloat16, **geometry)
    g, x, w12, b12, w3, w4 = ops
    calls, dtypes = [], []
    got, adapted = _adapted(op, stand_in(op, calls, dtypes), *ops, *geo, smem_bytes=plan_bytes,
                            bwd_w_smem_bytes=bwd_w_bf16_smem_bytes)
    c = geometry["c"]
    assert adapted and dtypes == [torch.float32]
    assert calls == [dict(c=c + (-c) % 8, t=geometry["t"], n=(geometry["t"] - geo[0]) // geo[1] + 1)]
    exact = conv4head_bwd_plain(g, x.float(), _bf16(w12), b12, _bf16(w3), _bf16(w4), *geo)[1:]
    assert_matches(got, exact, False)
    bf16_ref = conv4head_bwd_bf16_plain(g, x, w12, b12, w3, w4, *geo)[1:]
    for a, r in zip(got, bf16_ref):
        assert float((a - r).norm() / r.norm()) <= F32_ROUTE_REL_L2


def test_f32_plan_mirrors_match_the_shipped_geometry():
    """The f32 plans' mirrors at the shipped geometry fit a block, and their
    limits are where the route's choice changes (C = 72 fits, 80 does not;
    B2w's whole window at windows of 280 fits, 300 does not, where its
    column tiles' plan takes over; B2f's whole window at 600 does not fit
    either, where its column tiles' plan takes over)."""
    fits = lambda n: 0 <= n <= conv4head.MAX_SMEM_BYTES  # noqa: E731
    assert fits(fwd_smem_bytes(64, 250)) and fits(bwd_w_smem_bytes(64, 250))
    assert fits(fwd_smem_bytes(72, 250)) and fits(bwd_w_smem_bytes(72, 250))
    assert not fits(fwd_smem_bytes(80, 250)) and not fits(bwd_w_smem_bytes(80, 250))
    assert fits(bwd_w_plan_bytes(64, 280)) and not fits(bwd_w_plan_bytes(64, 300))
    assert bwd_w_smem_bytes(64, 280) == bwd_w_plan_bytes(64, 280)
    assert fits(bwd_w_smem_bytes(64, 300)) and bwd_w_smem_bytes(64, 300) < bwd_w_plan_bytes(64, 300)
    assert not fits(fwd_smem_bytes(128, 250)) and not fits(fwd_plan_bytes(64, 600))
    assert fits(fwd_smem_bytes(64, 600)) and fwd_smem_bytes(64, 600) < fwd_plan_bytes(64, 600)


def test_b2x_plan_mirror_limits():
    """B2x's plan mirrors: the whole window's (``bwd_x_plan_bytes``) 213,760
    bytes at the shipped geometry (csrc/conv4head_bwd.cu's header), C up to
    64 at windows of 250 (C rounds up to 32) and windows up to 284 at C =
    64; from 285 on the column tiles' plan (``bwd_x_smem_bytes``), 217,856
    bytes whatever the window, takes over. So f32 input gradients at C = 64
    take B2x at windows of 500 (no general reason), and C = 65 and O = 64
    the general kernel."""
    fits = lambda n: n <= conv4head.MAX_SMEM_BYTES  # noqa: E731
    assert bwd_x_smem_bytes(64, 250) == bwd_x_plan_bytes(64, 250) == 213760
    assert fits(bwd_x_smem_bytes(64, 250)) and not fits(bwd_x_smem_bytes(65, 250))
    assert fits(bwd_x_plan_bytes(64, 284)) and not fits(bwd_x_plan_bytes(64, 285))
    assert bwd_x_smem_bytes(64, 284) == bwd_x_plan_bytes(64, 284)
    for w in (285, 500, 800):
        assert bwd_x_smem_bytes(64, w) == 217856 and len(bwd_x_col_tiles(64, w)) >= 2
    assert general_reason("bwd_x", False, 65, 32, 250, None)
    assert not general_reason("bwd_x", False, 64, 32, 250, None)
    assert not general_reason("bwd_x", False, 64, 32, 500, None)
    assert "C=65" in general_reason("bwd_x", False, 65, 32, 500, None)
    assert "O = 64" in general_reason("bwd_x", False, 64, 64, 500, None)


CALLS = {
    "fwd": lambda g, x, w12, b12, w3, w4, geo: fused_conv4_head(x, w12, b12, w3, w4, *geo),
    "bwd_w": lambda g, x, w12, b12, w3, w4, geo: conv4head_bwd_w(g, x, w12, b12, w3, w4, *geo),
    "bwd_x": lambda g, x, w12, b12, w3, w4, geo: conv4head_bwd_x(g, x, w12, b12, w3, w4, *geo),
}
WRAPPERS = {"fwd": fused_conv4_head, "bwd_w": conv4head_bwd_w, "bwd_x": conv4head_bwd_x}


def meta_operands(dtype, **geometry):
    ops, geo = operands(dtype=dtype, **geometry)
    return [torch.empty(t.shape, dtype=t.dtype, device="meta") for t in ops], geo


@pytest.mark.parametrize("op", ["fwd", "bwd_w", "bwd_x"])
@pytest.mark.parametrize("geometry", [dict(o=8), dict(SHIPPED, b=1, z=1)], ids=["o8", "shipped"])
def test_off_cpu_never_falls_back(op, geometry):
    """On a device other than the CPU the wrappers take the kernels' route
    whatever the geometry: meta tensors stop at its CUDA check, with no
    launch, no adaptation and no plain version counted."""
    ops, geo = meta_operands(torch.float32, **geometry)
    fn = WRAPPERS[op]
    before = (fn.launches, fn.adapted)
    with pytest.raises(ValueError, match="CUDA tensor"):
        CALLS[op](*ops, geo)
    assert (fn.launches, fn.adapted) == before


@pytest.mark.parametrize("op,geometry,dtype,launches,adapted", [
    ("fwd", dict(SHIPPED, b=1, z=1), torch.bfloat16, 1, 0),
    ("fwd", dict(o=8), torch.float32, 1, 1),
    ("fwd", dict(SHIPPED, t=1001, b=1, z=1), torch.bfloat16, 2, 1),
    ("bwd_w", dict(c=60), torch.float32, 1, 1),
    ("bwd_w", dict(t=201), torch.bfloat16, 1, 1),
    ("bwd_x", dict(o=16), torch.float32, 1, 1),
    ("bwd_w", dict(SHIPPED, c=72, b=1, z=1), torch.bfloat16, 1, 1),
    ("fwd", dict(SHIPPED, c=72, b=1, z=1), torch.bfloat16, 2, 1),
])
def test_wrappers_count_adapted_calls(monkeypatch, op, geometry, dtype, launches, adapted):
    """With the CUDA check and the launches stood in for (meta tensors, no
    card), each wrapper adds one to ``adapted`` for a call whose operands
    it padded or split, none at the shipped geometry, and hands every
    launch a geometry its kernel takes."""
    calls = []
    launch = stand_in(op, calls)
    monkeypatch.setattr(conv4head, "_require_x", lambda x: None)
    monkeypatch.setattr(conv4head, {"fwd": "_launch_fwd", "bwd_w": "_launch_bwd_w",
                                    "bwd_x": "_launch_bwd_x"}[op],
                        (lambda *a: launch(None, *a)) if op == "fwd" else launch)
    monkeypatch.setattr(conv4head._lib, "library", lambda: type(
        "Lib", (), {"isd_conv4head_fwd_bf16_smem_bytes": staticmethod(plan_bytes),
                    "isd_conv4head_bwd_w_bf16_smem_bytes": staticmethod(bwd_w_bf16_smem_bytes)}))
    conv4head._fwd_bf16_windows_built.cache_clear()
    conv4head._bwd_w_bf16_bytes_built.cache_clear()
    ops, geo = meta_operands(dtype, **geometry)
    fn = WRAPPERS[op]
    before = fn.adapted
    got = CALLS[op](*ops, geo)
    assert len(calls) == launches and fn.adapted == before + adapted
    want = {"fwd": [ops[0].shape], "bwd_w": [t.shape for t in ops[2:]],
            "bwd_x": [ops[1].shape]}[op]
    assert [t.shape for t in (got if isinstance(got, tuple) else (got,))] == want


@pytest.mark.parametrize("op,geometry", [
    ("fwd", dict(SHIPPED, c=128, b=1, z=1)), ("bwd_w", dict(SHIPPED, c=128, b=1, z=1)),
    ("fwd", dict(c=64, t=600, w=600, step=1, b=1, z=1)),
    ("bwd_w", dict(c=64, t=600, w=600, step=1, b=1, z=1)),
], ids=["fwd-c128", "bwd_w-c128", "fwd-w600", "bwd_w-w600"])
def test_wrappers_raise_where_no_route_fits(monkeypatch, op, geometry):
    """Meta tensors in bf16 at C = 128 and at windows of 600, where neither
    the bf16 kernel's plan nor the f32 one's fits a block, raised before the
    general kernels; now the wrapper launches B2f-g or B2w-g bf16 once at C
    = 128 (a stand-in here, which counts as the launch does), no tuned
    kernel, and counts nothing as adapted. At windows of 600 (C = 64) the
    forward takes B2f-bf16's column tiles and the weight gradients
    B2w-bf16's instead: one tuned launch, no general one."""
    calls, general = [], []
    tiled = geometry["c"] <= 64
    launch = stand_in(op, calls)
    run_general = general_stand_in(general)

    def counted(op_, *args):
        out = run_general(op_, *args)
        conv4head._lib.count(WRAPPERS[op_], "launches_general_bf16")
        return out

    monkeypatch.setattr(conv4head, "_require_x", lambda x: None)
    monkeypatch.setattr(conv4head, {"fwd": "_launch_fwd", "bwd_w": "_launch_bwd_w"}[op],
                        (lambda *a: launch(None, *a)) if op == "fwd" else launch)
    monkeypatch.setattr(conv4head, "_launch_general", counted)
    monkeypatch.setattr(conv4head._lib, "library", lambda: type(
        "Lib", (), {"isd_conv4head_fwd_bf16_smem_bytes": staticmethod(plan_bytes),
                    "isd_conv4head_bwd_w_bf16_smem_bytes": staticmethod(bwd_w_bf16_smem_bytes)}))
    conv4head._fwd_bf16_windows_built.cache_clear()
    conv4head._bwd_w_bf16_bytes_built.cache_clear()
    ops, geo = meta_operands(torch.bfloat16, **geometry)
    fn = WRAPPERS[op]
    before = (fn.adapted, fn.launches_general_bf16, fn.launches_general)
    got = CALLS[op](*ops, geo)
    if tiled:
        assert len(calls) == 1 and general == []
    else:
        assert calls == [] and [d["op"] for d in general] == [op]
    assert (fn.adapted, fn.launches_general_bf16, fn.launches_general) == (
        before[0], before[1] + (not tiled), before[2])
    want = {"fwd": [ops[0].shape], "bwd_w": [t.shape for t in ops[2:]]}[op]
    assert [t.shape for t in (got if isinstance(got, tuple) else (got,))] == want


@pytest.mark.parametrize("geometry,tuned", [
    (dict(SHIPPED, b=2, z=2), True), (dict(SHIPPED, c=1, b=1, z=1), True),
    (dict(SHIPPED, t=300, w=260, step=40, b=1, z=1), True), (dict(t=201), True),
    (dict(SHIPPED, c=65, b=1, z=1), False), (dict(SHIPPED, t=400, w=261, step=130, b=1, z=1), True),
    (dict(o=64, z=1), False), (dict(SHIPPED, w=800, b=1), True),
    (dict(SHIPPED, c=80, w=800, b=1), False),
], ids=["shipped", "c1", "w260", "odd-t", "c65", "w261", "o64", "w800", "c80-w800"])
def test_bf16_input_gradient_routes_on_meta(monkeypatch, geometry, tuned):
    """A bf16 ``conv4head_bwd_x`` on meta tensors, the launches stood in
    for (each counting as its launch does): at C <= 64, at every window
    (261 and 800: B2x-bf16's column tiles), one B2x-bf16 launch, counted in
    ``launches_bf16``; at C = 65 or 80 or O = 64 one B2x-g bf16 launch,
    counted in ``launches_general_bf16``; never the f32 B2x, nothing
    adapted; dx of x's shape in bf16."""
    calls, general = [], []
    launch, run_general = stand_in("bwd_x", calls), general_stand_in(general)

    def counted(*args):
        out = launch(*args)
        conv4head._lib.count(conv4head_bwd_x, "launches_bf16")
        return out

    def counted_general(op, *args):
        out = run_general(op, *args)
        conv4head._lib.count(conv4head_bwd_x, "launches_general_bf16")
        return out

    monkeypatch.setattr(conv4head, "_require_x", lambda x: None)
    monkeypatch.setattr(conv4head, "_launch_bwd_x", counted)
    monkeypatch.setattr(conv4head, "_launch_general", counted_general)
    ops, geo = meta_operands(torch.bfloat16, **geometry)
    fn = conv4head_bwd_x
    before = (fn.launches_bf16, fn.launches_general_bf16, fn.launches, fn.launches_general,
              fn.adapted)
    got = CALLS["bwd_x"](*ops, geo)
    assert (len(calls), len(general)) == ((1, 0) if tuned else (0, 1))
    assert (fn.launches_bf16, fn.launches_general_bf16, fn.launches, fn.launches_general,
            fn.adapted) == (before[0] + tuned, before[1] + (not tuned), *before[2:])
    assert got.shape == ops[1].shape and got.dtype == torch.bfloat16


@pytest.mark.parametrize("c,w,step,t", [
    (64, 500, 150, 800), (64, 280, 130, 800), (64, 800, 1, 800), (1, 500, 150, 800),
    (10, 261, 130, 800), (33, 292, 127, 800),
], ids=["w500", "w280", "w800", "w500-c1", "w261-c10", "w292-c33"])
def test_bf16_weight_gradients_take_the_column_tiles(monkeypatch, c, w, step, t):
    """bf16 weight gradients at C <= 64 and windows past 260 samples (280,
    292: once the f32 route, 500 and 800: once B2w-g bf16) on meta tensors:
    one B2w-bf16 launch (a stand-in that refuses what its plan's mirror
    refuses, counting as the launch does) on the operands as they are, bf16
    x, counted in ``launches_bf16``; no general kernel, no f32 kernel,
    nothing adapted; the gradients' shapes."""
    calls, dtypes, general = [], [], []
    launch = stand_in("bwd_w", calls, dtypes)

    def counted(*args):
        out = launch(*args)
        conv4head._lib.count(conv4head_bwd_w, "launches_bf16")
        return out

    monkeypatch.setattr(conv4head, "_require_x", lambda x: None)
    monkeypatch.setattr(conv4head, "_launch_bwd_w", counted)
    monkeypatch.setattr(conv4head, "_launch_general", general_stand_in(general))
    monkeypatch.setattr(conv4head._lib, "library", lambda: type(
        "Lib", (), {"isd_conv4head_bwd_w_bf16_smem_bytes": staticmethod(bwd_w_bf16_smem_bytes)}))
    conv4head._bwd_w_bf16_bytes_built.cache_clear()
    ops, geo = meta_operands(torch.bfloat16, c=c, t=t, w=w, step=step, b=2, z=1)
    fn = conv4head_bwd_w
    before = (fn.launches_bf16, fn.launches, fn.adapted, fn.launches_general_bf16)
    got = CALLS["bwd_w"](*ops, geo)
    assert general == [] and dtypes == [torch.bfloat16]
    assert calls == [dict(c=c, t=t, n=(t - w) // step + 1)]
    assert (fn.launches_bf16, fn.launches, fn.adapted, fn.launches_general_bf16) == (
        before[0] + 1, before[1], before[2], before[3])
    assert [x.shape for x in got] == [x.shape for x in ops[2:]]


def _stand_in_wrappers(monkeypatch, calls, dtypes, general):
    """``conv4head_bwd_w`` on meta tensors: the CUDA check and the launches
    stood in for (a tuned launch refusing what its plan's mirror refuses,
    a general one taking any geometry), each counting as its launch does."""
    launch, run_general = stand_in("bwd_w", calls, dtypes), general_stand_in(general)

    def counted(g, x, *args):
        out = launch(g, x, *args)
        conv4head._lib.count(conv4head_bwd_w, "launches_bf16" if x.dtype == torch.bfloat16
                             else "launches")
        return out

    def counted_general(op, g, x, *args):
        out = run_general(op, g, x, *args)
        conv4head._lib.count(conv4head_bwd_w, "launches_general_bf16"
                             if x.dtype == torch.bfloat16 else "launches_general")
        return out

    monkeypatch.setattr(conv4head, "_require_x", lambda x: None)
    monkeypatch.setattr(conv4head, "_launch_bwd_w", counted)
    monkeypatch.setattr(conv4head, "_launch_general", counted_general)
    monkeypatch.setattr(conv4head._lib, "library", lambda: type(
        "Lib", (), {"isd_conv4head_bwd_w_bf16_smem_bytes": staticmethod(bwd_w_bf16_smem_bytes)}))
    conv4head._bwd_w_bf16_bytes_built.cache_clear()


def _bwd_w_counts():
    fn = conv4head_bwd_w
    return (fn.launches, fn.launches_bf16, fn.launches_general, fn.launches_general_bf16,
            fn.adapted)


@pytest.mark.parametrize("c", [64, 72, 60])
@pytest.mark.parametrize("w,step", [(293, 127), (500, 150), (800, 1)], ids=["w293", "w500", "w800"])
def test_f32_weight_gradients_take_the_column_tiles(monkeypatch, c, w, step):
    """f32 weight gradients past B2w's whole-window plan (windows of 293,
    500 and 800 at C = 64, 72, and 60, padded to 64) on meta tensors: one B2w
    launch (its plan's mirror in column tiles), counted in ``launches``; no
    general kernel; ``adapted`` only for the padded C."""
    calls, dtypes, general = [], [], []
    _stand_in_wrappers(monkeypatch, calls, dtypes, general)
    ops, geo = meta_operands(torch.float32, c=c, t=800, w=w, step=step, b=2, z=1)
    assert len(bwd_w_col_tiles(c + (-c) % 8, w)) >= 2
    before = _bwd_w_counts()
    got = CALLS["bwd_w"](*ops, geo)
    assert general == [] and dtypes == [torch.float32]
    assert calls == [dict(c=c + (-c) % 8, t=800, n=(800 - w) // step + 1)]
    assert _bwd_w_counts() == (before[0] + 1, before[1], before[2], before[3],
                               before[4] + (c % 8 != 0))
    assert [x.shape for x in got] == [x.shape for x in ops[2:]]


@pytest.mark.parametrize("geometry", [dict(c=80, w=250, step=125), dict(c=80, w=500, step=150),
                                      dict(c=64, o=64, w=500, step=150)],
                         ids=["c80-w250", "c80-w500", "o64-w500"])
def test_f32_weight_gradients_beyond_the_tiles_stay_general(monkeypatch, geometry):
    """f32 weight gradients at C = 80 (neither B2w plan fits) and at O = 64
    (B2w is built for O = 32): B2w-g, once, on the operands as they are,
    counted in ``launches_general``; no tuned launch."""
    calls, dtypes, general = [], [], []
    _stand_in_wrappers(monkeypatch, calls, dtypes, general)
    ops, geo = meta_operands(torch.float32, t=800, b=2, z=1, **geometry)
    before = _bwd_w_counts()
    CALLS["bwd_w"](*ops, geo)
    assert calls == [] and [(d["op"], d["dtype"]) for d in general] == [("bwd_w", torch.float32)]
    assert _bwd_w_counts() == (before[0], before[1], before[2] + 1, before[3], before[4])


@pytest.mark.parametrize("c", [65, 68, 72])
@pytest.mark.parametrize("w,step", [(269, 131), (293, 127), (500, 150)],
                         ids=["w269", "w293", "w500"])
def test_bf16_past_the_f32_route_stays_general(monkeypatch, c, w, step):
    """bf16 weight gradients that B2w-bf16 refuses (C = 65-72) past windows
    of 268, where B2w's whole-window plan does not fit: B2w-g bf16, once, on
    the bf16 operands; not the f32 route (``_f32_route``, inexact), though
    B2w's column tiles would take the f32 operands. The reason names both
    kernels."""
    calls, dtypes, general = [], [], []
    _stand_in_wrappers(monkeypatch, calls, dtypes, general)
    ops, geo = meta_operands(torch.bfloat16, c=c, t=800, w=w, step=step, b=2, z=1)
    assert conv4head.f32_plan_fits("bwd_w", c, w) and not conv4head.f32_plan_fits(
        "bwd_w", c, w, tiles=False)
    before = _bwd_w_counts()
    CALLS["bwd_w"](*ops, geo)
    assert calls == [] and [(d["op"], d["dtype"]) for d in general] == [("bwd_w", torch.bfloat16)]
    assert _bwd_w_counts() == (before[0], before[1], before[2], before[3] + 1, before[4])
    refusal = conv4head._bf16_refusal("bwd_w", c, w, step, 1, plan_bytes, bwd_w_bf16_smem_bytes)
    reason = general_reason("bwd_w", True, c, 32, w, refusal)
    assert "B2w-bf16 is not built" in reason and "the f32 plan does not fit" in reason


def _stand_in_forward(monkeypatch, calls, dtypes, general):
    """``fused_conv4_head`` on meta tensors: the CUDA check and the launches
    stood in for (a tuned launch refusing what its plan's mirror refuses,
    a general one taking any geometry), each counting as its launch does."""
    launch, run_general = stand_in("fwd", calls, dtypes), general_stand_in(general)

    def counted(x, *args):
        out = launch(None, x, *args)
        conv4head._lib.count(fused_conv4_head, "launches_bf16" if x.dtype == torch.bfloat16
                             else "launches")
        return out

    def counted_general(op, g, x, *args):
        out = run_general(op, g, x, *args)
        conv4head._lib.count(fused_conv4_head, "launches_general_bf16"
                             if x.dtype == torch.bfloat16 else "launches_general")
        return out

    monkeypatch.setattr(conv4head, "_require_x", lambda x: None)
    monkeypatch.setattr(conv4head, "_launch_fwd", counted)
    monkeypatch.setattr(conv4head, "_launch_general", counted_general)
    monkeypatch.setattr(conv4head._lib, "library", lambda: type(
        "Lib", (), {"isd_conv4head_fwd_bf16_smem_bytes": staticmethod(plan_bytes)}))
    conv4head._fwd_bf16_windows_built.cache_clear()


def _fwd_counts():
    fn = fused_conv4_head
    return (fn.launches, fn.launches_bf16, fn.launches_general, fn.launches_general_bf16,
            fn.adapted)


@pytest.mark.parametrize("c", [60, 64, 72])
@pytest.mark.parametrize("w,step", [(285, 128), (500, 150), (800, 1)], ids=["w285", "w500", "w800"])
def test_f32_forwards_take_the_column_tiles(monkeypatch, c, w, step):
    """f32 forwards past B2f's whole-window plan (windows of 285, 500 and
    800 at C = 60, 64 and 72) on meta tensors: one B2f launch (its plan's
    mirror in column tiles) on the operands as they are, counted in
    ``launches``; no general kernel, nothing adapted (B2f takes any C)."""
    calls, dtypes, general = [], [], []
    _stand_in_forward(monkeypatch, calls, dtypes, general)
    ops, geo = meta_operands(torch.float32, c=c, t=800, w=w, step=step, b=2, z=1)
    assert len(fwd_col_tiles(c, w)) >= 2
    assert not conv4head.f32_plan_fits("fwd", c, w, tiles=False)
    before = _fwd_counts()
    got = CALLS["fwd"](*ops, geo)
    assert general == [] and dtypes == [torch.float32]
    assert calls == [dict(c=c, t=800, n=(800 - w) // step + 1)]
    assert _fwd_counts() == (before[0] + 1, *before[1:])
    assert got.shape == (1, 2, (800 - w) // step + 1, 32)


@pytest.mark.parametrize("geometry", [dict(c=80, w=500, step=150), dict(c=80, w=800, step=1),
                                      dict(c=64, o=64, w=500, step=150)],
                         ids=["c80-w500", "c80-w800", "o64-w500"])
def test_f32_forwards_beyond_the_tiles_stay_general(monkeypatch, geometry):
    """f32 forwards at C = 80 (neither B2f plan fits: 243,584 bytes tiled)
    and at O = 64 (B2f is built for O = 32): B2f-g, once, on the operands as
    they are, counted in ``launches_general``; no tuned launch."""
    calls, dtypes, general = [], [], []
    _stand_in_forward(monkeypatch, calls, dtypes, general)
    ops, geo = meta_operands(torch.float32, t=800, b=2, z=1, **geometry)
    before = _fwd_counts()
    CALLS["fwd"](*ops, geo)
    assert calls == [] and [(d["op"], d["dtype"]) for d in general] == [("fwd", torch.float32)]
    assert _fwd_counts() == (before[0], before[1], before[2] + 1, before[3], before[4])


@pytest.mark.parametrize("geometry", [dict(c=112, w=250, step=125), dict(c=128, w=250, step=125),
                                      dict(c=107, w=600, step=1), dict(c=107, w=800, step=1)],
                         ids=["c112-w250", "c128-w250", "c107-w600", "c107-w800"])
def test_bf16_forward_refusals_stay_general(monkeypatch, geometry):
    """bf16 forwards B2f-bf16 has no plan for (C = 112 and 128 at windows of
    250, one window of 600 or 800 samples at C = 107, past its column
    tiles' plan too): B2f-g bf16, once, on the bf16 operands; not the f32
    route (``_f32_route``, inexact). The reason names both kernels. (One
    window of 600 or 800 at C = 64 takes B2f-bf16's column tiles:
    ``test_bf16_forwards_take_the_column_tiles``.)"""
    calls, dtypes, general = [], [], []
    _stand_in_forward(monkeypatch, calls, dtypes, general)
    ops, geo = meta_operands(torch.bfloat16, t=800, b=2, z=1, **geometry)
    c, w, step = geometry["c"], geometry["w"], geometry["step"]
    refusal = conv4head._bf16_refusal("fwd", c, w, step, (800 - w) // step + 1, plan_bytes,
                                      bwd_w_bf16_smem_bytes)
    assert refusal and not conv4head.f32_plan_fits("fwd", c, w, tiles=False)
    assert conv4head.f32_plan_fits("fwd", c, w) == (c <= 72)
    before = _fwd_counts()
    CALLS["fwd"](*ops, geo)
    assert calls == [] and [(d["op"], d["dtype"]) for d in general] == [("fwd", torch.bfloat16)]
    assert _fwd_counts() == (before[0], before[1], before[2], before[3] + 1, before[4])
    reason = general_reason("fwd", True, c, 32, w, refusal)
    assert "B2f-bf16 is not built" in reason and "the f32 plan does not fit" in reason


@pytest.mark.parametrize("c,w,step", [(64, 581, 219), (64, 800, 1), (72, 500, 150),
                                      (104, 300, 125), (106, 800, 1)],
                         ids=["c64-w581", "c64-w800", "c72-w500", "c104-w300", "c106-w800"])
def test_bf16_forwards_take_the_column_tiles(monkeypatch, c, w, step):
    """bf16 forwards past B2f-bf16's whole-window plan (one window of 581 or
    800 samples at C = 64, 500 at C = 72, 300 at C = 104, 800 at C = 106)
    on meta tensors: one B2f-bf16 launch (its plan's mirror in column
    tiles) taking all the trial's windows on the operands as they are (T
    even), counted in ``launches_bf16``; no general kernel, nothing
    adapted, no f32 launch."""
    calls, dtypes, general = [], [], []
    _stand_in_forward(monkeypatch, calls, dtypes, general)
    n = (800 - w) // step + 1
    assert fwd_bf16_block_plan(c, w, step, n)["tiled"]
    ops, geo = meta_operands(torch.bfloat16, c=c, t=800, w=w, step=step, b=2, z=1)
    before = _fwd_counts()
    got = CALLS["fwd"](*ops, geo)
    assert general == [] and dtypes == [torch.bfloat16] and calls == [dict(c=c, t=800, n=n)]
    assert _fwd_counts() == (before[0], before[1] + 1, *before[2:])
    assert got.shape == (1, 2, n, 32)


@pytest.mark.parametrize("geometry", [dict(c=107, w=800, step=1), dict(c=112, w=250, step=125),
                                      dict(c=64, o=64, w=800, step=1)],
                         ids=["c107-w800", "c112-w250", "o64-w800"])
def test_bf16_forwards_past_the_tiles_stay_general(monkeypatch, geometry):
    """bf16 forwards that B2f-bf16's column tiles do not take either (C =
    107 at one window of 800, C = 112 at windows of 250: the tiles' plan
    past the shared memory) or O = 64 (B2f-bf16 is built for O = 32):
    B2f-g bf16, once, counted in ``launches_general_bf16``; no tuned
    launch, nothing adapted."""
    calls, dtypes, general = [], [], []
    _stand_in_forward(monkeypatch, calls, dtypes, general)
    ops, geo = meta_operands(torch.bfloat16, t=800, b=2, z=1, **geometry)
    before = _fwd_counts()
    CALLS["fwd"](*ops, geo)
    assert calls == [] and [(d["op"], d["dtype"]) for d in general] == [("fwd", torch.bfloat16)]
    assert _fwd_counts() == (*before[:3], before[3] + 1, before[4])


def test_no_bf16_forward_takes_the_f32_route(monkeypatch):
    """No bf16 forward reaches ``_f32_route``: at C <= 106 B2f-bf16 takes
    every window (its whole-window plan or its column tiles'), and past
    that what it refuses goes to B2f-g bf16 even where B2f's f32
    whole-window plan would fit (C = 121-200 at short windows)."""
    for c in range(1, 201):
        for w in (5, 20, 133, 197, 250, 261, 300, 453, 581, 800, 1000):
            refusal = conv4head._bf16_refusal("fwd", c, w, 1, 1, plan_bytes,
                                              bwd_w_bf16_smem_bytes)
            assert (refusal is None) == (c <= 106 or plan_bytes(c, w, 1, 1) <= conv4head
                                         .MAX_SMEM_BYTES), (c, w)
            assert not refusal or general_reason("fwd", True, c, 32, w, refusal), (c, w)
    monkeypatch.setattr(conv4head, "_f32_route", lambda *a: pytest.fail("the f32 route"))
    calls, general = [], []
    for c, w in ((121, 133), (106, 800), (150, 20)):
        ops, geo = operands(dtype=torch.bfloat16, c=c, t=w, w=w, step=1, b=1, z=1)
        _adapted("fwd", stand_in("fwd", calls), *ops, *geo, smem_bytes=plan_bytes,
                 bwd_w_smem_bytes=bwd_w_bf16_smem_bytes, general=general_stand_in(general))
    assert [d["c"] for d in general] == [121, 150] and [d["c"] for d in calls] == [106]
    assert conv4head.f32_plan_fits("fwd", 121, 133, tiles=False)


def _stand_in_input_gradient(monkeypatch, calls, dtypes, general):
    """``conv4head_bwd_x`` on meta tensors: the CUDA check and the launches
    stood in for (a tuned launch refusing what its plan's mirror refuses,
    a general one taking any geometry), each counting as its launch does."""
    launch, run_general = stand_in("bwd_x", calls, dtypes), general_stand_in(general)

    def counted(g, x, *args):
        out = launch(g, x, *args)
        conv4head._lib.count(conv4head_bwd_x, "launches_bf16" if x.dtype == torch.bfloat16
                             else "launches")
        return out

    def counted_general(op, g, x, *args):
        out = run_general(op, g, x, *args)
        conv4head._lib.count(conv4head_bwd_x, "launches_general_bf16"
                             if x.dtype == torch.bfloat16 else "launches_general")
        return out

    monkeypatch.setattr(conv4head, "_require_x", lambda x: None)
    monkeypatch.setattr(conv4head, "_launch_bwd_x", counted)
    monkeypatch.setattr(conv4head, "_launch_general", counted_general)


def _bwd_x_counts():
    fn = conv4head_bwd_x
    return (fn.launches, fn.launches_bf16, fn.launches_general, fn.launches_general_bf16,
            fn.adapted)


@pytest.mark.parametrize("c", [13, 40, 64])
@pytest.mark.parametrize("w,step", [(285, 128), (500, 150), (800, 1)], ids=["w285", "w500", "w800"])
def test_f32_input_gradients_take_the_column_tiles(monkeypatch, c, w, step):
    """f32 input gradients at C <= 64 and windows of 285, 500 and 800 (past
    B2x's whole-window plan at C = 40 and 64; C = 13 keeps the whole window
    up to 436) on meta tensors: one B2x launch (its plan's mirror) on the
    operands as they are, counted in ``launches``; no general kernel,
    nothing adapted (B2x takes any C); dx of x's shape."""
    calls, dtypes, general = [], [], []
    _stand_in_input_gradient(monkeypatch, calls, dtypes, general)
    ops, geo = meta_operands(torch.float32, c=c, t=800, w=w, step=step, b=2, z=1)
    assert len(bwd_x_col_tiles(c, w)) == (1 if c == 13 and w < 437 else -(-(w - 20) // 240))
    assert conv4head.f32_plan_fits("bwd_x", c, w)
    before = _bwd_x_counts()
    got = CALLS["bwd_x"](*ops, geo)
    assert general == [] and dtypes == [torch.float32]
    assert calls == [dict(c=c, t=800, n=(800 - w) // step + 1)]
    assert _bwd_x_counts() == (before[0] + 1, *before[1:])
    assert got.shape == ops[1].shape and got.dtype == torch.float32


@pytest.mark.parametrize("geometry,why", [
    (dict(c=72, w=500, step=150), "the f32 plan does not fit a block at C=72, windows of 500"),
    (dict(c=96, w=285, step=128), "the f32 plan does not fit a block at C=96, windows of 285"),
    (dict(c=64, o=64, w=500, step=150), "O = 64 > 32"),
], ids=["c72-w500", "c96-w285", "o64-w500"])
def test_f32_input_gradients_beyond_the_tiles_stay_general(monkeypatch, geometry, why):
    """f32 input gradients at C = 72 and 96 (Cp = 96: neither B2x plan
    fits, 271,616 bytes tiled) and at O = 64 (B2x is built for O = 32):
    B2x-g f32, once, on the operands as they are, counted in
    ``launches_general``; no tuned launch; the reason says why."""
    calls, dtypes, general = [], [], []
    _stand_in_input_gradient(monkeypatch, calls, dtypes, general)
    ops, geo = meta_operands(torch.float32, t=800, b=2, z=1, **geometry)
    before = _bwd_x_counts()
    CALLS["bwd_x"](*ops, geo)
    assert calls == [] and [(d["op"], d["dtype"]) for d in general] == [("bwd_x", torch.float32)]
    assert _bwd_x_counts() == (before[0], before[1], before[2] + 1, before[3], before[4])
    c, o = geometry["c"], geometry.get("o", 32)
    assert why in general_reason("bwd_x", False, c, o, geometry["w"], None)
