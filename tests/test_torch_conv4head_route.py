"""The head wrappers on geometries the kernels are not built for: off the
CPU they launch the kernels on operands zero-padded or split to a
geometry the kernels take (``ops/cuda/conv4head.py::_adapted``), counted
in each wrapper's ``adapted``, or raise; nothing runs the plain version
on the card.

The kernels are built for O = 32 and K1 = K2 = 5, an even T in bf16, C %
8 == 0 in f32 B2w, and their plans fitting a block. A bf16 geometry that
B2f-bf16 or B2w-bf16 has no plan for runs the f32 kernel on the bf16
kernel's operands where the f32 plan fits (B2w-bf16 at C = 72), and raises
naming both where it does not (C = 128, windows of 600): that route is
held to the plain bf16 version at 1e-2 in relative L2 (the f32 kernel
skips the bf16 roundings of h1, h2 and the cotangents; measured <= 3.4e-3).
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
    bwd_w_smem_bytes,
    conv4head_bwd_bf16_plain,
    conv4head_bwd_plain,
    conv4head_bwd_w,
    conv4head_bwd_x,
    conv4head_bwd_x_plain,
    fused_conv4_head,
    fused_conv4_head_plain,
    fwd_bf16_plan,
    fwd_smem_bytes,
)

torch.set_num_threads(1)

SHIPPED = dict(c=64, t=800, z=8, o=32, w=250, step=125)
BF16_REL_L2 = 1e-3
F32_ROUTE_REL_L2 = 1e-2


def plan_bytes(c, w, step, n, o=32, k=5):
    """The library's ``isd_conv4head_fwd_bf16_smem_bytes``, from the mirror."""
    return fwd_bf16_plan(c, w, step, n, o, k)["total"]


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
        assert not bf16 or t % 2 == 0
        assert bf16 or op != "bwd_w" or c % 8 == 0
        if bf16 and op == "bwd_w":
            _check_smem(bwd_w_bf16_smem_bytes(c, window_len), "B2w-bf16")
        if bf16 and op == "fwd":
            _check_smem(plan_bytes(c, window_len, step, n), "B2f-bf16")
        if not bf16 and op == "fwd":
            _check_smem(fwd_smem_bytes(c, window_len), "B2f")
        if not bf16 and op == "bwd_w":
            _check_smem(bwd_w_smem_bytes(c, window_len), "B2w")
        calls.append(dict(c=c, t=t, n=n))
        if dtypes is not None:
            dtypes.append(x.dtype)
        if op == "fwd":
            return fused_conv4_head_plain(x, w12, b12, w3, w4, window_len, step)
        if op == "bwd_w":
            return conv4head_bwd_plain(g, x, w12, b12, w3, w4, window_len, step)[1:]
        return conv4head_bwd_x_plain(g, x, w12, b12, w3, w4, window_len, step)

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
def test_shipped_geometry_launches_unadapted(op, dtype):
    """FASTConfig.default()'s head (C = 64, O = 32, K = 5, T = 800, windows
    of 250 step 125; one trial, one zone here), and C = 10 in B2f and B2x
    (which take any C), and dense tokens at step 25 (23 windows; B2f-bf16
    groups them, above): one launch on the operands as they are. (B2x has
    no bf16 instantiation.)"""
    for geometry in (dict(SHIPPED, b=1, z=1), dict(c=10), dict(SHIPPED, step=25, b=1, z=1)):
        if geometry.get("step") == 25 and dtype == torch.bfloat16 and op == "fwd":
            continue  # dense tokens: B2f-bf16 groups their windows (above)
        if geometry["c"] == 10 and (op == "bwd_w" or dtype == torch.bfloat16):
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
    ("bwd_w", dict(o=64, z=1), torch.float64, "O <= 32"),
    ("bwd_w", dict(SHIPPED, c=128, b=1, z=1), torch.bfloat16, "B2w-bf16 is not built"),
    ("fwd", dict(c=112, t=800, w=250, step=125, b=1, z=1), torch.bfloat16,
     "B2f-bf16 is not built"),
    ("fwd", dict(c=64, t=600, w=600, step=1, b=1, z=1), torch.bfloat16,
     "B2f-bf16 is not built"),
])
def test_geometry_no_padding_reaches_raises(op, geometry, dtype, why):
    """Taps other than 5, O > 32, C = 128 in B2w-bf16 (its weight-gradient
    tiles exceed the registers), C = 112 or windows of 600 in B2f-bf16 (one
    window's plan exceeds the shared memory), where the f32 route's plan
    does not fit a block either: no launch, a ValueError that names the
    limit (both kernels' for a bf16 geometry)."""
    ops, geo = operands(dtype=dtype, **geometry)
    calls = []
    with pytest.raises(ValueError, match=why) as e:
        _adapted(op, stand_in(op, calls), *ops, *geo, smem_bytes=plan_bytes,
                 bwd_w_smem_bytes=bwd_w_bf16_smem_bytes)
    assert calls == []
    if dtype == torch.bfloat16:
        assert "its f32 route does not fit either" in str(e.value)


@pytest.mark.parametrize("op,geometry", [
    ("bwd_w", dict(SHIPPED, c=72, b=2, z=2)),
    ("bwd_w", dict(SHIPPED, c=68, b=1, z=2)),
    ("bwd_w", dict(SHIPPED, w=280, step=130, b=2, z=1)),
], ids=["c72", "c68", "w280"])
def test_bf16_refusal_routes_to_the_f32_kernel(op, geometry):
    """A bf16 geometry B2w-bf16 has no plan for (C = 72 and 68: its
    weight-gradient tiles exceed the registers; windows of 280 at C = 64: its
    shared memory) where B2w's f32 plan fits: one f32 launch (C padded to a
    multiple of 8), on f32 x and bf16-rounded weights, adapted; the result
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
    B2w at windows of 280 fits, 300 does not)."""
    fits = lambda n: 0 <= n <= conv4head.MAX_SMEM_BYTES  # noqa: E731
    assert fits(fwd_smem_bytes(64, 250)) and fits(bwd_w_smem_bytes(64, 250))
    assert fits(fwd_smem_bytes(72, 250)) and fits(bwd_w_smem_bytes(72, 250))
    assert not fits(fwd_smem_bytes(80, 250)) and not fits(bwd_w_smem_bytes(80, 250))
    assert fits(bwd_w_smem_bytes(64, 280)) and not fits(bwd_w_smem_bytes(64, 300))
    assert not fits(fwd_smem_bytes(128, 250)) and not fits(fwd_smem_bytes(64, 600))


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
    """Meta tensors in bf16 at C = 128 and at windows of 600: neither the
    bf16 kernel's plan nor the f32 one's fits a block, so the wrapper raises
    naming both, with no launch and nothing counted as adapted."""
    calls = []
    launch = stand_in(op, calls)
    monkeypatch.setattr(conv4head, "_require_x", lambda x: None)
    monkeypatch.setattr(conv4head, {"fwd": "_launch_fwd", "bwd_w": "_launch_bwd_w"}[op],
                        (lambda *a: launch(None, *a)) if op == "fwd" else launch)
    monkeypatch.setattr(conv4head._lib, "library", lambda: type(
        "Lib", (), {"isd_conv4head_fwd_bf16_smem_bytes": staticmethod(plan_bytes),
                    "isd_conv4head_bwd_w_bf16_smem_bytes": staticmethod(bwd_w_bf16_smem_bytes)}))
    conv4head._fwd_bf16_windows_built.cache_clear()
    conv4head._bwd_w_bf16_bytes_built.cache_clear()
    ops, geo = meta_operands(torch.bfloat16, **geometry)
    fn = WRAPPERS[op]
    before = fn.adapted
    with pytest.raises(ValueError, match="its f32 route does not fit either"):
        CALLS[op](*ops, geo)
    assert calls == [] and fn.adapted == before
