"""The port's masked batch norm (``ops/norm.py``) against the JAX package's:
outputs and new running statistics in train and eval mode, with channel
masks of zones of different sizes and with sample masks, in f32 and in
bf16 (the JAX rounding points), and the stacked module's buffers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagined_speech_decoding_tpu.ops import norm as jax_norm
from imagined_speech_decoding_tpu_torch.ops import norm

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5  # tests/test_torch_parity.py
# Zones of 3, 1 and 4 rows padded to 4: the padded rows must stay out of
# the statistics.
ZONE_MASK = np.array([[1, 1, 1, 0], [1, 0, 0, 0], [1, 1, 1, 1]], np.float32)


def _inputs(seed, shape=(5, 6, 4, 9)):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 2.0 + 0.5).astype(np.float32)
    f = shape[1]
    params = {"scale": rng.uniform(0.5, 1.5, f).astype(np.float32),
              "bias": rng.normal(size=f).astype(np.float32)}
    state = (rng.normal(size=f).astype(np.float32), rng.uniform(0.5, 2.0, f).astype(np.float32))
    return x, params, state


def _masks(kind, x):
    """A channel mask over the rows (axis 2), a sample mask, or both."""
    b, f, c = x.shape[:3]
    rows = np.zeros((1, f, c, 1), np.float32)
    rows[0, :, :] = ZONE_MASK[np.arange(f) % 3][:, :, None]  # each feature in a zone
    sample = np.array([1, 1, 0, 1, 0][:b], np.float32)
    return {"none": (None, None), "rows": (rows, None), "sample": (None, sample),
            "both": (rows, sample)}[kind]


def _both(x, params, state, train, rows, sample, dtype):
    jx = jnp.asarray(x).astype(dtype)
    jmask = jax_norm.bn_sample_mask(jx, None if sample is None else jnp.asarray(sample),
                                    None if rows is None else jnp.asarray(rows))
    ref, ref_state = jax_norm.batch_norm(
        jx, {k: jnp.asarray(v) for k, v in params.items()},
        jax_norm.BNState(jnp.asarray(state[0]), jnp.asarray(state[1])), train=train, mask=jmask)
    tdt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[dtype]
    tx = torch.from_numpy(x).to(tdt)
    tmask = norm.bn_sample_mask(tx, None if sample is None else torch.from_numpy(sample),
                                None if rows is None else torch.from_numpy(rows))
    ours, our_state = norm.batch_norm(
        tx, {k: torch.from_numpy(v) for k, v in params.items()},
        norm.BNState(torch.from_numpy(state[0]), torch.from_numpy(state[1])), train=train,
        mask=tmask)
    return (ours, our_state), (ref, ref_state)


@pytest.mark.parametrize("mask", ["none", "rows", "sample", "both"])
@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_matches_jax_f32(mask, train):
    x, params, state = _inputs(0)
    rows, sample = _masks(mask, x)
    (ours, st), (ref, rst) = _both(x, params, state, train, rows, sample, jnp.float32)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(st.mean.numpy(), np.asarray(rst.mean), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(st.var.numpy(), np.asarray(rst.var), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mask", ["none", "rows", "both"])
@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_matches_jax_bf16(mask, train):
    """A bf16 x: the batch statistics round to bf16 where JAX rounds them,
    the running update stays f32 and the affine promotes to f32, so the
    output is f32 in both. Tolerance: 1e-6 absolute (measured: equal),
    under the bf16-vs-f32 gap of the same output (~1e-2)."""
    x, params, state = _inputs(1)
    rows, _ = _masks(mask, x)
    sample = None
    (ours, st), (ref, rst) = _both(x, params, state, train, rows, sample, jnp.bfloat16)
    assert ours.dtype == torch.float32 and np.asarray(ref).dtype == np.float32
    (_, _), (ref32, _) = _both(x, params, state, train, rows, sample, jnp.float32)
    err = float(np.abs(ours.numpy() - np.asarray(ref)).max())
    gap = float(np.abs(np.asarray(ref32) - np.asarray(ref)).max())
    assert err <= 1e-6 < gap, (err, gap)
    np.testing.assert_allclose(st.mean.numpy(), np.asarray(rst.mean), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(st.var.numpy(), np.asarray(rst.var), rtol=RTOL, atol=ATOL)


def test_padded_rows_stay_out_of_the_statistics():
    """With the row mask, the batch statistics equal those of the real rows
    alone (the ragged zones of the reference), whatever the padded rows hold."""
    x, params, state = _inputs(2)
    rows, _ = _masks("rows", x)
    tx = torch.from_numpy(x)
    noisy = torch.where(torch.from_numpy(rows).bool(), tx, tx + 100.0)
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    s = norm.BNState(torch.from_numpy(state[0]), torch.from_numpy(state[1]))
    mask = torch.from_numpy(rows)
    y1, s1 = norm.batch_norm(tx, p, s, train=True, mask=mask)
    y2, s2 = norm.batch_norm(noisy, p, s, train=True, mask=mask)
    np.testing.assert_allclose(s1.mean.numpy(), s2.mean.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s1.var.numpy(), s2.var.numpy(), rtol=1e-5, atol=1e-5)
    real = mask.expand_as(tx).bool()
    np.testing.assert_allclose(y1[real].numpy(), y2[real].numpy(), rtol=1e-5, atol=1e-5)
    for f in range(x.shape[1]):  # one feature: mean and biased var over its real rows
        vals = x[:, f][:, rows[0, f, :, 0] > 0]
        new_mean = 0.9 * state[0][f] + 0.1 * vals.mean()
        np.testing.assert_allclose(s1.mean[f].item(), new_mean, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_models", [None, 2])
def test_stacked_module_matches_jax_vmap(n_models):
    """``StackedBatchNorm(Z, F)`` on a ``(B, M*Z*F, C, T)`` activation with
    the zone row mask equals JAX ``batch_norm`` vmapped over models and
    zones, outputs and buffers, in train then eval mode."""
    m, z, f, c, t, b = (n_models or 1), 3, 2, 4, 7, 5
    rng = np.random.default_rng(3)
    x = rng.normal(size=(b, m, z, f, c, t)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, (m, z, f)).astype(np.float32)
    bias = rng.normal(size=(m, z, f)).astype(np.float32)

    def one(xz, sc, bi, mz, train, st):  # x (B, F, C, T), mask (C,)
        return jax_norm.batch_norm(xz, {"scale": sc, "bias": bi}, st, train=train,
                                   mask=mz[None, None, :, None])

    mod = norm.StackedBatchNorm(z, f, n_models=n_models)
    with torch.no_grad():
        mod.scale.copy_(torch.from_numpy(scale if n_models else scale[0]))
        mod.bias.copy_(torch.from_numpy(bias if n_models else bias[0]))
    rows = torch.from_numpy(ZONE_MASK)[None, :, None, :].expand(m, z, f, c).reshape(1, -1, c, 1)
    state = jax_norm.BNState(jnp.zeros((m, z, f)), jnp.ones((m, z, f)))
    for train in (True, False):
        fn = jax.vmap(jax.vmap(lambda xz, sc, bi, mz, st: one(xz, sc, bi, mz, train, st),
                               in_axes=(1, 0, 0, 0, 0), out_axes=(1, 0)),
                      in_axes=(1, 0, 0, None, 0), out_axes=(1, 0))
        ref, state = fn(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                        jnp.asarray(ZONE_MASK), state)
        mod.train(train)
        ours = mod(torch.from_numpy(x.reshape(b, m * z * f, c, t)), rows)
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref).reshape(ours.shape),
                                   rtol=RTOL, atol=ATOL)
        lead = (lambda a: a) if n_models else (lambda a: a[0])
        np.testing.assert_allclose(mod.mean.numpy(), lead(np.asarray(state.mean)), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(mod.var.numpy(), lead(np.asarray(state.var)), rtol=RTOL,
                                   atol=ATOL)


def test_bn_init_matches_jax():
    params, state = norm.bn_init(5)
    jparams, jstate = jax_norm.bn_init(5)
    for k in ("scale", "bias"):
        np.testing.assert_array_equal(params[k].numpy(), np.asarray(jparams[k]))
    assert norm.BNState._fields == jax_norm.BNState._fields
    np.testing.assert_array_equal(state.mean.numpy(), np.asarray(jstate.mean))
    np.testing.assert_array_equal(state.var.numpy(), np.asarray(jstate.var))
