"""bf16 training, the default precision, in the PyTorch port against the
JAX package in bf16 on the CPU (the port's plain path).

The JAX side runs as its own tests run it: the Pallas head in interpret
mode (``tests/test_pallas_head.py``), the default XLA head
(``conv4layers_fused_all_zones_fullseq``) without. The geometry is small
(10 channels, 4 zones, dim 32, windows of 100) with the kernels' width
O = 32. Every tolerance is stated where it is used, and each test also
measures the bf16-vs-f32 gap of the same quantity (the JAX package in
bf16 against itself in f32) and asserts that the tolerance sits under it,
so a port that ran in f32 would fail.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from imagined_speech_decoding_tpu.config import FASTConfig as JaxFASTConfig
from imagined_speech_decoding_tpu.models import fast as fast_mod
from imagined_speech_decoding_tpu.models.fast import fast_apply, fast_init
from imagined_speech_decoding_tpu.ops.pallas.conv4head import fused_conv4_head as pallas_head
from imagined_speech_decoding_tpu.train.metrics import cross_entropy as jax_cross_entropy
from imagined_speech_decoding_tpu_torch import config
from imagined_speech_decoding_tpu_torch.cli import train_fast
from imagined_speech_decoding_tpu_torch.models import modules
from imagined_speech_decoding_tpu_torch.models.fast import FAST
from imagined_speech_decoding_tpu_torch.models.heads import Conv4LayersHead
from imagined_speech_decoding_tpu_torch.ops.cuda import conv4head
from imagined_speech_decoding_tpu_torch.ops.cuda.conv4head import (
    conv4head_bwd_plain,
    fused_conv4_head,
    fused_conv4_head_plain,
)
from imagined_speech_decoding_tpu_torch.train import engine, metrics
from imagined_speech_decoding_tpu_torch.transplant import from_jax_params, to_jax_params

torch.set_num_threads(1)

SMALL = dict(
    electrodes=tuple(f"E{i}" for i in range(10)),
    zone_dict={"A": ("E0", "E1", "E2"), "B": ("E3", "E4"), "C": ("E5", "E6", "E7", "E8"),
               "D": ("E9",)},
    dim_cnn=32, dim_token=32, seq_len=200, window_len=100, slide_step=50, head="Conv4Layers",
    n_classes=5, num_layers=2, num_heads=8, dropout=0.0,
)
GEO = (SMALL["window_len"], SMALL["slide_step"])
BF16 = jnp.bfloat16


def l2(a, ref) -> float:
    """Relative L2 error ``|a - ref| / |ref|``."""
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(a - ref) / np.linalg.norm(ref))


def rel_max(a, ref) -> float:
    """``max|a - ref| / max|ref|``."""
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def _with_pallas(fn):
    """``fn()`` with the JAX FAST model on its Pallas head, in interpret mode."""
    with pltpu.force_tpu_interpret_mode():
        fast_mod.PALLAS_HEAD = True
        try:
            return fn()
        finally:
            fast_mod.PALLAS_HEAD = None


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxFASTConfig(**SMALL)
    params, state = fast_init(jax.random.PRNGKey(0), jcfg)
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 10, 200)).astype(np.float32)
    y = rng.integers(0, 5, 8)
    return jcfg, params, state, x, y


def _model(params, n_models=None):
    model = FAST(config.FASTConfig(**SMALL), n_models=n_models)
    sd = from_jax_params(params)
    model.load_state_dict(sd if n_models is None else
                          {k: v.expand(n_models, *v.shape).clone() for k, v in sd.items()})
    return model


@pytest.fixture(scope="module")
def head(setup):
    """The head's operands (one model, f32), a cotangent, and the Pallas
    head's features and ``jax.grad`` (its custom VJP) in bf16 and f32."""
    _, params, _, x, _ = setup
    with torch.no_grad():
        ops = tuple(t[0] for t in _model(params).head.fused_weights())
    jops = [jnp.asarray(t.numpy()) for t in ops]
    g = np.random.default_rng(1).normal(size=(8, 3, 4 * 32)).astype(np.float32)

    def loss(xx, *w):
        return jnp.sum(pallas_head(xx, *w, *GEO) * g)

    ref = {}
    with pltpu.force_tpu_interpret_mode():
        for name, dt in (("bf16", BF16), ("f32", jnp.float32)):
            xx = jnp.asarray(x, dt)
            ref[name] = (np.asarray(pallas_head(xx, *jops, *GEO)),
                         [np.asarray(t, np.float32)
                          for t in jax.grad(loss, argnums=(0, 1, 2, 3, 4))(xx, *jops)])
    return ops, g, ref


class TestHead:
    def test_forward_matches_pallas(self, setup, head):
        """The plain bf16 head against the Pallas kernel in bf16: the same
        rounding points, f32 sums in another order. Tolerance 2e-5
        absolute on features of max ~0.07 (measured: 1.4e-6), under the
        bf16-vs-f32 gap of the Pallas kernel's own features (~2e-4)."""
        x = setup[3]
        ops, _, ref = head
        ours = fused_conv4_head_plain(torch.from_numpy(x).to(torch.bfloat16), *ops, *GEO)
        assert ours.dtype == torch.float32 and ours.shape == ref["bf16"][0].shape
        err = float(np.abs(ours.numpy() - ref["bf16"][0]).max())
        gap = float(np.abs(ref["f32"][0] - ref["bf16"][0]).max())
        assert err <= 2e-5 < gap / 5, (err, gap)

    def test_gradients_match_pallas_vjp(self, setup, head):
        """The written-out plain bf16 backward against ``jax.grad`` through
        the Pallas custom VJP in bf16. Weight gradients: max|err| / max|ref|
        per tensor at most 1.5e-3 for dw12 (measured 4.0e-4: bf16(dh1)
        flips one ulp where the f32 sums of dp3 round near a boundary) and
        5e-4 for db12, dw3, dw4 (measured <= 8.5e-5); dx (bf16, both sides)
        1e-3 in relative L2 (measured 3.2e-4; 0.8% of its elements one
        bf16 ulp apart). Each under the same tensor's bf16-vs-f32 gap
        (1.6e-3 to 3.9e-3; dx 4.8e-3 in L2), asserted."""
        x = setup[3]
        ops, g, ref = head
        xb = torch.from_numpy(x).to(torch.bfloat16)
        ours = conv4head_bwd_plain(torch.from_numpy(g)[None], xb[None], *(t[None] for t in ops),
                                   *GEO)
        assert ours[0].dtype == torch.bfloat16
        assert all(t.dtype == torch.float32 for t in ours[1:])
        tols = {"dw12": 1.5e-3, "db12": 5e-4, "dw3": 5e-4, "dw4": 5e-4}
        for i, name in enumerate(("dx", "dw12", "db12", "dw3", "dw4")):
            got = ours[i][0].float().numpy().reshape(ref["bf16"][1][i].shape)
            r16, r32 = ref["bf16"][1][i], ref["f32"][1][i]
            measure = l2 if name == "dx" else rel_max
            tol = 1e-3 if name == "dx" else tols[name]
            err, gap = measure(got, r16), measure(r32, r16)
            assert err <= tol < gap, (name, err, tol, gap)

    def test_cpu_route_is_plain_and_uncounted(self, setup, head):
        x = torch.from_numpy(setup[3]).to(torch.bfloat16)
        ops = head[0]
        before = (fused_conv4_head.launches, fused_conv4_head.launches_bf16)
        out = fused_conv4_head(x, *ops, *GEO)
        assert (fused_conv4_head.launches, fused_conv4_head.launches_bf16) == before
        assert torch.equal(out, fused_conv4_head_plain(x, *ops, *GEO))

    def test_non_cpu_tensor_never_falls_back(self, setup, head):
        ops = [t.to("meta") for t in head[0]]
        x = torch.zeros(setup[3].shape, dtype=torch.bfloat16, device="meta")
        with pytest.raises(ValueError, match="CUDA tensor"):
            fused_conv4_head(x, *ops, *GEO)


class TestFast:
    def test_logits_match_pallas_head(self, setup):
        """FAST in bf16 against ``fast_apply`` on bf16 input with the Pallas
        head: the port rounds where JAX rounds (linear's product before its
        bias, GELU op by op, f32 attention logits), so the logits agree to
        1e-3 absolute (measured: equal), under the gap of ~1e-2 (one bf16
        ulp of a logit near 2 is 7.8e-3)."""
        jcfg, params, state, x, _ = setup
        with torch.no_grad():
            ours = _model(params).eval()(torch.from_numpy(x).to(torch.bfloat16))
        assert ours.dtype == torch.bfloat16
        ref = {name: np.asarray(_with_pallas(lambda dt=dt: fast_apply(
            params, state, jnp.asarray(x, dt), jcfg, train=False)[0]), np.float32)
            for name, dt in (("bf16", BF16), ("f32", jnp.float32))}
        err = float(np.abs(ours.float().numpy() - ref["bf16"]).max())
        gap = float(np.abs(ref["f32"] - ref["bf16"]).max())
        assert err <= 1e-3 < gap, (err, gap)

    def test_logits_match_xla_head(self, setup):
        """The same against ``fast_apply``'s default XLA head
        (``conv4layers_fused_all_zones_fullseq``), which rounds inside the
        head at other points: a looser bound, 2.5e-3 in relative L2
        (measured 1.5e-3), under the XLA model's own bf16-vs-f32 gap
        (4.0e-3), asserted."""
        jcfg, params, state, x, _ = setup
        with torch.no_grad():
            ours = _model(params).eval()(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
        ref = {name: np.asarray(fast_apply(params, state, jnp.asarray(x, dt), jcfg,
                                           train=False)[0], np.float32)
               for name, dt in (("bf16", BF16), ("f32", jnp.float32))}
        err, gap = l2(ours, ref["bf16"]), l2(ref["f32"], ref["bf16"])
        assert err <= 2.5e-3 < gap, (err, gap)

    def test_training_step_matches_jax(self, setup):
        """One training step (``engine.train_step``) of the port in bf16
        against ``jax.value_and_grad`` of the JAX bf16 loss with the Pallas
        head. The loss within 1e-5 relative (measured: equal; the gap is
        7e-4). The gradients, every parameter together, within 2.5e-3 in
        relative L2 (measured 1.2e-3; the gap 6.3e-3, asserted). Per
        tensor only within 1.5e-2: the backward rounds each op's cotangent
        to bf16 in both frameworks, but XLA sums the bias cotangents in
        bf16 (``reduce_sum`` of a bf16 array) where PyTorch sums in f32,
        and that rounding noise alone is the size of the per-tensor gap
        (5e-3 to 1.9e-2)."""
        jcfg, params, state, x, y = setup

        def loss_of(dt):
            def loss(p):
                logits = fast_apply(p, state, jnp.asarray(x, dt), jcfg, train=True, rng=None)[0]
                return jax_cross_entropy(logits, jnp.asarray(y))
            return _with_pallas(lambda: jax.value_and_grad(loss)(params))

        (l16, g16), (l32, g32) = loss_of(BF16), loss_of(jnp.float32)
        model = _model(params, n_models=1)
        model.train()
        opt = engine.make_optimizer(model.parameters())
        loss_sum, _ = engine.train_step(model, opt, torch.from_numpy(x).to(torch.bfloat16)[None],
                                        torch.from_numpy(y)[None], 0.0, 5)
        loss = float(loss_sum[0]) / len(y)
        assert abs(loss - float(l16)) <= 1e-5 * float(l16) < abs(float(l32) - float(l16))
        ours = to_jax_params({k: p.grad[0] for k, p in model.named_parameters()})
        assert all(p.grad.dtype == torch.float32 for p in model.parameters())
        flat = {name: [np.asarray(v, np.float64).ravel() for v in jax.tree.leaves(t)]
                for name, t in (("ours", ours), ("bf16", g16), ("f32", g32))}
        for a, r, f in zip(flat["ours"], flat["bf16"], flat["f32"]):
            assert l2(a, r) <= 1.5e-2
        cat = {k: np.concatenate(v) for k, v in flat.items()}
        err, gap = l2(cat["ours"], cat["bf16"]), l2(cat["f32"], cat["bf16"])
        assert err <= 2.5e-3 < gap, (err, gap)

    def test_dtype_guard(self, setup):
        """A bf16 input runs the trunk in bf16 over f32 parameters: every
        module's output is bf16 (an uncast f32 parameter would promote the
        rest of the trunk to f32), and the gradients reach the parameters
        as f32."""
        _, params, _, x, y = setup
        model = _model(params, n_models=2)
        seen = []
        trunk = (modules.Linear, modules.LayerNorm, modules.MultiheadSelfAttention,
                 Conv4LayersHead)
        hooks = [m.register_forward_hook(lambda mod, _, out: seen.append((type(mod), out.dtype)))
                 for m in model.modules() if isinstance(m, trunk)]
        xb = torch.from_numpy(np.stack([x, x[::-1].copy()])).to(torch.bfloat16)
        logits = model.train()(xb)
        for h in hooks:
            h.remove()
        assert logits.dtype == torch.bfloat16
        assert {t for t, _ in seen} == set(trunk)
        assert all(dt == torch.bfloat16 for _, dt in seen), seen
        metrics.cross_entropy(logits, torch.from_numpy(np.stack([y, y]))).sum().backward()
        assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
                   for p in model.parameters())


class TestPolicy:
    def test_compute_dtype_is_bf16_by_default(self):
        assert config.TrainConfig().compute_dtype is torch.bfloat16
        with pytest.raises(ValueError, match="unknown precision"):
            config.TrainConfig(precision="fp16").compute_dtype

    def test_cli_trains_in_bf16_by_default(self, tmp_path, monkeypatch):
        """``cli/train_fast.py`` without ``--precision`` trains in bf16: the
        head's plain bf16 route runs, and the history is finite."""
        calls = []
        bf16_forward = conv4head._bf16_forward

        def spy(x, *args):
            calls.append(x.dtype)
            return bf16_forward(x, *args)

        monkeypatch.setattr(conv4head, "_bf16_forward", spy)
        cfg_path = tmp_path / "small.yaml"
        cfg_path.write_text("model:\n  dim_cnn: 8\n  dim_token: 16\n  num_layers: 1\n"
                            "  num_heads: 4\n")
        res = train_fast.main(["--config", str(cfg_path), "--synthetic", "1",
                               "--synthetic_trials", "10", "--epochs", "2", "--batch_size", "8",
                               "--output_dir", str(tmp_path / "out")], device="cpu")
        assert calls and set(calls) == {torch.bfloat16}
        assert all(np.isfinite(v).all() for v in res.fit.history.values())
        assert all(p.dtype == torch.float32 for p in res.fit.params.values())
