"""The port's batch-norm heads (CVBlock, EEGNet_Encoder,
HeadConv_Paper_Version in ``models/heads.py``) and FAST with each,
against the JAX package on the CPU: logits and new batch-norm state in
eval and in train mode (dropout off: JAX ``rng=None``, the port without a
generator), parameter gradients, bf16 logits, the chunked and
checkpointed first block, the transplant of params and state, the
initial draws, one stacked-engine step against ``optax.adamw``, and a
segmented fit resumed bit for bit with the state. The zone layout has
zones of 4, 2, 1 and 4 channels, so padded rows exist."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import imagined_speech_decoding_tpu.config as jax_config
from imagined_speech_decoding_tpu.models import heads as jax_heads
from imagined_speech_decoding_tpu.models.fast import fast_apply, fast_init
from imagined_speech_decoding_tpu.train.metrics import cross_entropy as jax_cross_entropy
from imagined_speech_decoding_tpu_torch import config, transplant
from imagined_speech_decoding_tpu_torch.models import heads
from imagined_speech_decoding_tpu_torch.models.fast import FAST
from imagined_speech_decoding_tpu_torch.train import engine

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5  # tests/test_torch_parity.py
HEADS = ["CVBlock", "EEGNet_Encoder", "HeadConv_Paper_Version"]
SMALL = dict(
    electrodes=("C1", "C2", "C3", "C4", "P1", "P2", "O1", "O2", "F1", "F2", "Fz"),
    zone_dict={"Central": ("C1", "C2", "C3", "C4"), "Parietal": ("P1", "P2"),
               "Occipital": ("O1",), "Frontal": ("F1", "F2", "Fz", "O2")},
    dim_cnn=12, dim_token=16, seq_len=250, window_len=100, slide_step=50,
    num_layers=1, num_heads=4, dropout=0.0,
)


def _cfgs(head, **kw):
    kw = dict(SMALL, head=head, **kw)
    return jax_config.FASTConfig(**kw), config.FASTConfig(**kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_model(head, seed=0, **kw):
    jcfg, cfg = _cfgs(head, **kw)
    params, state = fast_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, params, state


def _port(cfg, params, state, n_models=None):
    model = FAST(cfg, n_models=n_models)
    model.load_state_dict(transplant.from_jax_params(_np(params), _np(state)))
    return model


def _x(jcfg, b=5, seed=1):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, jcfg.n_channels, jcfg.seq_len)).astype(np.float32)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_state(module, ref_state):
    ours = _leaves(transplant.to_jax_state(module.state_dict()))
    ref = _leaves(_np(ref_state))
    assert ours.keys() == ref.keys() and ours
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("head", HEADS)
def test_fast_forward_and_state_match_jax(head, train):
    jcfg, cfg, params, state = _jax_model(head)
    x = _x(jcfg)
    ref, ref_state = fast_apply(params, state, jnp.asarray(x), jcfg, train=train)
    model = _port(cfg, params, state).train(train)
    with torch.no_grad():
        ours = model(torch.from_numpy(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    _assert_state(model, ref_state)


@pytest.mark.parametrize("chunk", [1 << 28, 3000], ids=["one_chunk", "chunked"])
@pytest.mark.parametrize("head", HEADS)
def test_gradients_match_jax(head, chunk, monkeypatch):
    """Parameter gradients of the train-mode logits, the first block in one
    chunk or in several checkpointed chunks, against ``jax.grad``; the
    running statistics are written once either way."""
    monkeypatch.setattr(heads.ZoneHead, "CHUNK_ELEMS", chunk)
    jcfg, cfg, params, state = _jax_model(head, seed=2)
    x = _x(jcfg, seed=3)

    def loss(p):
        logits, new_state = fast_apply(p, state, jnp.asarray(x), jcfg, train=True)
        return jnp.sum(logits ** 2), new_state

    (_, ref_state), grads = jax.value_and_grad(loss, has_aux=True)(params)
    model = _port(cfg, params, state).train()
    (model(torch.from_numpy(x)) ** 2).sum().backward()
    ours = _leaves(transplant.to_jax_params({k: p.grad for k, p in model.named_parameters()}))
    ref = _leaves(grads)
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=RTOL, atol=ATOL, err_msg=k)
    _assert_state(model, ref_state)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("head", HEADS)
def test_bf16_logits_and_state_match_jax(head, train):
    """bf16 input, the JAX package's bf16-mixed policy: the first conv and
    the first batch statistics in bf16, every layer after the first
    batch norm in f32 (its affine promotes to the f32 parameters), so the
    logits come out f32 in both. Tolerance: 1e-5 absolute (measured <=
    5e-7), under the logits' bf16-vs-f32 gap (>= 7e-7 eval, ~1e-4 train)."""
    jcfg, cfg, params, state = _jax_model(head, seed=4)
    x = _x(jcfg, seed=5) * 3.0
    ref, ref_state = fast_apply(params, state, jnp.asarray(x, jnp.bfloat16), jcfg, train=train)
    ref32, _ = fast_apply(params, state, jnp.asarray(x), jcfg, train=train)
    model = _port(cfg, params, state).train(train)
    with torch.no_grad():
        ours = model(torch.from_numpy(x).to(torch.bfloat16))
    assert ours.dtype == torch.float32 and np.asarray(ref).dtype == np.float32
    err = float(np.abs(ours.numpy() - np.asarray(ref)).max())
    gap = float(np.abs(np.asarray(ref32) - np.asarray(ref)).max())
    assert err <= 1e-5 and err < gap, (err, gap)
    _assert_state(model, ref_state)


@pytest.mark.parametrize("head", HEADS)
def test_transplant_round_trip_and_init_layout(head):
    """params + state -> state_dict -> params + state is bit-exact, stacked
    or not, and ``transplant.init_jax_layout`` draws JAX ``fast_init``'s
    tree: the same keys and shapes, BN ones / zeros and ``BNState(0, 1)``."""
    jcfg, cfg, params, state = _jax_model(head)
    sd = transplant.from_jax_params(_np(params), _np(state))
    back_p, back_s = transplant.to_jax_params(sd), transplant.to_jax_state(sd)
    for got, want in ((back_p, params), (back_s, state)):
        a, b = _leaves(got), _leaves(_np(want))
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    ours_p, ours_s = transplant.init_jax_layout(cfg, 7)
    for got, want in ((ours_p, params), (ours_s, state)):
        a, b = _leaves(got), _leaves(_np(want))
        assert a.keys() == b.keys()
        for k in b:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
    for name, bn in ours_s["head"].items():
        np.testing.assert_array_equal(bn.mean, 0.0)
        np.testing.assert_array_equal(bn.var, 1.0)
        np.testing.assert_array_equal(ours_p["head"][name]["scale"], 1.0)
    for path, leaf in _leaves(ours_p["head"]).items():
        if path.endswith("['w']") and "projector" not in path:  # conv: U(+-1/sqrt(fan_in))
            fan = int(np.prod(leaf.shape[2:]))
            assert np.abs(leaf).max() <= 1.0 / np.sqrt(fan)
    stacked_p, stacked_s = transplant.init_jax_layout(cfg, 7, 3)
    model = FAST(cfg, n_models=3)
    model.load_state_dict(transplant.from_jax_params(stacked_p, stacked_s))
    bn1 = "norm1" if head == "HeadConv_Paper_Version" else "bn1"
    assert getattr(model.head, bn1).mean.shape[:2] == (3, 4)  # (models, zones, features)
    np.testing.assert_array_equal(transplant.to_jax_params(model.state_dict())["head"]
                                  [next(iter(stacked_p["head"]))]["w"][0],
                                  ours_p["head"][next(iter(ours_p["head"]))]["w"])


def test_registry_matches_jax():
    assert sorted(heads.HEAD_REGISTRY) == sorted(jax_heads.HEAD_REGISTRY)
    with pytest.raises(KeyError, match="unknown head"):
        heads.get_head("NoSuchHead")


@pytest.mark.parametrize("head", HEADS)
def test_stacked_engine_step_matches_jax(head):
    """One ``engine.train_step`` of a stack of two models on fixed batches
    against ``jax.value_and_grad`` of JAX's loss and one ``optax.adamw``
    step per model: the gradients, the batch-norm state and the parameters
    after the step. A first AdamW step moves a parameter by about
    ``lr * sign(g)``, so where JAX's gradient is rounding noise (|g| <=
    1e-6: the attention key bias, a bias in front of a batch norm) its
    sign, and the parameter, are not compared."""
    m, lr = 2, 1e-3
    jcfg, cfg, _, _ = _jax_model(head)
    keys = jax.random.split(jax.random.PRNGKey(8), m)
    inits = [fast_init(k, jcfg) for k in keys]
    x = np.stack([_x(jcfg, b=4, seed=10 + i) for i in range(m)])
    y = np.random.default_rng(12).integers(0, 5, (m, 4))
    tx = optax.adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
    ref_params, ref_states, ref_grads = [], [], []
    for i, (p, s) in enumerate(inits):
        def loss(pp):
            logits, ns = fast_apply(pp, s, jnp.asarray(x[i]), jcfg, train=True)
            return jax_cross_entropy(logits, jnp.asarray(y[i]), jnp.ones(4)), ns

        (_, ns), g = jax.value_and_grad(loss, has_aux=True)(p)
        upd, _ = tx.update(g, tx.init(p), p)
        ref_params.append(optax.apply_updates(p, upd))
        ref_states.append(ns)
        ref_grads.append(g)
    stacked_p = transplant.stack_trees([_np(p) for p, _ in inits])
    stacked_s = transplant.stack_trees([_np(s) for _, s in inits])
    model = _port(cfg, stacked_p, stacked_s, n_models=m).train()
    opt = engine.make_optimizer(model.parameters(), 0.01)
    engine.train_step(model, opt, torch.from_numpy(x), torch.from_numpy(y), lr, 5)
    sd = model.state_dict()
    grads = transplant.to_jax_params({k: p.grad for k, p in model.named_parameters()})
    for i in range(m):
        def row(tree):
            return _leaves(jax.tree.map(lambda a: a[i], tree))

        ours_g, ref_g = row(grads), _leaves(ref_grads[i])
        for ours, ref in ((ours_g, ref_g), (row(transplant.to_jax_state(sd)),
                                            _leaves(ref_states[i]))):
            assert ours.keys() == ref.keys()
            for k in ref:
                np.testing.assert_allclose(ours[k], ref[k], rtol=RTOL, atol=ATOL, err_msg=k)
        ours_p, ref_p = row(transplant.to_jax_params(sd)), _leaves(ref_params[i])
        for k in ref_p:
            sure = np.abs(ref_g[k]) > 1e-6
            np.testing.assert_allclose(ours_p[k][sure], ref_p[k][sure], rtol=RTOL, atol=ATOL,
                                       err_msg=k)


class Crash(Exception):
    pass


def _fit(head, crash_at=None, **kw):
    """A fresh CVBlock / HeadConv stack of 3 with dropout on, as a new
    process would make it, fitted in segments of 2 of 4 epochs."""
    _, cfg = _cfgs(head, dropout=0.1)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(20, 11, 250)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 5, 20))
    perms = np.stack([rng.permutation(20) for _ in range(3)])
    model = FAST(cfg, n_models=3)
    model.load_state_dict(transplant.from_jax_params(*transplant.init_jax_layout(cfg, 1, 3)))
    fit = engine.make_fit(model, 5, epochs=2, batch_size=6, n_train=14, n_val=6,
                          learning_rate=1e-3, warmup_epochs=1, total_epochs=4)

    def progress(epoch, val_acc):
        if epoch == crash_at:
            raise Crash(epoch)

    return engine.fit_segmented(fit, perms[:, :14], perms[:, 14:], x, y, seed=2,
                                progress=progress, **kw)


@pytest.mark.parametrize("head", ["CVBlock", "HeadConv_Paper_Version"])
def test_resume_is_bit_exact_with_state(head, tmp_path):
    """A fit that crashes in its second segment and resumes from the
    segment checkpoint ends as the uninterrupted one, bit for bit: the
    parameters, the running statistics and the best snapshot's, which
    the carry holds (``carry.buffers``, ``carry.best_buffers``)."""
    ref = _fit(head)
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(Crash):
        _fit(head, crash_at=3, checkpoint_dir=ckpt)
    with np.load(os.path.join(ckpt, "segment_carry.npz")) as f:
        assert "carry.buffers.head.bn1.mean" in f.files or "carry.buffers.head.norm1.mean" in f.files
        assert any(k.startswith("carry.best_buffers.head.") for k in f.files)
    resumed = _fit(head, checkpoint_dir=ckpt, resume=True)
    assert ref.model_state and ref.best_model_state
    for a, b in ((resumed.params, ref.params), (resumed.model_state, ref.model_state),
                 (resumed.best_params, ref.best_params),
                 (resumed.best_model_state, ref.best_model_state)):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for k in ref.history:
        np.testing.assert_array_equal(resumed.history[k], ref.history[k])
    bn1 = "head.norm1.mean" if head == "HeadConv_Paper_Version" else "head.bn1.mean"
    assert ref.model_state[bn1].abs().max() > 0  # the statistics moved from their init


@pytest.mark.parametrize("head", ["CVBlock", "HeadConv_Paper_Version"])
def test_sweep_and_loso_refuse_batch_norm_heads(head, tmp_path):
    """The sweep's tiled rows and the LOSO stack carry no model state yet:
    both raise ``NotImplementedError`` naming ROADMAP.md for a batch-norm
    head, before they touch a device."""
    from imagined_speech_decoding_tpu_torch.train import loso, sweep

    _, cfg = _cfgs(head)
    x = np.zeros((2, 10, 11, 250), np.float32)
    y = np.zeros((2, 10), np.int64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sweep.cv_sweep(cfg, 5, x[0], y[0], n_trials=10, lr_scales=[1.0], device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        loso.pretrain_loso(cfg, x, y, ["01", "02"], 5, save_dir=str(tmp_path), device="cpu")
