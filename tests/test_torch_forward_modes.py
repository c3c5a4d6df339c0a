"""FAST's forward modes and dense tokenization against the JAX package on
the CPU: ``train_head`` and ``train_transformer`` (``fast_apply(
forward_mode=...)``), bound by ``make_fast_model(cfg, forward_mode)`` or
named in the call, with the Conv4Layers head and a batch-norm head
(CVBlock, whose statistics still move under ``train_transformer``); one
stacked-engine step in each mode against ``jax.grad`` and
``optax.adamw``, where the parameters the mode leaves without a gradient
are decayed as optax decays them; ``forward_head(step_override)`` and
``batched_forward_head`` against ``fast_forward_head`` and
``fast_batched_forward_head``. Tolerances: rtol 1e-4 / atol 1e-5, a
decayed parameter at rtol 1e-6 of ``p - lr * wd * p``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import imagined_speech_decoding_tpu.config as jax_config
from imagined_speech_decoding_tpu.models import heads as jax_heads
from imagined_speech_decoding_tpu.models.fast import (
    fast_apply,
    fast_batched_forward_head,
    fast_forward_head,
    fast_init,
)
from imagined_speech_decoding_tpu.train.metrics import cross_entropy as jax_cross_entropy
from imagined_speech_decoding_tpu_torch import config, transplant
from imagined_speech_decoding_tpu_torch.models import heads
from imagined_speech_decoding_tpu_torch.models.api import make_fast_model
from imagined_speech_decoding_tpu_torch.models.fast import FAST
from imagined_speech_decoding_tpu_torch.train import engine

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5  # tests/test_torch_parity.py
DECAY_RTOL = 1e-6
MODES = ["default", "train_head", "train_transformer"]
HEADS = ["Conv4Layers", "CVBlock"]
SMALL = dict(  # zones of 3, 2, 4 and 1 channels
    electrodes=tuple(f"E{i}" for i in range(10)),
    zone_dict={"A": ("E0", "E1", "E2"), "B": ("E3", "E4"), "C": ("E5", "E6", "E7", "E8"),
               "D": ("E9",)},
    dim_cnn=8, dim_token=16, seq_len=200, window_len=100, slide_step=50,
    n_classes=5, num_layers=1, num_heads=4, dropout=0.0,
)


@pytest.fixture(autouse=True)
def _no_head_dropout(monkeypatch):
    """CVBlock's fixed head dropout off in both packages (JAX: ``rng=None``
    would do it in eval only)."""
    enc = jax_heads.HEAD_REGISTRY["CVBlock"]
    monkeypatch.setitem(jax_heads.HEAD_REGISTRY, "CVBlock",
                        enc._replace(apply=functools.partial(enc.apply, dropout_rate=0.0)))
    monkeypatch.setattr(heads.CVBlockHead, "DROPOUT", 0.0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _setup(head, seed=0, b=4):
    jcfg = jax_config.FASTConfig(**SMALL, head=head)
    cfg = config.FASTConfig(**SMALL, head=head)
    params, state = fast_init(jax.random.PRNGKey(seed), jcfg)
    x = np.random.default_rng(seed + 1).normal(size=(b, 10, 200)).astype(np.float32)
    return jcfg, cfg, params, state, x


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("head", HEADS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_logits_and_state_match_fast_apply(head, mode, train):
    """Logits of each mode, bound through ``make_fast_model`` (the engine's
    way), and in training mode the new batch-norm state."""
    jcfg, cfg, params, state, x = _setup(head)
    ref, new_state = fast_apply(params, state, jnp.asarray(x), jcfg, forward_mode=mode,
                                train=train)
    mdef = make_fast_model(cfg, forward_mode=mode)
    model = mdef.build()
    mdef.load(model, _np(params), _np(state))
    model.train(train)
    with torch.no_grad():
        ours = model(torch.from_numpy(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    got = _leaves(transplant.to_jax_state(model.state_dict()))
    want = _leaves(_np(new_state))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)


def test_the_mode_named_in_the_call_wins_and_an_unknown_mode_raises():
    _, cfg, params, state, x = _setup("Conv4Layers")
    bound = FAST(cfg, forward_mode="train_head").eval()
    plain = FAST(cfg).eval()
    for m in (bound, plain):
        m.load_state_dict(transplant.from_jax_params(_np(params)))
    with torch.no_grad():
        assert torch.equal(bound(torch.from_numpy(x)),
                           plain(torch.from_numpy(x), forward_mode="train_head"))
        assert torch.equal(bound(torch.from_numpy(x), forward_mode="default"),
                           plain(torch.from_numpy(x)))
    with pytest.raises(NotImplementedError, match="unknown forward_mode"):
        make_fast_model(cfg, forward_mode="train_trunk")
    with pytest.raises(NotImplementedError, match="unknown forward_mode"):
        FAST(cfg, forward_mode="train_trunk")


@pytest.mark.parametrize("head", HEADS)
@pytest.mark.parametrize("mode", MODES)
def test_one_engine_step_matches_optax(head, mode):
    """One ``engine.train_step`` of a one-model stack in each mode against
    ``jax.grad`` of the same loss and ``optax.adamw``: the gradients where
    JAX's are not 0, the parameters after the step where the gradient is
    clear of rounding noise (a first AdamW step is lr * sign(g)), and every
    leaf that the mode leaves without a gradient (the head under
    ``train_transformer``; the transformer blocks, the CLS token and the
    positional table under ``train_head``) decayed to ``p - lr * wd * p``,
    its AdamW moments 0."""
    lr, wd = 1e-3, 0.01
    jcfg, cfg, params, state, x = _setup(head, b=6)
    y = np.random.default_rng(3).integers(0, 5, 6)

    def loss(p):
        logits, _ = fast_apply(p, state, jnp.asarray(x), jcfg, forward_mode=mode, train=True)
        return jax_cross_entropy(logits, jnp.asarray(y), jnp.ones(6))

    g = jax.grad(loss)(params)
    tx = optax.adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=wd)
    upd, _ = tx.update(g, tx.init(params), params)
    ref = optax.apply_updates(params, upd)

    mdef = make_fast_model(cfg, forward_mode=mode)
    model = mdef.build(1)
    mdef.load(model, jax.tree.map(lambda a: np.asarray(a)[None], params),
              jax.tree.map(lambda a: np.asarray(a)[None], state))
    model.train()
    opt = engine.make_optimizer(model.parameters(), wd)
    engine.train_step(model, opt, torch.from_numpy(x)[None], torch.from_numpy(y)[None], lr, 5,
                      torch.Generator())
    ours, _ = mdef.dump(model.state_dict())
    grads, _ = mdef.dump({k: p.grad for k, p in model.named_parameters()})
    p0, gj, refl = _leaves(_np(params)), _leaves(_np(g)), _leaves(_np(ref))
    got, gp = _leaves(ours), _leaves(grads)
    assert got.keys() == refl.keys()
    frozen = [k for k in gj if not gj[k].any()]
    if mode == "default":
        assert not frozen
    else:
        part = "['head']" if mode == "train_transformer" else "['blocks']"
        assert frozen and any(k.startswith(part) for k in frozen)
    for k in refl:
        if k in frozen:
            assert not gp[k][0].any(), k
            np.testing.assert_allclose(got[k][0], p0[k] - lr * wd * p0[k], rtol=DECAY_RTOL,
                                       atol=0, err_msg=k)
            np.testing.assert_allclose(refl[k], p0[k] - lr * wd * p0[k], rtol=DECAY_RTOL,
                                       atol=0, err_msg=k)
            nz = p0[k] != 0  # decayed, not skipped (a zero bias stays 0)
            assert (got[k][0][nz] != p0[k][nz]).all(), k
            continue
        np.testing.assert_allclose(gp[k][0], gj[k], rtol=RTOL, atol=ATOL, err_msg=k)
        sure = np.abs(gj[k]) > 1e-6
        np.testing.assert_allclose(got[k][0][sure], refl[k][sure], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    named = dict(model.named_parameters())
    for k, p in named.items():
        if p.grad is not None and not p.grad.any():
            st = opt.state[p]
            assert not st["exp_avg"].any() and not st["exp_avg_sq"].any(), k


@pytest.mark.parametrize("head", HEADS)
@pytest.mark.parametrize("step", [25, 50, 10])
def test_forward_head_step_override_matches_jax(head, step):
    """Dense tokens: ``forward_head(x, step_override)`` against
    ``fast_forward_head(step_override=...)``, unstacked and in a stack of
    two models, N = (T - W) // step + 1 windows."""
    jcfg, cfg, params, state, x = _setup(head)
    ref, _ = fast_forward_head(params, state, jnp.asarray(x), jcfg, step_override=step)
    model = FAST(cfg).eval()
    model.load_state_dict(transplant.from_jax_params(_np(params), _np(state)))
    with torch.no_grad():
        ours = model.forward_head(torch.from_numpy(x), step_override=step)
    assert ours.shape == (x.shape[0], (200 - 100) // step + 1, 4, 8)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    stack = FAST(cfg, n_models=2).eval()
    stack.load_state_dict(transplant.from_jax_params(
        jax.tree.map(lambda a: np.stack([np.asarray(a)] * 2), params),
        jax.tree.map(lambda a: np.stack([np.asarray(a)] * 2), state)))
    with torch.no_grad():
        both = stack.forward_head(torch.from_numpy(np.stack([x, x])), step_override=step)
    np.testing.assert_allclose(both[1].numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("head", HEADS)
@pytest.mark.parametrize("b,micro", [(8, 4), (6, 4), (8, 8)], ids=["chunks", "ragged", "one"])
def test_batched_forward_head_matches_jax(head, b, micro):
    """``batched_forward_head(x, step, micro_batch)`` against
    ``fast_batched_forward_head`` (a batch that is not a multiple of the
    micro-batch runs as one chunk), equal to one ``forward_head`` call in
    eval mode bit for bit, and it leaves the module's training mode and
    running statistics as they were."""
    jcfg, cfg, params, state, x = _setup(head, b=b)
    ref = fast_batched_forward_head(params, state, jnp.asarray(x), jcfg, step=25,
                                    micro_batch=micro)
    model = FAST(cfg)
    model.load_state_dict(transplant.from_jax_params(_np(params), _np(state)))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model.train()
    ours = model.batched_forward_head(torch.from_numpy(x), step=25, micro_batch=micro)
    assert model.training and not ours.requires_grad
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    with torch.no_grad():
        whole = model.eval().forward_head(torch.from_numpy(x), step_override=25)
    assert torch.equal(ours, whole)
