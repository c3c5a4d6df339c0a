"""The port's baseline models (``models/mlp.py``, ``models/eegnet.py``,
``models/rnn.py``) against the JAX package on the CPU, from the same
transplanted weights: logits, new batch-norm state and parameter
gradients in f32, one model and a stack of 2 (one grouped convolution or
batched GEMM over the models, against ``jax.vmap``), bf16 logits, the LSTM
primitives in f32 and bf16, the initial trees' layout and the transplant
round trip. f32 at rtol 1e-4 / atol 1e-5 (tests/test_torch_parity.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagined_speech_decoding_tpu.models import eegnet as jax_eegnet
from imagined_speech_decoding_tpu.models import mlp as jax_mlp
from imagined_speech_decoding_tpu.models import rnn as jax_rnn
from imagined_speech_decoding_tpu.pipelines import PIPELINES as JAX_PIPELINES
from imagined_speech_decoding_tpu_torch import transplant
from imagined_speech_decoding_tpu_torch.models import api
from imagined_speech_decoding_tpu_torch.models import rnn
from imagined_speech_decoding_tpu_torch.models.eegnet import t_out
from imagined_speech_decoding_tpu_torch.pipelines import stft_n_frames

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5  # tests/test_torch_parity.py
C, T, K = 8, 256, 5
FRAMES = stft_n_frames(T)


def _models(dt=jnp.float32):
    """name -> (JAX ModelDef at compute dtype ``dt``, port ModelDef (whose
    compute dtype is the input's), input shape of one trial)."""
    return {
        "mlp": (jax_mlp.make_mlp_model(C * 5, K, compute_dtype=dt), api.make_mlp_model(C * 5, K),
                (C * 5,)),
        "eegnet": (jax_eegnet.make_eegnet_model(C, T, K, compute_dtype=dt),
                   api.make_eegnet_model(C, T, K), (C, T)),
        "stft_eegnet": (JAX_PIPELINES["stft_eegnet"].make_model(C, T, K, dt),
                        api.make_stft_eegnet_model(C, T, K), (5, C, FRAMES)),
        "cnn_bilstm": (jax_rnn.make_cnn_bilstm_model(C, T, K, compute_dtype=dt),
                       api.make_cnn_bilstm_model(C, T, K), (C, T)),
    }


NAMES = ["mlp", "eegnet", "stft_eegnet", "cnn_bilstm"]


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _setup(name, seed=0, m=None, dt=jnp.float32):
    jmodel, mdef, shape = _models(dt)[name]
    if m is None:
        params, state = jmodel.init(jax.random.PRNGKey(seed))
    else:
        params, state = jax.vmap(jmodel.init)(jax.random.split(jax.random.PRNGKey(seed), m))
    module = mdef.build(m)
    mdef.load(module, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state))
    return jmodel, mdef, module, params, state, shape


def _x(shape, b=6, seed=1, lead=()):
    return np.random.default_rng(seed).normal(size=lead + (b,) + shape).astype(np.float32)


def _assert_trees(ours, ref, n=None):
    a, b = _leaves(ours), _leaves(ref)
    assert a.keys() == b.keys() and (n is None or len(b) == n)
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", NAMES)
def test_forward_and_state_match_jax(name, train):
    """One model, f32, without dropout (no rng / generator): logits and the
    new running statistics (train mode) or the unchanged ones (eval)."""
    jmodel, mdef, module, params, state, shape = _setup(name)
    x = _x(shape)
    ref, ref_state = jmodel.apply(params, state, jnp.asarray(x), train=train)
    module.train(train)
    with torch.no_grad():
        ours = module(torch.from_numpy(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    _assert_trees(mdef.dump(module.state_dict())[1], ref_state)


@pytest.mark.parametrize("name", NAMES)
def test_stacked_gradients_and_state_match_jax(name):
    """A stack of 2 against ``jax.vmap`` of JAX's apply, train mode: logits,
    new state and the gradients of a loss summed over the models."""
    jmodel, mdef, module, params, state, shape = _setup(name, seed=2, m=2)
    x = _x(shape, b=5, seed=3, lead=(2,))

    def loss(p):
        logits, ns = jax.vmap(lambda pp, ss, xx: jmodel.apply(pp, ss, xx, train=True))(
            p, state, jnp.asarray(x))
        return jnp.sum(logits ** 2), (logits, ns)

    (_, (ref, ref_state)), grads = jax.value_and_grad(loss, has_aux=True)(params)
    module.train()
    ours = module(torch.from_numpy(x))
    (ours ** 2).sum().backward()
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    got_p, got_s = mdef.dump({**{k: p.grad for k, p in module.named_parameters()},
                              **dict(module.named_buffers())})
    _assert_trees(got_p, grads)
    _assert_trees(got_s, ref_state)


@pytest.mark.parametrize("name", NAMES)
def test_bf16_logits_match_jax(name):
    """bf16 input under the JAX package's bf16-mixed policy (its models built
    at compute dtype bf16), train mode. The MLP runs in bf16 throughout
    (bf16 logits): relative L2 <= 1e-3 (measured 0), under its bf16-vs-f32
    gap. The conv models run their first conv and batch statistics in
    bf16 and everything after the first batch norm in f32 (the affine
    promotes to the f32 parameters): f32 logits, max error <= 1e-5
    (measured <= 1.2e-7), under the bf16-vs-f32 gap (>= 3.5e-4)."""
    jmodel, _, module, params, state, shape = _setup(name, seed=4, dt=jnp.bfloat16)
    jmodel32 = _models()[name][0]
    x = _x(shape, seed=5) * 3.0
    ref, _ = jmodel.apply(params, state, jnp.asarray(x), train=True)
    ref32, _ = jmodel32.apply(params, state, jnp.asarray(x), train=True)
    module.train()
    with torch.no_grad():
        ours = module(torch.from_numpy(x).to(torch.bfloat16))
    ref, ref32 = np.asarray(ref, np.float32), np.asarray(ref32)
    assert (ours.dtype == torch.bfloat16) == (name == "mlp")
    ours = ours.float().numpy()
    if name == "mlp":
        err = np.linalg.norm(ours - ref) / np.linalg.norm(ref)
        gap = np.linalg.norm(ref32 - ref) / np.linalg.norm(ref)
        assert err <= 1e-3 and err < gap, (err, gap)
    else:
        err, gap = np.abs(ours - ref).max(), np.abs(ref32 - ref).max()
        assert err <= 1e-5 and err < gap, (err, gap)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_lstm_primitives_match_jax(dtype):
    """``lstm_cell``, ``lstm_scan`` both ways (the reverse scan's final state
    is the one after step 0) and ``bilstm`` over a stack of 3, against
    ``jax.vmap`` of JAX's; h and c are carried in x's dtype. bf16: every
    gate rounds to bf16 each step in both, and the GEMMs' f32 sums may
    round to neighbouring bf16 values: atol 1e-2, a few bf16 ulps of |h| < 1
    (measured 5.9e-3)."""
    g, b, t, d, h = 3, 4, 7, 6, 5
    keys = jax.random.split(jax.random.PRNGKey(0), g)
    jp = jax.vmap(lambda k: jax_rnn.bilstm_init(k, d, h))(keys)
    xs = _x((t, d), b=b, seed=6, lead=(g,))
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    tol = dict(rtol=RTOL, atol=ATOL) if dtype == torch.float32 else dict(rtol=0, atol=1e-2)
    ours_p = {dn: {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
              for dn, p in jp.items()}
    xt = torch.from_numpy(xs).to(dtype)

    def close(a, r):
        assert a.dtype == dtype
        np.testing.assert_allclose(a.float().numpy(), np.asarray(r, np.float32), **tol)

    h0 = jnp.zeros((g, b, h), jd)
    (rh, rc), _ = jax.vmap(jax_rnn.lstm_cell)(jp["fwd"], (h0 + 0.5, h0 - 0.25),
                                              jnp.asarray(xs[:, :, 0], jd))
    (oh, oc), _ = rnn.lstm_cell(ours_p["fwd"], (torch.full((g, b, h), 0.5, dtype=dtype),
                                                torch.full((g, b, h), -0.25, dtype=dtype)),
                                xt[:, :, 0])
    close(oh, rh)
    close(oc, rc)
    for reverse in (False, True):
        r_out, r_fin = jax.vmap(lambda p, v: jax_rnn.lstm_scan(p, v, reverse=reverse))(
            jp["bwd"], jnp.asarray(xs, jd))
        o_out, o_fin = rnn.lstm_scan(ours_p["bwd"], xt, reverse=reverse)
        close(o_out, r_out)
        close(o_fin, r_fin)
    r_out, r_fin = jax.vmap(jax_rnn.bilstm_apply)(jp, jnp.asarray(xs, jd))
    o_out, o_fin = rnn.bilstm(ours_p, xt)
    close(o_out, r_out)
    close(o_fin, r_fin)
    assert rnn.bilstm(ours_p, xt, outputs=False)[0] is None


@pytest.mark.parametrize("name", NAMES)
def test_init_layout_and_transplant_round_trip(name):
    """``ModelDef.init`` draws JAX's tree (keys and shapes; the LSTM weights
    within U(+-1/sqrt(hidden)), torch's rule); a stacked draw's block is
    the full draw's models; ``load`` then ``dump`` gives the tree back bit
    for bit."""
    jmodel, mdef, *_ = _models()[name]
    ref_p, ref_s = jmodel.init(jax.random.PRNGKey(0))
    ours_p, ours_s = mdef.init(3, None)
    for got, want in ((ours_p, ref_p), (ours_s, ref_s)):
        a, b = _leaves(got), _leaves(want)
        assert a.keys() == b.keys()
        for k in b:
            assert a[k].shape == b[k].shape, k
    if name == "cnn_bilstm":
        assert np.abs(ours_p["rnn"]["fwd"]["wi"]).max() <= 1 / np.sqrt(rnn.HIDDEN)
    block_p, block_s = mdef.init(3, 2, total=4, offset=1)
    full_p, full_s = mdef.init(3, 4)
    for got, want in ((block_p, full_p), (block_s, full_s)):
        a, b = _leaves(got), _leaves(want)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k][1:3], err_msg=k)
    module = mdef.build(4)
    mdef.load(module, full_p, full_s)
    back_p, back_s = mdef.dump(module.state_dict())
    for got, want in ((back_p, full_p), (back_s, full_s)):
        a, b = _leaves(got), _leaves(want)
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_mlp_transplant_transposes_linear_weights():
    """The JAX ``fc{i}.w (d_in, d_out)`` is the stacked ``Linear``'s
    ``fc.{i}.weight`` transposed; biases keep their layout."""
    p, _ = api.make_mlp_model(C * 5, K).init(0, 2)
    sd = transplant.mlp_from_jax(p)
    assert sorted(sd) == [f"fc.{i}.{n}" for i in range(3) for n in ("bias", "weight")]
    np.testing.assert_array_equal(sd["fc.0.weight"].numpy(), np.swapaxes(p["fc0"]["w"], -1, -2))
    assert sd["fc.2.weight"].shape == (2, K, 64)


@pytest.mark.parametrize("n,k,want", [(256, 64, 8), (800, 64, 25), (33, 16, 1), (27, 16, 1),
                                       (26, 16, 0), (27, 15, 0)])
def test_eegnet_t_out_matches_jax(n, k, want):
    """The classifier's input length (JAX ``TestEEGNetOddLengths``): 'same'
    padding adds a sample for an even kernel; too short a trial raises in
    both."""
    if want == 0:
        with pytest.raises(ValueError, match="too short"):
            t_out(n, k)
        with pytest.raises(ValueError, match="too short"):
            jax_eegnet.eegnet_init(jax.random.PRNGKey(0), C, n, temporal_kernel=k)
        return
    assert t_out(n, k) == want
    params, _ = jax_eegnet.eegnet_init(jax.random.PRNGKey(0), C, n, temporal_kernel=k)
    assert params["classifier"]["w"].shape[0] == 16 * want


def test_cnn_bilstm_chunks_the_frontend(monkeypatch):
    """The temporal and spatial convs in chunks of whole models (one model a
    chunk here) give the unchunked logits, gradients and state."""
    _, mdef, module, params, state, shape = _setup("cnn_bilstm", seed=7, m=3)
    x = torch.from_numpy(_x(shape, b=4, seed=8, lead=(3,)))
    runs = []
    for elems in (rnn.CNNBiLSTM.CHUNK_ELEMS, 4 * 32 * C * T):
        monkeypatch.setattr(rnn.CNNBiLSTM, "CHUNK_ELEMS", elems)
        mdef.load(module, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state))
        module.zero_grad()
        module.train()
        out = module(x)
        (out ** 2).sum().backward()
        runs.append((out.detach(), {k: p.grad.clone() for k, p in module.named_parameters()},
                     {k: b.clone() for k, b in module.named_buffers()}))
    (a, ga, sa), (b, gb, sb) = runs
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    for k in ga:
        torch.testing.assert_close(ga[k], gb[k], rtol=1e-5, atol=1e-7, msg=k)
    for k in sa:
        torch.testing.assert_close(sa[k], sb[k], rtol=1e-6, atol=1e-7, msg=k)
