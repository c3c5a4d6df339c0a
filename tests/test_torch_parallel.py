"""The port's multi-rank training (``parallel``: the mesh helpers, the
data-parallel step, the ``model`` / ``data`` / ``2d`` strategies through
the engine, the campaign programs and the CLIs, the dry run) on gloo ranks
on the CPU, against the JAX package's helpers and DP step and against the
port's unsharded runs, at the bounds the JAX package's own checks assert.

The ranks are processes of ``torch_ranks.RankPool`` (2 and 4 of them, one
torch thread each), started once for the module; the unsharded references
run in this process."""

import dataclasses
import functools
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_ranks
from imagined_speech_decoding_tpu.config import FASTConfig as JaxFASTConfig
from imagined_speech_decoding_tpu.models import heads as jax_heads
from imagined_speech_decoding_tpu.models.api import make_fast_model as jax_make_fast_model
from imagined_speech_decoding_tpu.parallel import dp as jax_dp
from imagined_speech_decoding_tpu.parallel import mesh as jax_mesh
from imagined_speech_decoding_tpu.train.metrics import confusion_matrix as jax_confusion
from imagined_speech_decoding_tpu.train.metrics import cross_entropy as jax_cross_entropy
from imagined_speech_decoding_tpu_torch.config import TrainConfig
from imagined_speech_decoding_tpu_torch.data.synthetic import synthetic_trials
from imagined_speech_decoding_tpu_torch.parallel import dryrun, mesh

torch.set_num_threads(1)

# train_per_subject_cv's bounds in the JAX package's checks
# (tests/test_parallel.py): 'data' and '2d', and 'model'
LOSS_TOL = {"data": (1e-3, 1e-5), "2d": (1e-3, 1e-5), "model": (5e-3, 1e-3)}
S, N, K = 2, 15, 3  # subjects x trials, folds: 10 train (a batch of 8 and a tail of 2), 5 val
TC = TrainConfig(max_epochs=3, batch_size=8, warmup_epochs=1, n_folds=K, precision="f32")


@pytest.fixture(scope="module")
def pool2():
    pool = torch_ranks.RankPool(2)
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def pool4():
    pool = torch_ranks.RankPool(4)
    yield pool
    pool.close()


def pool_of(request, world):
    return request.getfixturevalue(f"pool{world}")


def corpus(seed=0, s=S, n=N, cfg=None):
    cfg = cfg or torch_ranks.tiny_config()
    x, y = synthetic_trials(seed, s * n, n_channels=cfg.n_channels, n_samples=cfg.seq_len, snr=3.0)
    return x.reshape(s, n, cfg.n_channels, cfg.seq_len), y.reshape(s, n).astype(np.int32)


def flip_atol(n_val: int) -> float:
    """One validation trial's worth of accuracy."""
    return 1.0 / n_val + 1e-6


def assert_ranks_agree(results):
    """Every rank returns the whole stack's result, the same on each."""
    for r in results[1:]:
        for k, v in r["fit"]["history"].items():
            np.testing.assert_array_equal(v, results[0]["fit"]["history"][k])


# ---------------------------------------------------------------------------
# The mesh helpers against JAX's, on the tier's 8 virtual devices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", ["model", "data", "2d"])
def test_strategy_shape_matches_jax(strategy):
    batch, stack_axis, stack_mesh = jax_mesh.mesh_strategy(strategy)
    jmesh = stack_mesh or (batch.mesh if batch is not None else jax_mesh.make_mesh((stack_axis,)))
    names, shape = mesh.mesh_shape(strategy, len(jax.devices()))
    assert dict(zip(names, shape)) == dict(jmesh.shape)
    assert ("model" in names) == (stack_axis is not None)
    assert ("data" in names) == (batch is not None)


def test_strategy_warning_and_refusal():
    with pytest.warns(UserWarning, match=r"'2d' uses 2 of 3 devices \(shape \(1, 2\)\)"):
        assert mesh.mesh_shape("2d", 3) == (("model", "data"), (1, 2))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert mesh.mesh_shape("2d", 1) == (("model", "data"), (1, 1))
    assert mesh.mesh_strategy(None) == (None, None, None)
    for fn in (mesh.mesh_strategy, jax_mesh.mesh_strategy):
        with pytest.raises(ValueError, match="unknown mesh strategy 'bogus'"):
            fn("bogus")


@pytest.mark.parametrize("m,k", [(5, 4), (5, 2), (8, 4), (3, 8)])
def test_shard_model_stack_matches_jax(m, k):
    """Padding with replicas of the last model, each rank's rows."""
    rng = np.random.default_rng(m * 10 + k)
    tree = {"w": rng.normal(size=(m, 3, 2)).astype(np.float32),
            "idx": np.arange(m * 4).reshape(m, 4)}
    jmesh = jax_mesh.make_mesh(("model",), devices=jax.devices()[:k])
    (jtree,), _, jm = jax_mesh.shard_model_stack("model", m, [tree], mesh=jmesh)
    for rank in range(k):
        shard = mesh.StackShard(mesh.Mesh(("model",), (k,), rank), m, "model")
        ours = shard.rows_of(tree)
        assert shard.m_padded == jm
        for key in tree:
            want = [s.data for s in jtree[key].addressable_shards
                    if s.device == jmesh.devices.reshape(-1)[rank]][0]
            np.testing.assert_array_equal(ours[key], np.asarray(want))


@pytest.mark.parametrize("k", [2, 4, 8])
def test_shard_leading_axis_and_coords_match_jax(k):
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    jmesh = jax_mesh.make_mesh(("data",), devices=jax.devices()[:k])
    jx = jax_mesh.shard_leading_axis(jmesh, jnp.asarray(x))
    for rank in range(k):
        ours = mesh.shard_leading_axis(mesh.Mesh(("data",), (k,), rank), x)
        want = [s.data for s in jx.addressable_shards if s.device == jax.devices()[rank]][0]
        np.testing.assert_array_equal(ours, np.asarray(want))
    grid = jax_mesh.make_mesh(("model", "data"), shape=(k // 2, 2), devices=jax.devices()[:k])
    for rank in range(k):
        pos = np.argwhere(grid.devices == jax.devices()[rank])[0]
        ours = mesh.Mesh(("model", "data"), (k // 2, 2), rank)
        assert (ours.index("model"), ours.index("data")) == tuple(pos)


def test_replicate_and_shard_model_stack_on_ranks(pool4):
    """``replicate`` broadcasts rank 0's tensors; ``shard_model_stack`` keeps
    each rank's rows of the padded stack and replicates the rest."""
    got = pool4.run(torch_ranks.replicate_run)
    stack = np.arange(5 * 3, dtype=np.float32).reshape(5, 3)
    rows = np.concatenate([stack, stack[-1:].repeat(3, 0)])
    for rank, r in enumerate(got):
        np.testing.assert_array_equal(r["replicated"], np.full(4, 0.0))
        np.testing.assert_array_equal(r["rows"], rows[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(r["corpus"], np.zeros(2))
        assert r["m_padded"] == 8


def test_batch_columns_split_evenly():
    parts = [mesh.StackShard(mesh.Mesh(("data",), (4,), r), 3, None, "data") for r in range(4)]
    assert [p.batch_cols(10) for p in parts] == [(0, 3), (3, 6), (6, 8), (8, 10)]
    assert [p.batch_cols(2) for p in parts] == [(0, 1), (1, 2), (2, 2), (2, 2)]
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard_leading_axis(mesh.Mesh(("data",), (4,), 0), np.zeros(6))


# ---------------------------------------------------------------------------
# The data-parallel step against JAX's make_dp_train_step / make_dp_eval_step
# ---------------------------------------------------------------------------

def jax_config(cfg):
    """The JAX package's ``FASTConfig`` of the port's ``cfg``."""
    return JaxFASTConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("world,head", [(2, "Conv4Layers"), (4, "Conv4Layers"), (2, "CVBlock")])
def test_dp_step_matches_jax(world, head, request, monkeypatch):
    """One DP step on a ``world``-device JAX mesh and on ``world`` ranks
    (dropout 0, CVBlock's head dropout off in both, plain SGD, so the
    update is the gradient): the loss within 1e-5 and the parameters as
    tests/test_parallel.py holds JAX's against its unsharded step; the
    batch-norm running statistics (each shard's, averaged over the axis,
    as JAX's pmean) at the same bound; the eval step's sums; and a batch
    whose last rows weigh 0 has exactly the loss of the rows that weigh 1
    (Conv4Layers: a batch-norm head's statistics count every row)."""
    cfg = torch_ranks.tiny_config(dropout=0.0, head=head)
    enc = jax_heads.HEAD_REGISTRY["CVBlock"]
    monkeypatch.setitem(jax_heads.HEAD_REGISTRY, "CVBlock",
                        enc._replace(apply=functools.partial(enc.apply, dropout_rate=0.0)))
    model = jax_make_fast_model(jax_config(cfg))
    params, mstate = model.init(jax.random.PRNGKey(0))
    params_np = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(world)
    x = rng.normal(size=(16, cfg.n_channels, cfg.seq_len)).astype(np.float32)
    y = rng.integers(0, 5, 16).astype(np.int32)
    w = np.ones(16, np.float32)
    jmesh = jax_mesh.make_mesh(("data",), devices=jax.devices()[:world])
    opt = optax.sgd(0.1)
    step = jax_dp.make_dp_train_step(model.apply, opt, cfg.n_classes, jmesh)
    state, metrics = step(jax_dp.DPTrainState(params, mstate, opt.init(params), jnp.int32(0)),
                          x, y, w, jax.random.PRNGKey(0))
    num, den, cm = jax_dp.make_dp_eval_step(model.apply, cfg.n_classes, jmesh)(
        params, mstate, x, y, w)

    pool = pool_of(request, world)
    ours = pool.run(torch_ranks.dp_step_run, cfg, (params_np, jax.tree.map(np.asarray, mstate)),
                    x, y, w, 0.1)
    ref_leaves = jax.tree_util.tree_leaves_with_path((state.params, state.model_state))
    for r in ours:
        assert r["loss"] == pytest.approx(float(metrics["loss"]), rel=1e-5)
        assert r["acc"] == pytest.approx(float(metrics["acc"]), abs=1e-6)
        assert r["step"] == 1
        got = dict(jax.tree_util.tree_leaves_with_path((r["params"], r["state"])))
        for path, b in ref_leaves:
            b = np.asarray(b)
            scale = max(float(np.abs(b).max()), 1e-3)
            np.testing.assert_allclose(got[path], b, rtol=1e-4, atol=1e-5 * scale,
                                       err_msg=str(path))
        e_num, e_den, e_cm = r["eval"]
        assert e_num / e_den == pytest.approx(float(num) / float(den), rel=1e-5)
        np.testing.assert_allclose(e_cm, np.asarray(cm), atol=1e-5)

    if head != "Conv4Layers":
        return
    w_pad = w.copy()
    w_pad[12:] = 0.0
    padded = pool.run(torch_ranks.dp_step_run, cfg, (params_np, None), x, y, w_pad, 0.1)
    logits, _ = model.apply(params, mstate, jnp.asarray(x[:12]), train=True, rng=None)
    loss12 = float(jax_cross_entropy(logits, jnp.asarray(y[:12])))
    assert padded[0]["loss"] == pytest.approx(loss12, rel=1e-5)
    np.testing.assert_allclose(padded[0]["eval"][2],
                               np.asarray(jax_confusion(logits, jnp.asarray(y[:12]), 5)), atol=1e-5)


# ---------------------------------------------------------------------------
# train_per_subject_cv under each strategy against the unsharded run
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cv_reference():
    cfg = torch_ranks.tiny_config()
    X, Y = corpus()
    return cfg, X, Y, torch_ranks.cv_run(cfg, TC, X, Y)


def check_cv(ours, ref, strategy, n_val):
    rtol, atol = LOSS_TOL[strategy]
    for k in ("loss", "val_loss"):
        np.testing.assert_allclose(ours["history"][k], ref["history"][k], rtol=rtol, atol=atol,
                                   err_msg=k)
    np.testing.assert_allclose(ours["best_val_acc"], ref["best_val_acc"], atol=flip_atol(n_val))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("strategy", ["model", "data", "2d"])
def test_cv_strategy_matches_unsharded(strategy, world, cv_reference, request, tmp_path):
    """Dropout on (the unsharded draws, cut to each rank); the ragged tail
    of 2 leaves two of 4 ranks empty under 'data'. Rank 0 alone writes the
    result tree, the unsharded run's."""
    cfg, X, Y, ref = cv_reference
    out = tmp_path / "out"
    ours = pool_of(request, world).run(torch_ranks.cv_run, cfg, TC, X, Y, strategy, str(out))
    assert_ranks_agree(ours)
    check_cv(ours[0]["fit"], ref["fit"], strategy, N // K)
    assert [r["Subject"] for r in ours[0]["summary"]] == ["01", "02"]
    names = sorted(os.path.relpath(os.path.join(d, f), out)
                   for d, _, fs in os.walk(out) for f in fs)
    assert "summary_per_subject.csv" in names and "sub-02/best_subject.npz" in names
    assert all(n.startswith(("sub-", "summary", "global", "checkpoints")) for n in names)


@pytest.mark.parametrize("head,world", [("Conv4Layers", 2), ("CVBlock", 2), ("CVBlock", 4)])
def test_data_axis_empty_rank_and_batch_norm(head, world, request):
    """A batch of 9 and a tail of 1 (one rank has it, the others none);
    CVBlock's batch statistics over the whole batch: the history and the
    running statistics are the unsharded run's."""
    cfg = torch_ranks.tiny_config(head=head)
    tc = TC.replace(batch_size=9, max_epochs=1)
    X, Y = corpus(1)
    ref = torch_ranks.cv_run(cfg, tc, X, Y)
    ours = pool_of(request, world).run(torch_ranks.cv_run, cfg, tc, X, Y, "data")
    assert_ranks_agree(ours)
    check_cv(ours[0]["fit"], ref["fit"], "data", N // K)
    for k, v in ref["fit"]["model_state"].items():
        np.testing.assert_allclose(ours[0]["fit"]["model_state"][k], v, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    if head == "CVBlock":
        assert ref["fit"]["model_state"]


# ---------------------------------------------------------------------------
# The engine's paths under a mesh: early stopping, resume, sweep mode
# ---------------------------------------------------------------------------

def fit_inputs(m=3, n_trials=40, n_train=30, seed=4):
    cfg = torch_ranks.tiny_config()
    x, y = synthetic_trials(seed, n_trials, n_channels=cfg.n_channels, n_samples=cfg.seq_len,
                            snr=6.0)
    rng = np.random.default_rng(seed)
    perms = np.stack([rng.permutation(n_trials) for _ in range(m)])
    return cfg, x, y, perms[:, :n_train], perms[:, n_train:]


def test_early_stop_under_data(pool2):
    """Patience and threshold decisions from the all-reduced metrics: every
    rank stops the same models at the unsharded run's epochs."""
    cfg, x, y, tidx, vidx = fit_inputs()
    kw = dict(epochs=6, batch_size=16, n_train=30, n_val=10, learning_rate=3e-3,
              warmup_epochs=0, early_stop_threshold=0.7, early_stop_patience=2)
    ref = torch_ranks.fit_run(cfg, x, y, tidx, vidx, **kw)
    ours = pool2.run(torch_ranks.fit_run, cfg, x, y, tidx, vidx, "data", **kw)
    for r in ours:
        np.testing.assert_array_equal(r["best_epoch"], ref["best_epoch"])
        np.testing.assert_allclose(r["history"]["loss"], ref["history"]["loss"], rtol=1e-3,
                                   atol=1e-5)
        np.testing.assert_allclose(r["best_val_acc"], ref["best_val_acc"], atol=flip_atol(10))
    assert (ref["best_epoch"] < 5).any()  # a model stopped before the budget


def test_resume_under_model_writes_the_unsharded_file(pool2, tmp_path):
    """The stack split over 2 ranks crashes after its first of two
    segments: rank 0 wrote the file the unsharded run writes there (the
    whole stack, the generators' states); resumed, each rank keeps its rows
    and the run ends as the uninterrupted sharded run does."""
    cfg, x, y, tidx, vidx = fit_inputs(m=3)
    kw = dict(epochs=1, total_epochs=2, batch_size=16, n_train=30, n_val=10,
              learning_rate=3e-3, warmup_epochs=0)
    plain_dir, ours_dir = str(tmp_path / "plain"), str(tmp_path / "ours")
    assert torch_ranks.fit_run(cfg, x, y, tidx, vidx, crash_after=1, checkpoint_dir=plain_dir,
                               **kw) is None
    assert pool2.run(torch_ranks.fit_run, cfg, x, y, tidx, vidx, "model", crash_after=1,
                     checkpoint_dir=ours_dir, **kw) == [None, None]
    with np.load(os.path.join(plain_dir, "segment_carry.npz")) as a, \
            np.load(os.path.join(ours_dir, "segment_carry.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
            if "rng" in k or k.endswith(("epoch", "step", "next_segment")):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                np.testing.assert_allclose(a[k], b[k], rtol=5e-3, atol=1e-3, err_msg=k)
    resumed = pool2.run(torch_ranks.fit_run, cfg, x, y, tidx, vidx, "model",
                        checkpoint_dir=ours_dir, **kw)
    whole = pool2.run(torch_ranks.fit_run, cfg, x, y, tidx, vidx, "model", **kw)
    plain = torch_ranks.fit_run(cfg, x, y, tidx, vidx, **kw)
    for k, v in whole[0]["history"].items():
        np.testing.assert_array_equal(resumed[0]["history"][k], v)
        np.testing.assert_allclose(v, plain["history"][k], rtol=5e-3, atol=1e-3)
    for k, v in whole[0]["params"].items():
        np.testing.assert_array_equal(resumed[1]["params"][k], v)


@pytest.mark.parametrize("where", ["segment", "loso"])
def test_failed_write_stops_every_rank(where, pool2, tmp_path):
    """Rank 0 alone writes; when its write fails, every rank raises at the
    same point (rank 0 its own error, the others that rank 0 failed)
    rather than going on into collectives that rank 0 never joins."""
    cfg, x, y, tidx, vidx = fit_inputs(m=3)
    if where == "segment":
        kw = dict(epochs=1, total_epochs=3, batch_size=16, n_train=30, n_val=10,
                  learning_rate=3e-3, warmup_epochs=0)
    else:
        x, y = corpus(2, s=3, n=20)
        kw = dict(epochs=1, batch_size=16, learning_rate=3e-3, warmup_epochs=0, seed=0)
    errors = pool2.run(torch_ranks.failed_write_run, where, cfg, x, y, tidx, vidx,
                       str(tmp_path / where), **kw)
    assert "disk full" in errors[0] or "failed" in errors[0], errors
    assert errors[1].startswith("RuntimeError") and "rank" in errors[1], errors


def test_loso_takes_one_branch_on_every_rank(pool2, tmp_path):
    """A second ``pretrain_loso`` where only rank 0 has the files (each rank
    saving into a directory of its own): every rank trains again, as the
    one without them must, and the run is the first one."""
    cfg = torch_ranks.tiny_config()
    X, Y = corpus(2, s=3, n=20)
    kw = dict(epochs=1, batch_size=16, learning_rate=3e-3, warmup_epochs=0, seed=0)
    first = pool2.run(torch_ranks.loso_rank_dirs, cfg, X, Y, str(tmp_path), "model", **kw)
    assert os.path.exists(tmp_path / "rank0" / "Pretrain_excludes_subs2.npz")
    assert not os.listdir(tmp_path / "rank1")
    again = pool2.run(torch_ranks.loso_rank_dirs, cfg, X, Y, str(tmp_path), "model", **kw)
    for k, v in first[0]["history"].items():
        np.testing.assert_array_equal(again[1]["history"][k], v, err_msg=k)


def test_mesh_strategy_is_made_once_a_run(pool2):
    """A strategy's process groups are made on its first call in a run and
    served after that, not made anew by every CV, LOSO or member call."""
    assert pool2.run(torch_ranks.mesh_made_once) == [True, True]


@pytest.mark.parametrize("world", [2, 4])
def test_sweep_fit_under_model(world, request):
    """A sweep-mode fit (per-row lr / wd) of 5 rows split over the ranks
    (padded): the hyperparameters ride the stack's rows, and the history is
    the unsharded sweep's within JAX's bound for its sharded sweep."""
    cfg, x, y, tidx, vidx = fit_inputs(m=5)
    hyper = {"lr_scale": np.asarray([1.0, 0.5, 2.0, 1.0, 0.25], np.float32),
             "wd_scale": np.asarray([1.0, 0.0, 1.0, 2.0, 1.0], np.float32)}
    kw = dict(epochs=1, total_epochs=2, batch_size=8, n_train=30, n_val=10, learning_rate=1e-3,
              warmup_epochs=0, sweep=True, hyper=hyper)
    ref = torch_ranks.fit_run(cfg, x, y, tidx, vidx, **kw)
    ours = pool_of(request, world).run(torch_ranks.fit_run, cfg, x, y, tidx, vidx, "model", **kw)
    for k, v in ref["history"].items():
        np.testing.assert_allclose(ours[0]["history"][k], v, rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(ours[0]["best_val_acc"], ref["best_val_acc"], atol=1e-6)


# ---------------------------------------------------------------------------
# The campaign programs under a mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", ["model", "2d"])
def test_loso_under_mesh(strategy, pool4, tmp_path):
    """``pretrain_loso``: 3 exclusions over 4 ranks (padded under 'model');
    rank 0 writes each subject's file, the unsharded run's."""
    cfg = torch_ranks.tiny_config()
    X, Y = corpus(2, s=3, n=20)
    kw = dict(epochs=2, batch_size=16, learning_rate=3e-3, warmup_epochs=0, seed=0)
    ref = torch_ranks.loso_run(cfg, X, Y, str(tmp_path / "plain"), **kw)
    ours = pool4.run(torch_ranks.loso_run, cfg, X, Y, str(tmp_path / "ours"), strategy, **kw)
    rtol, atol = LOSS_TOL[strategy]
    for k, v in ref["history"].items():
        if "loss" in k:
            np.testing.assert_allclose(ours[0]["history"][k], v, rtol=rtol, atol=atol, err_msg=k)
    np.testing.assert_allclose(ours[0]["best_val_acc"], ref["best_val_acc"], atol=0.35)
    for sid in ("s0", "s1", "s2"):
        name = f"Pretrain_excludes_sub{sid}.npz"
        with np.load(tmp_path / "plain" / name) as a, np.load(tmp_path / "ours" / name) as b:
            assert sorted(a.files) == sorted(b.files)


def test_seed_ensemble_under_data(pool2, tmp_path):
    """``train_seed_ensemble`` with ``mesh_axis`` in its CV arguments: the
    members and the vote are the unsharded ensemble's; rank 0 writes the
    tree."""
    from imagined_speech_decoding_tpu_torch.train.ensemble import train_seed_ensemble

    cfg = torch_ranks.tiny_config()
    tc = TC.replace(max_epochs=2)
    X, Y = corpus(3)
    test = {f"{i + 1:02d}": (X[i, :5], Y[i, :5]) for i in range(S)}
    ref = train_seed_ensemble(cfg, tc, X, Y, ["01", "02"], 5, test, str(tmp_path / "plain"),
                              n_members=2, verbose=False, device="cpu")
    ours = pool2.run(torch_ranks.ensemble_run, cfg, tc, X, Y, test, str(tmp_path / "ours"), "data")
    for a, b in zip(ours[0]["members"], ref.members):
        np.testing.assert_allclose(a["loss"], b.fit.history["loss"], rtol=1e-3, atol=1e-5)
    assert [r["Subject"] for r in ours[0]["summary"]] == ["01", "02"]
    assert (tmp_path / "ours" / "summary_per_subject.csv").is_file()
    assert (tmp_path / "ours" / "member-1" / "sub-02" / "best_subject.npz").is_file()


def test_clis_under_torchrun_environment(tmp_path):
    """``cli.train_fast --mesh data`` and ``cli.train_baselines --mesh
    model`` in 2 new processes that set torchrun's environment: the trees
    of the unsharded CLIs, with their histories."""
    from imagined_speech_decoding_tpu_torch.cli import train_baselines, train_fast

    cfg_path = tmp_path / "small.yaml"
    cfg_path.write_text("model:\n  dim_cnn: 8\n  dim_token: 16\n  num_layers: 1\n"
                        "  num_heads: 4\n")
    fast = ["--config", str(cfg_path), "--synthetic", "2", "--synthetic_trials", "10",
            "--epochs", "2", "--batch_size", "8", "--precision", "f32"]
    base = ["--pipeline", "bandpower_mlp", "--synthetic", "2", "--synthetic_trials", "10",
            "--epochs", "2", "--precision", "f32"]
    runs = {}
    for name, main, argv, strategy in (("fast", train_fast.main, fast, "data"),
                                       ("base", train_baselines.main, base, "model")):
        runs[name] = main(argv + ["--output_dir", str(tmp_path / f"{name}-plain")], device="cpu")
    mesh.spawn_ranks(torch_ranks.cli_rank, 2,
                     fast + ["--mesh", "data", "--output_dir", str(tmp_path / "fast-mesh")],
                     base + ["--mesh", "model", "--output_dir", str(tmp_path / "base-mesh")])
    for name in ("fast", "base"):
        plain, ours = tmp_path / f"{name}-plain", tmp_path / f"{name}-mesh"
        files = [sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root)
                        for f in fs) for root in (plain, ours)]
        assert files[0] == files[1], name
        for sub in ("sub-01", "sub-02"):
            a = np.genfromtxt(plain / sub / "fold-0_history.csv", delimiter=",", names=True)
            b = np.genfromtxt(ours / sub / "fold-0_history.csv", delimiter=",", names=True)
            np.testing.assert_allclose(b["loss"], a["loss"], rtol=5e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# The dry run
# ---------------------------------------------------------------------------

def test_dryrun_multichip_on_cpu_ranks():
    dryrun.dryrun_multichip(2, device="cpu")


@pytest.mark.parametrize("n", [1, 2])
def test_dryrun_multichip_needs_the_cards(n):
    """On ``cuda`` without a card (or with fewer than asked for) the dry run
    raises: it never moves to the CPU."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= n:
        pytest.skip("the cards are there")
    with pytest.raises(RuntimeError):
        dryrun.dryrun_multichip(n)

