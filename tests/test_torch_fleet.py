"""The port's fleet decoder (``serving.stack_checkpoints`` and
``make_fleet_decoder``, plain path on the CPU) against the JAX package's:
JAX-written per-subject ``.npz`` files stacked leaf for leaf, every row
and the ensemble against JAX's at the posteriors' tolerance, the window
filtered once for the whole fleet, hot swaps, and the port's
``cli.serve --checkpoint-dir`` against the JAX CLI over TCP."""

import os

import jax
import numpy as np
import pytest
import torch
import yaml

from imagined_speech_decoding_tpu.cli.serve import build_parser as jax_build_parser
from imagined_speech_decoding_tpu.cli.serve import build_server as jax_build_server
from imagined_speech_decoding_tpu.config import FASTConfig as JaxFASTConfig
from imagined_speech_decoding_tpu.models.api import make_fast_model
from imagined_speech_decoding_tpu.server import DecoderClient
from imagined_speech_decoding_tpu.serving import make_fleet_decoder as jax_make_fleet_decoder
from imagined_speech_decoding_tpu.serving import stack_checkpoints as jax_stack_checkpoints
from imagined_speech_decoding_tpu.train import checkpoint as jax_ckpt
from imagined_speech_decoding_tpu_torch.cli.serve import build_parser, build_server
from imagined_speech_decoding_tpu_torch.config import FASTConfig
from imagined_speech_decoding_tpu_torch.models.fast import FAST
from imagined_speech_decoding_tpu_torch.ops.cuda import iir
from imagined_speech_decoding_tpu_torch.serving import (
    make_fleet_decoder,
    make_online_decoder,
    stack_checkpoints,
)
from imagined_speech_decoding_tpu_torch.transplant import stack_trees

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5  # posteriors; tests/test_torch_serving.py
SMALL = dict(
    electrodes=("C1", "C2", "C3", "C4", "P1", "P2", "O1", "O2"),
    zone_dict={"Central": ("C1", "C2", "C3", "C4"), "Parietal": ("P1", "P2"),
               "Occipital": ("O1", "O2")},
    dim_cnn=8, dim_token=16, seq_len=200, window_len=100, slide_step=50,
    num_layers=1, num_heads=4, dropout=0.0,
)
CHAIN = dict(sfreq=100.0, notch_hz=25.0, band=(2.0, 30.0))
N_MODELS = 3


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """Three subjects' JAX-initialised weights written by the JAX package as
    ``results/FAST/sub-0k/best_subject.npz``."""
    model = make_fast_model(JaxFASTConfig(**SMALL))
    root = tmp_path_factory.mktemp("results") / "FAST"
    paths, weights = [], []
    for k in range(N_MODELS):
        p, s = model.init(jax.random.PRNGKey(k))
        paths.append(jax_ckpt.save_model_npz(str(root / f"sub-{k + 1:02d}" / "best_subject.npz"),
                                             p, s))
        weights.append(jax.tree.map(np.asarray, p))
    x = np.random.default_rng(1).normal(size=(6, 8, 200)).astype(np.float32)
    return model, str(root), paths, weights, x


def _port_fleet(params, state=None, **chain):
    return make_fleet_decoder(FAST(FASTConfig(**SMALL), n_models=N_MODELS), params, state,
                              **chain)


def test_stack_checkpoints_matches_jax(fleet):
    model, _, paths, _, _ = fleet
    ours, ours_state = stack_checkpoints(paths, FAST(FASTConfig(**SMALL)))
    theirs, _ = jax_stack_checkpoints(paths, model)
    assert ours_state == {"head": {}}  # Conv4Layers has no batch-norm state
    flat_ours, flat_theirs = jax.tree.leaves(ours), jax.tree.leaves(theirs)
    assert len(flat_ours) == len(flat_theirs)
    for a, b in zip(flat_ours, flat_theirs):
        assert a.shape[0] == N_MODELS
        np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.raises(ValueError, match="at least one"):
        stack_checkpoints([], FAST(FASTConfig(**SMALL)))


@pytest.mark.parametrize("chain", [CHAIN, dict(notch_hz=None, band=None)],
                         ids=["filtered", "unfiltered"])
def test_rows_and_ensemble_match_jax(fleet, chain):
    model, _, paths, _, x = fleet
    sp, ss = jax_stack_checkpoints(paths, model)
    theirs = jax_make_fleet_decoder(model.apply, sp, ss, use_pallas=False, **chain)
    ours = _port_fleet(*stack_checkpoints(paths, FAST(FASTConfig(**SMALL))), **chain)
    rows = ours(x)
    assert rows.shape == (N_MODELS, 6, 5) and rows.dtype == np.float32 and ours.n_models == 3
    np.testing.assert_allclose(rows, np.asarray(theirs(x)), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ours.ensemble(x), np.asarray(theirs.ensemble(x)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ours.ensemble(x), rows.mean(axis=0), rtol=1e-6, atol=1e-7)


def test_rows_match_single_decoders_and_filter_once(fleet, monkeypatch):
    """Each row is its model's online decoder; the window is filtered once
    for the whole fleet (one ``isd::sosfiltfilt_chain`` call a decode)."""
    _, _, _, weights, x = fleet
    calls = []
    real = iir.sosfiltfilt_chain_plain
    monkeypatch.setattr(iir, "sosfiltfilt_chain_plain",
                        lambda *a, **k: calls.append(a[1].shape) or real(*a, **k))
    rows = _port_fleet(stack_trees(weights), **CHAIN)(x)
    assert calls == [x.shape]
    for k, w in enumerate(weights):
        single = make_online_decoder(FAST(FASTConfig(**SMALL)), w, **CHAIN)
        np.testing.assert_allclose(rows[k], single(x), rtol=RTOL, atol=ATOL)


def test_swap_weights(fleet):
    model, _, _, weights, x = fleet
    dec = _port_fleet(stack_trees(weights), **CHAIN)
    before = dec(x)
    swapped = stack_trees(weights[::-1])
    dec.swap_weights(swapped)
    after = dec(x)
    np.testing.assert_array_equal(after, _port_fleet(swapped, **CHAIN)(x))
    np.testing.assert_array_equal(after, before[::-1])
    jax_swapped = jax_make_fleet_decoder(model.apply, swapped, {"head": {}}, use_pallas=False,
                                         **CHAIN)
    np.testing.assert_allclose(dec.ensemble(x), np.asarray(jax_swapped.ensemble(x)),
                               rtol=RTOL, atol=ATOL)


def test_needs_a_stacked_model(fleet):
    with pytest.raises(ValueError, match="n_models"):
        make_fleet_decoder(FAST(FASTConfig(**SMALL)), fleet[3][0])


def test_served_fleet_matches_the_jax_server(fleet, tmp_path):
    """``cli.serve --checkpoint-dir`` of both packages on the same results
    tree and YAML: INFO, DECODE_ALL and DECODE agree."""
    _, root, _, _, x = fleet
    cfg_path = str(tmp_path / "small.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({"model": {k: (list(v) if isinstance(v, tuple) else
                                      {z: list(e) for z, e in v.items()} if isinstance(v, dict)
                                      else v) for k, v in SMALL.items()}}, f)
    argv = ["--checkpoint-dir", root, "--config", cfg_path, "--port", "0"]
    out = {}
    for name, server in (("port", build_server(build_parser().parse_args(argv), device="cpu")),
                         ("jax", jax_build_server(jax_build_parser().parse_args(argv)))):
        with server, DecoderClient(*server.address) as client:
            out[name] = (client.info(), client.decode_all(x), client.decode(x[:2]))
    (info, rows, ens), (jinfo, jrows, jens) = out["port"], out["jax"]
    assert info["device"] == "cpu"
    for key in ("n_channels", "seq_len", "n_classes", "reloadable", "fleet", "mode", "n_models",
                "subjects"):
        assert info[key] == jinfo[key], key
    assert info["subjects"] == ["sub-01", "sub-02", "sub-03"]
    np.testing.assert_allclose(rows, jrows, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ens, jens, rtol=RTOL, atol=ATOL)


def test_empty_checkpoint_dir_exits(tmp_path):
    args = build_parser().parse_args(["--checkpoint-dir", str(tmp_path), "--port", "0"])
    with pytest.raises(SystemExit, match="sub-"):
        build_server(args, device="cpu")
