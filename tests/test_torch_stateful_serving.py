"""Serving checkpoints of the batch-norm heads, whose running statistics
travel with the weights (plain path on the CPU), against the JAX
package: the live decoder, ``swap_weights(params, state)``, the fleet
from ``stack_checkpoints`` of JAX-written files, the exported artifact,
``cli.serve`` and ``cli.export_decoder`` on a stateful checkpoint, and
zero-shot's warning for a params-only file of a stateful head."""

import os

import jax
import numpy as np
import pytest
import torch
import yaml

from imagined_speech_decoding_tpu.config import FASTConfig as JaxFASTConfig
from imagined_speech_decoding_tpu.models.api import make_fast_model
from imagined_speech_decoding_tpu.serving import make_fleet_decoder as jax_make_fleet_decoder
from imagined_speech_decoding_tpu.serving import make_online_decoder as jax_make_online_decoder
from imagined_speech_decoding_tpu.serving import stack_checkpoints as jax_stack_checkpoints
from imagined_speech_decoding_tpu.train import checkpoint as jax_ckpt
from imagined_speech_decoding_tpu_torch import transplant
from imagined_speech_decoding_tpu_torch.cli import export_decoder, serve, zero_shot
from imagined_speech_decoding_tpu_torch.config import FASTConfig
from imagined_speech_decoding_tpu_torch.models.fast import FAST
from imagined_speech_decoding_tpu_torch.serving import (
    export_decoder_artifact,
    export_decoder_weights,
    load_decoder_artifact,
    load_decoder_weights,
    make_fleet_decoder,
    make_online_decoder,
    stack_checkpoints,
)
from imagined_speech_decoding_tpu_torch.train.checkpoint import save_state_dict

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5  # posteriors; tests/test_torch_serving.py
SMALL = dict(
    electrodes=("C1", "C2", "C3", "C4", "P1", "P2", "O1", "O2"),
    zone_dict={"Central": ("C1", "C2", "C3", "C4"), "Parietal": ("P1", "P2"),
               "Occipital": ("O1",), "Frontal": ("O2",)},
    dim_cnn=8, dim_token=16, seq_len=200, window_len=100, slide_step=50,
    num_layers=1, num_heads=4, dropout=0.0,
)
CHAIN = dict(sfreq=100.0, notch_hz=25.0, band=(2.0, 30.0))


def _trained_state(model, p, s, seed):
    """A state with moved statistics: one JAX train-mode forward."""
    x = np.random.default_rng(seed).normal(size=(4, 8, 200)).astype(np.float32) * 2 + 0.3
    _, s = model.apply(p, s, jax.numpy.asarray(x), train=True, rng=None)
    return s


@pytest.fixture(scope="module", params=["CVBlock", "HeadConv_Paper_Version"])
def ckpts(request, tmp_path_factory):
    """Three subjects' JAX weights and moved statistics, written by the JAX
    package as ``FAST/sub-0k/best_subject.npz``."""
    head = request.param
    kw = dict(SMALL, head=head)
    model = make_fast_model(JaxFASTConfig(**kw))
    root = tmp_path_factory.mktemp("results") / "FAST"
    paths, trees = [], []
    for k in range(3):
        p, s = model.init(jax.random.PRNGKey(k))
        s = _trained_state(model, p, s, k)
        paths.append(jax_ckpt.save_model_npz(str(root / f"sub-{k + 1:02d}" / "best_subject.npz"),
                                             p, s))
        trees.append((jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, s)))
    x = np.random.default_rng(9).normal(size=(5, 8, 200)).astype(np.float32)
    return head, kw, model, str(root), paths, trees, x


def test_live_decoder_and_swap_carry_the_state(ckpts):
    head, kw, model, _, _, trees, x = ckpts
    (p0, s0), (p1, s1) = trees[0], trees[1]
    ours = make_online_decoder(FAST(FASTConfig(**kw)), p0, s0, **CHAIN)
    ref = jax_make_online_decoder(model.apply, p0, s0, use_pallas=False, **CHAIN)
    np.testing.assert_allclose(ours(x), np.asarray(ref(x)), rtol=RTOL, atol=ATOL)
    ours.swap_weights(p1, s1)
    fresh = make_online_decoder(FAST(FASTConfig(**kw)), p1, s1, **CHAIN)
    np.testing.assert_array_equal(ours(x), fresh(x))
    stale = make_online_decoder(FAST(FASTConfig(**kw)), p1, s0, **CHAIN)
    assert not np.array_equal(stale(x), fresh(x))  # the statistics matter
    with pytest.raises(ValueError, match="state"):
        ours.swap_weights(p1)


def test_fleet_from_jax_files(ckpts):
    """``stack_checkpoints`` returns JAX's stacked params and state; the
    fleet's rows and ensemble equal JAX's; a swap carries the state."""
    _, kw, model, _, paths, trees, x = ckpts
    params, state = stack_checkpoints(paths, FAST(FASTConfig(**kw)))
    jp, js = jax_stack_checkpoints(paths, model)
    for a, b in zip(jax.tree.leaves((params, state)), jax.tree.leaves((jp, js))):
        np.testing.assert_array_equal(a, np.asarray(b))
    fleet = make_fleet_decoder(FAST(FASTConfig(**kw), n_models=3), params, state, **CHAIN)
    ref = jax_make_fleet_decoder(model.apply, jp, js, use_pallas=False, **CHAIN)
    np.testing.assert_allclose(fleet(x), np.asarray(ref(x)), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(fleet.ensemble(x), np.asarray(ref.ensemble(x)), rtol=RTOL,
                               atol=ATOL)
    rev = (transplant.stack_trees([t[0] for t in trees[::-1]]),
           transplant.stack_trees([t[1] for t in trees[::-1]]))
    before = fleet(x)
    fleet.swap_weights(*rev)
    np.testing.assert_array_equal(fleet(x), before[::-1])


def test_artifact_and_weights_carry_the_state(ckpts, tmp_path):
    _, kw, _, _, _, trees, x = ckpts
    p, s = trees[2]
    live = make_online_decoder(FAST(FASTConfig(**kw)), p, s, **CHAIN)
    path = export_decoder_artifact(str(tmp_path / "d.pt2"), FAST(FASTConfig(**kw)), p, s,
                                   n_channels=8, seq_len=200, **CHAIN)
    art = load_decoder_artifact(path, device="cpu")
    np.testing.assert_allclose(art(x), live(x), rtol=1e-6, atol=1e-7)
    sd = FAST(FASTConfig(**kw)).state_dict()
    tp, ts = transplant.to_jax_params(sd), transplant.to_jax_state(sd)
    wp, ws = load_decoder_weights(export_decoder_weights(str(tmp_path / "w.npz"), p, s), tp, ts)
    for a, b in zip(jax.tree.leaves((wp, ws)), jax.tree.leaves((p, s))):
        np.testing.assert_array_equal(a, b)


def _yaml(path, kw):
    with open(path, "w") as f:
        yaml.safe_dump({"model": {k: (list(v) if isinstance(v, tuple) else
                                      {z: list(e) for z, e in v.items()} if isinstance(v, dict)
                                      else v) for k, v in kw.items()}}, f, sort_keys=False)
    return str(path)


def test_cli_serve_and_export_load_the_state(ckpts, tmp_path):
    """``cli.serve --checkpoint`` decodes with the checkpoint's statistics
    (the live decoder's posteriors), RELOAD swaps them; ``cli.export_decoder``
    writes an artifact that decodes the same."""
    _, kw, _, root, paths, trees, x = ckpts
    cfg = _yaml(tmp_path / "c.yaml", kw)
    args = serve.build_parser().parse_args(["--checkpoint", paths[0], "--config", cfg, "--port",
                                            "0", "--notch", "25", "--band", "2", "30"])
    p0, s0 = trees[0]
    band = dict(notch_hz=25.0, band=(2.0, 30.0))
    live = make_online_decoder(FAST(FASTConfig(**kw)), p0, s0, **band)
    with serve.build_server(args, device="cpu") as server:
        np.testing.assert_allclose(server._decode(x), live(x), rtol=1e-6, atol=1e-7)
        server._reload(paths[1])
        p1, s1 = trees[1]
        np.testing.assert_allclose(server._decode(x), make_online_decoder(
            FAST(FASTConfig(**kw)), p1, s1, **band)(x), rtol=1e-6, atol=1e-7)
    out = str(tmp_path / "e.pt2")
    export_decoder.main(["--checkpoint", paths[0], "--config", cfg, "--out", out,
                         "--notch", "25", "--band", "2", "30"])
    np.testing.assert_allclose(load_decoder_artifact(out, device="cpu")(x), live(x), rtol=1e-6,
                               atol=1e-7)


def test_zero_shot_warns_for_a_params_only_stateful_checkpoint(ckpts, tmp_path, monkeypatch,
                                                                capsys):
    """A legacy params-only file of a stateful head is evaluated with the
    initial statistics and the JAX CLI's warning is printed; a file with
    state is read without one."""
    from imagined_speech_decoding_tpu_torch.data import ingest

    head, kw, _, root, paths, trees, _ = ckpts
    legacy = tmp_path / "FAST"
    save_state_dict(str(legacy / "sub-01" / "best_subject.npz"), trees[0][0])
    jax_ckpt.save_model_npz(str(legacy / "sub-02" / "best_subject.npz"), *trees[1])
    rng = np.random.default_rng(1)
    split = {sid: (rng.normal(size=(4, 8, 200)).astype(np.float32), rng.integers(0, 5, 4))
             for sid in ("01", "02")}
    monkeypatch.setattr(ingest, "resolve_data_folder", lambda folder: folder)
    monkeypatch.setattr(ingest, "resolve_excel_path", lambda base, path: path)
    monkeypatch.setattr(ingest, "load_test_set_per_subject", lambda *a, **k: split)
    cfg = _yaml(tmp_path / "c.yaml", kw)
    matrix = zero_shot.main(["--results_dir", str(legacy), "--config", cfg,
                             "--output_dir", str(tmp_path / "out")], device="cpu")
    text = capsys.readouterr().out
    assert text.count("WARNING") == 1 and "sub-01" in text and f"{head} head is stateful" in text
    init = transplant.to_jax_state(FAST(FASTConfig(**kw)).state_dict())
    stacked = FAST(FASTConfig(**kw), n_models=2)
    stacked.load_state_dict(transplant.from_jax_params(
        transplant.stack_trees([trees[0][0], trees[1][0]]),
        transplant.stack_trees([init, trees[1][1]])))
    np.testing.assert_array_equal(matrix, zero_shot.transfer_matrix(stacked,
                                                                    list(split.values())))
    assert os.path.exists(tmp_path / "out" / "zero_shot_matrix.csv")
