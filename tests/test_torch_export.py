"""The exported decoder artifact (``serving.export_decoder_artifact`` over
``torch.export``, with the serving chain's kernels as the custom
operators of ``ops/cuda/library.py``) against the JAX package, on the
CPU, where each operator runs its plain version: ``opcheck`` of both
operators, the artifact at B = 1, 3 and 6 against the JAX live decoder
(posteriors' tolerance) and the port's live decoder (bit for bit), a
fixed batch, the self-contained load, ``artifact_meta``, and the CLIs
(``cli.export_decoder``, ``cli.serve --artifact`` and ``--config``)
against the JAX CLIs."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from imagined_speech_decoding_tpu.cli.export_decoder import main as jax_export_main
from imagined_speech_decoding_tpu.cli.serve import build_parser as jax_build_parser
from imagined_speech_decoding_tpu.cli.serve import build_server as jax_build_server
from imagined_speech_decoding_tpu.config import FASTConfig as JaxFASTConfig
from imagined_speech_decoding_tpu.models.api import make_fast_model
from imagined_speech_decoding_tpu.server import DecoderClient
from imagined_speech_decoding_tpu.serving import load_decoder_weights as jax_load_weights
from imagined_speech_decoding_tpu.serving import export_decoder_weights as jax_export_weights
from imagined_speech_decoding_tpu.serving import make_online_decoder as jax_make_online_decoder
from imagined_speech_decoding_tpu.train import checkpoint as jax_ckpt
from imagined_speech_decoding_tpu_torch.cli.export_decoder import main as export_main
from imagined_speech_decoding_tpu_torch.cli.serve import build_parser, build_server
from imagined_speech_decoding_tpu_torch.config import FASTConfig, load_config
from imagined_speech_decoding_tpu_torch.models.fast import FAST
from imagined_speech_decoding_tpu_torch.ops.cuda import library
from imagined_speech_decoding_tpu_torch.ops.cuda.conv4head import fused_conv4_head_plain
from imagined_speech_decoding_tpu_torch.ops.cuda.iir import (
    chain_table,
    prepare_filter,
    sosfiltfilt_chain_plain,
)
from imagined_speech_decoding_tpu_torch.ops.filters import butter_sos
from imagined_speech_decoding_tpu_torch.server import artifact_meta
from imagined_speech_decoding_tpu_torch.serving import (
    export_decoder_artifact,
    export_decoder_weights,
    load_decoder_artifact,
    load_decoder_weights,
    make_online_decoder,
)
from imagined_speech_decoding_tpu_torch.transplant import init_jax_layout_params, to_jax_params

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5  # posteriors; tests/test_torch_serving.py
SMALL = dict(
    electrodes=("C1", "C2", "C3", "C4", "P1", "P2", "O1", "O2"),
    zone_dict={"Central": ("C1", "C2", "C3", "C4"), "Parietal": ("P1", "P2"),
               "Occipital": ("O1", "O2")},
    dim_cnn=8, dim_token=16, seq_len=200, window_len=100, slide_step=50,
    num_layers=1, num_heads=4, dropout=0.0,
)
CHAIN = dict(sfreq=100.0, notch_hz=25.0, band=(2.0, 30.0))
SHAPE = dict(n_channels=8, seq_len=200)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """The JAX model's weights exported by the port with a symbolic batch."""
    model = make_fast_model(JaxFASTConfig(**SMALL))
    params, state = model.init(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    path = str(tmp_path_factory.mktemp("export") / "decoder.pt2")
    export_decoder_artifact(path, FAST(FASTConfig(**SMALL)), params, **SHAPE, **CHAIN)
    return model, params, state, path


@pytest.mark.parametrize("op", ["sosfiltfilt_chain", "conv4head_fwd"])
def test_opcheck(op):
    """Schema, fake (meta) implementation, autograd registration and
    dynamic-shape tracing of each operator agree with its CPU kernel."""
    rng = np.random.default_rng(0)
    if op == "sosfiltfilt_chain":
        filters = [prepare_filter(butter_sos(100.0, 2.0, 30.0, 2)),
                   prepare_filter(butter_sos(100.0, 5.0, None, 1))]
        args = (torch.tensor(rng.normal(size=(2, 3, 120)).astype(np.float32)),
                chain_table(filters, "cpu"), [f.n_sections for f in filters],
                [f.padlen for f in filters])
        ref = sosfiltfilt_chain_plain(filters, args[0])
    else:
        m, b, c, t, z, o, k = 2, 2, 6, 60, 3, 8, 5
        shapes = [(m, b, c, t), (m, z * o, k * c), (m, z * o, 1), (m, z, o, k * o),
                  (m, z, o, k * o)]
        args = tuple(torch.tensor(rng.normal(size=s).astype(np.float32)) for s in shapes)
        args += (30, 10)
        ref = fused_conv4_head_plain(*args)
    torch.library.opcheck(getattr(library, op), args)
    assert torch.equal(getattr(library, op)(*args), ref)


@pytest.mark.parametrize("b", [1, 3, 6])
def test_artifact_matches_the_live_decoders(artifact, b):
    model, params, state, path = artifact
    decode = load_decoder_artifact(path, device="cpu")
    x = np.random.default_rng(b).normal(size=(b, 8, 200)).astype(np.float32)
    post = decode(x)
    assert post.shape == (b, 5) and post.dtype == np.float32
    jax_live = jax_make_online_decoder(model.apply, params, state, use_pallas=False, **CHAIN)
    np.testing.assert_allclose(post, np.asarray(jax_live(x)), rtol=RTOL, atol=ATOL)
    # the port's live chain runs the same operators on the same operands
    live = make_online_decoder(FAST(FASTConfig(**SMALL)), params, **CHAIN)
    np.testing.assert_array_equal(post, live(x))


def test_artifact_calls_the_operators(artifact):
    """One node of each kernel's operator; no plain-version op in the graph."""
    targets = [str(n.target) for n in load_decoder_artifact(artifact[3], "cpu").program.graph.nodes
               if n.op == "call_function"]
    assert targets.count("isd.sosfiltfilt_chain.default") == 1
    assert targets.count("isd.conv4head_fwd.default") == 1
    assert not [t for t in targets if "unfold" in t or "flip" in t]


def test_fixed_batch_refuses_another(artifact, tmp_path):
    _, params, _, _ = artifact
    path = export_decoder_artifact(str(tmp_path / "b2.pt2"), FAST(FASTConfig(**SMALL)), params,
                                   batch_size=2, **SHAPE, **CHAIN)
    decode = load_decoder_artifact(path, device="cpu")
    assert decode(np.zeros((2, 8, 200), np.float32)).shape == (2, 5)
    with pytest.raises(AssertionError, match="size"):
        decode(np.zeros((3, 8, 200), np.float32))
    assert artifact_meta(decode.program) == {"n_channels": 8, "seq_len": 200, "n_classes": 5}


def test_platforms(tiny, capsys):
    """The CLI takes the JAX CLI's ``--platforms`` and refuses a TPU; the
    artifact itself runs on the card or the CPU, wherever it is loaded."""
    d, cfg_path, _ = tiny
    with pytest.raises(SystemExit):
        export_main(["--config", cfg_path, "--out", str(d / "t.pt2"), "--platforms", "tpu"])
    assert "invalid choice" in capsys.readouterr().err
    path = export_main(["--config", cfg_path, "--out", str(d / "c.pt2"), "--platforms", "cuda"])
    post = load_decoder_artifact(path, device="cpu")(np.zeros((1, 8, 200), np.float32))
    assert post.shape == (1, 5)


def test_artifact_meta(artifact):
    program = load_decoder_artifact(artifact[3], "cpu").program
    assert artifact_meta(program) == {"n_channels": 8, "seq_len": 200, "n_classes": 5}


def test_load_without_a_card_raises(artifact, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        load_decoder_artifact(artifact[3])


SELF_CONTAINED = r"""
import sys
for name in ("jax", "yaml", "pandas", "sklearn", "matplotlib"):
    sys.modules[name] = None   # any import of these now raises
import numpy as np, torch
torch.set_num_threads(1)
from imagined_speech_decoding_tpu_torch.serving import load_decoder_artifact
decode = load_decoder_artifact(sys.argv[1], device="cpu")
post = decode(np.zeros((2, 8, 200), np.float32))
assert post.shape == (2, 5) and np.isfinite(post).all(), post
assert np.allclose(post.sum(-1), 1.0, atol=1e-5)
loaded = sorted(m for m in sys.modules if m.startswith("imagined_speech_decoding_tpu_torch.models")
                or m.split(".")[0] == "imagined_speech_decoding_tpu")
assert not loaded, loaded
print("SERVED-OK")
"""


def test_self_contained_load_needs_no_model_code(artifact):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", SELF_CONTAINED, artifact[3]], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SERVED-OK" in proc.stdout


def test_decoder_weights_round_trip_both_ways(artifact, tmp_path):
    _, params, state, _ = artifact
    template = to_jax_params(FAST(FASTConfig(**SMALL)).state_dict())
    ours, _ = load_decoder_weights(jax_export_weights(str(tmp_path / "j.npz"), params, state),
                                   template)
    theirs, _ = jax_load_weights(export_decoder_weights(str(tmp_path / "p.npz"), params),
                                 params, state)
    for a, b, c in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(np.asarray(b), c)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """tests/test_serving.py's tiny YAML config and a JAX checkpoint of it."""
    d = tmp_path_factory.mktemp("cli")
    electrodes = [f"E{i}" for i in range(8)]
    model_cfg = {
        "electrodes": electrodes,
        "zone_dict": {"A": electrodes[:3], "B": electrodes[3:6], "C": electrodes[6:]},
        "dim_cnn": 8, "dim_token": 8, "seq_len": 200, "window_len": 100, "slide_step": 50,
        "num_layers": 1, "num_heads": 2, "dropout": 0.0,
    }
    cfg_path = str(d / "tiny.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({"model": model_cfg}, f)
    model = make_fast_model(JaxFASTConfig(**{k: tuple(v) if k == "electrodes" else
                                             {z: tuple(e) for z, e in v.items()}
                                             if k == "zone_dict" else v
                                             for k, v in model_cfg.items()}))
    p, s = model.init(jax.random.PRNGKey(3))
    ckpt = jax_ckpt.save_model_npz(str(d / "FAST" / "sub-01" / "best_subject.npz"), p, s)
    return d, cfg_path, ckpt


def _serve_both(argv_ours, argv_theirs, x):
    out = []
    for server in (build_server(build_parser().parse_args(argv_ours), device="cpu"),
                   jax_build_server(jax_build_parser().parse_args(argv_theirs))):
        with server, DecoderClient(*server.address) as client:
            out.append((client.info(), client.decode(x)))
    return out


def test_cli_export_then_serve_artifact_like_jax(tiny):
    d, cfg_path, ckpt = tiny
    flags = ["--config", cfg_path, "--checkpoint", ckpt, "--notch", "25.0", "--band", "2.0", "30.0"]
    ours = export_main(flags + ["--out", str(d / "decoder.pt2")])
    theirs = jax_export_main(flags + ["--out", str(d / "decoder.stablehlo"), "--platforms", "cpu"])
    assert os.path.getsize(ours) > 0 and os.path.getsize(theirs) > 0
    x = np.random.default_rng(5).normal(size=(4, 8, 200)).astype(np.float32)
    (info, post), (jinfo, jpost) = _serve_both(["--artifact", ours, "--port", "0"],
                                               ["--artifact", theirs, "--port", "0"], x)
    for key in ("n_channels", "seq_len", "n_classes", "reloadable", "fleet", "mode"):
        assert info[key] == jinfo[key], key
    assert info["mode"] == "artifact" and not info["reloadable"]
    np.testing.assert_allclose(post, jpost, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(post.sum(-1), 1.0, atol=1e-5)


def test_cli_serves_a_yaml_config_like_jax(tiny):
    d, cfg_path, ckpt = tiny
    x = np.random.default_rng(6).normal(size=(3, 8, 200)).astype(np.float32)
    argv = ["--checkpoint", ckpt, "--config", cfg_path, "--port", "0"]
    (info, post), (jinfo, jpost) = _serve_both(argv, argv, x)
    assert (info["n_channels"], info["seq_len"], info["mode"]) == (8, 200, "live")
    assert info["n_channels"] == jinfo["n_channels"]
    np.testing.assert_allclose(post, jpost, rtol=RTOL, atol=ATOL)


def test_cli_export_without_a_checkpoint(tiny, capsys):
    """Without ``--checkpoint`` the CLI exports the seed's initial weights,
    at a fixed batch: the live decoder of those weights, bit for bit."""
    d, cfg_path, _ = tiny
    path = export_main(["--config", cfg_path, "--out", str(d / "fresh.pt2"), "--batch_size", "2",
                        "--seed", "4"])
    assert "no --checkpoint" in capsys.readouterr().out
    cfg = load_config(cfg_path).model
    x = np.random.default_rng(7).normal(size=(2, 8, 200)).astype(np.float32)
    live = make_online_decoder(FAST(cfg), init_jax_layout_params(cfg, 4))
    np.testing.assert_array_equal(load_decoder_artifact(path, device="cpu")(x), live(x))
