"""PyTorch port's serving path (plain path on the CPU) against the JAX
package: the online decoder, hot weight swaps, ``.npz`` checkpoints both
ways, and the TCP server answering ``DecoderClient`` requests."""

import os

import jax
import numpy as np
import pytest
import torch

from imagined_speech_decoding_tpu.cli.serve import build_parser as jax_build_parser
from imagined_speech_decoding_tpu.cli.serve import build_server as jax_build_server
from imagined_speech_decoding_tpu.config import FASTConfig as JaxFASTConfig
from imagined_speech_decoding_tpu.models.api import make_fast_model
from imagined_speech_decoding_tpu.server import DecoderClient
from imagined_speech_decoding_tpu.serving import make_online_decoder as jax_make_online_decoder
from imagined_speech_decoding_tpu.train import checkpoint as jax_ckpt
from imagined_speech_decoding_tpu_torch.cli.serve import build_parser, build_server
from imagined_speech_decoding_tpu_torch.config import FASTConfig
from imagined_speech_decoding_tpu_torch.models.fast import FAST
from imagined_speech_decoding_tpu_torch.serving import GRAPH_BATCHES, graph_batch, make_online_decoder
from imagined_speech_decoding_tpu_torch.train import checkpoint
from imagined_speech_decoding_tpu_torch.transplant import to_jax_params

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5  # posteriors; tests/test_torch_parity.py

SMALL = dict(
    electrodes=("C1", "C2", "C3", "C4", "P1", "P2", "O1", "O2"),
    zone_dict={"Central": ("C1", "C2", "C3", "C4"), "Parietal": ("P1", "P2"),
               "Occipital": ("O1", "O2")},
    dim_cnn=8, dim_token=16, seq_len=200, window_len=100, slide_step=50,
    num_layers=1, num_heads=4, dropout=0.0,
)
CHAIN = dict(sfreq=100.0, notch_hz=25.0, band=(2.0, 30.0))  # tests/test_server.py


@pytest.fixture(scope="module")
def small():
    model = make_fast_model(JaxFASTConfig(**SMALL))
    p1, state = model.init(jax.random.PRNGKey(0))
    p2, _ = model.init(jax.random.PRNGKey(7))
    x = np.random.default_rng(1).normal(size=(6, 8, 200)).astype(np.float32)
    as_np = lambda p: jax.tree.map(np.asarray, p)  # noqa: E731
    return model, as_np(p1), as_np(p2), state, x


class TestOnlineDecoder:
    def test_matches_jax_decoder(self, small):
        model, p1, _, state, x = small
        ref = jax_make_online_decoder(model.apply, p1, state, use_pallas=False, **CHAIN)(x)
        ours = make_online_decoder(FAST(FASTConfig(**SMALL)), p1, **CHAIN)(x)
        assert ours.dtype == np.float32 and ours.shape == (6, 5)
        np.testing.assert_allclose(ours.sum(-1), 1.0, rtol=1e-5)
        np.testing.assert_allclose(ours, np.asarray(ref), rtol=RTOL, atol=ATOL)

    def test_filters_off_matches_jax(self, small):
        model, p1, _, state, x = small
        ref = jax_make_online_decoder(
            model.apply, p1, state, notch_hz=None, band=None, use_pallas=False
        )(x)
        ours = make_online_decoder(FAST(FASTConfig(**SMALL)), p1, notch_hz=None, band=None)(x)
        np.testing.assert_allclose(ours, np.asarray(ref), rtol=RTOL, atol=ATOL)

    def test_filters_are_designed_once(self, small, monkeypatch):
        """Building a decoder computes ``sosfilt_zi`` once per filter;
        decoding never calls it."""
        import scipy.signal

        _, p1, _, _, x = small
        calls = []
        real = scipy.signal.sosfilt_zi
        monkeypatch.setattr(scipy.signal, "sosfilt_zi", lambda sos: calls.append(1) or real(sos))
        dec = make_online_decoder(FAST(FASTConfig(**SMALL)), p1, **CHAIN)
        assert len(calls) == 2  # the notch and the band-pass
        dec(x)
        dec(x[:1])
        assert len(calls) == 2

    def test_swap_weights(self, small):
        model, p1, p2, state, x = small
        dec = make_online_decoder(FAST(FASTConfig(**SMALL)), p1, **CHAIN)
        before = dec(x)
        dec.swap_weights(p2)
        after = dec(x)
        assert not np.allclose(before, after)
        ref = jax_make_online_decoder(model.apply, p2, state, use_pallas=False, **CHAIN)(x)
        np.testing.assert_allclose(after, np.asarray(ref), rtol=RTOL, atol=ATOL)
        fresh = make_online_decoder(FAST(FASTConfig(**SMALL)), p2, **CHAIN)(x)
        np.testing.assert_array_equal(after, fresh)

    def test_cpu_decoder_calls_the_chain_directly(self, small):
        """Graphs are captured on a card only: on the CPU every decode is an
        eager call of the chain."""
        _, p1, _, _, x = small
        dec = make_online_decoder(FAST(FASTConfig(**SMALL)), p1, **CHAIN)
        first, second = dec(x), dec(x[:2])
        assert (dec.eager, dec.replays, dec.graphs) == (2, 0, {})
        np.testing.assert_allclose(first[:2], second, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("b,served", [(1, 1), (2, 2), (3, 4), (5, 8), (8, 8), (9, 16),
                                      (31, 32), (33, 64), (64, 64)])
def test_graph_batch_is_the_smallest_that_holds_the_slice(b, served):
    """A card's decoder serves a slice of ``b`` trials at one of a fixed
    set of captured batch sizes, so clients cannot make it capture (and
    hold memory for) a graph per batch size they send."""
    assert graph_batch(b) == served and served in GRAPH_BATCHES


class TestCheckpoints:
    def _template(self):
        return to_jax_params(FAST(FASTConfig(**SMALL)).state_dict())

    def test_jax_written_port_read(self, small, tmp_path):
        _, p1, _, state, _ = small
        path = jax_ckpt.save_model_npz(str(tmp_path / "w.npz"), p1, state)
        params, st, had_state = checkpoint.load_model_npz(path, self._template(), {"head": {}})
        assert had_state and st == {"head": {}}
        for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(p1)):
            np.testing.assert_array_equal(a, b)

    def test_port_written_jax_read(self, small, tmp_path):
        _, p1, _, state, _ = small
        path = checkpoint.save_model_npz(str(tmp_path / "w.npz"), p1, {"head": {}})
        params, _, had_state = jax_ckpt.load_model_npz(path, p1, state)
        assert had_state
        for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(p1)):
            np.testing.assert_array_equal(np.asarray(a), b)

    def test_legacy_model_prefix_is_stripped(self, small, tmp_path):
        _, p1, _, _, _ = small
        flat = {f"model.{k}": v for k, v in checkpoint._flatten(p1).items()}
        path = str(tmp_path / "legacy.npz")
        np.savez(path, **flat)
        params, st, had_state = checkpoint.load_model_npz(path, self._template(), {"head": {}})
        assert not had_state and st == {"head": {}}
        for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(p1)):
            np.testing.assert_array_equal(a, b)

    def test_missing_and_misshapen_weights_raise(self, small, tmp_path):
        _, p1, _, _, _ = small
        flat = checkpoint._flatten({"params": p1, "state": {"head": {}}})
        flat.pop("params.cls_token")
        path = str(tmp_path / "missing.npz")
        np.savez(path, **flat)
        with pytest.raises(KeyError, match="cls_token"):
            checkpoint.load_model_npz(path, self._template(), {"head": {}})
        flat["params.cls_token"] = np.zeros((1, 2, 16), np.float32)
        np.savez(path, **flat)
        with pytest.raises(ValueError, match="shape mismatch"):
            checkpoint.load_model_npz(path, self._template(), {"head": {}})


class TestServeCLI:
    def test_serves_jax_checkpoint_like_the_jax_server(self, tmp_path):
        """Full width: a checkpoint the JAX package wrote, served by both
        CLIs; INFO, DECODE, RELOAD and DECODE again agree."""
        model = make_fast_model(JaxFASTConfig.default())
        paths = []
        for seed, sub in ((0, "sub-01"), (1, "sub-02")):
            p, s = model.init(jax.random.PRNGKey(seed))
            paths.append(jax_ckpt.save_model_npz(
                str(tmp_path / "FAST" / sub / "best_subject.npz"), p, s))
        x = np.random.default_rng(2).normal(size=(2, 64, 800)).astype(np.float32)
        argv = ["--checkpoint", paths[0], "--port", "0"]
        out = {}
        for name, server in (("port", build_server(build_parser().parse_args(argv),
                                                   device="cpu")),
                             ("jax", jax_build_server(jax_build_parser().parse_args(argv)))):
            with server, DecoderClient(*server.address) as client:
                info = client.info()
                first = client.decode(x)
                client.reload(os.path.relpath(paths[1], os.path.dirname(os.path.dirname(paths[1]))))
                out[name] = (info, first, client.decode(x))
        (info, first, second), (jinfo, jfirst, jsecond) = out["port"], out["jax"]
        assert info["device"] == "cpu"
        for key in ("n_channels", "seq_len", "n_classes", "reloadable", "mode", "reload_root"):
            assert info[key] == jinfo[key], key
        np.testing.assert_allclose(first, jfirst, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(second, jsecond, rtol=RTOL, atol=ATOL)
        assert not np.allclose(first, second)

    def test_no_cpu_fallback_without_a_card(self, tmp_path, monkeypatch):
        """The server runs on CUDA unless told otherwise: with no card it
        raises instead of serving from the CPU."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        args = build_parser().parse_args(["--checkpoint", str(tmp_path / "w.npz"), "--port", "0"])
        with pytest.raises(RuntimeError, match="is_available"):
            build_server(args)
