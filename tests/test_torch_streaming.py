"""The port's ``StreamingDecoder`` (numpy ring and native ring) against the
JAX ``StreamingDecoder`` on the same stream, pushed in chunk sizes that
do not divide the window: every decode of the latest window agrees with
JAX's at the posteriors' tolerance, and the port's two rings hand the
decoder the same window, bit for bit."""

import jax
import numpy as np
import pytest
import torch

from imagined_speech_decoding_tpu.config import FASTConfig as JaxFASTConfig
from imagined_speech_decoding_tpu.models.api import make_fast_model
from imagined_speech_decoding_tpu.serving import StreamingDecoder as JaxStreamingDecoder
from imagined_speech_decoding_tpu.serving import make_online_decoder as jax_make_online_decoder
from imagined_speech_decoding_tpu_torch.config import FASTConfig
from imagined_speech_decoding_tpu_torch.models.fast import FAST
from imagined_speech_decoding_tpu_torch.serving import StreamingDecoder, make_online_decoder

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
CHUNKS = [7, 33, 50, 1, 129, 64]  # tests/test_serving.py's ragged sizes


@pytest.fixture(scope="module")
def decoders():
    model = make_fast_model(JaxFASTConfig(**SMALL))
    params, state = model.init(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    jax_dec = jax_make_online_decoder(model.apply, params, state, use_pallas=False, **CHAIN)
    return jax_dec, make_online_decoder(FAST(FASTConfig(**SMALL)), params, **CHAIN)


@pytest.mark.parametrize("native", [False, True], ids=["numpy_ring", "native_ring"])
def test_latest_window_matches_jax_over_ragged_chunks(decoders, native):
    jax_dec, dec = decoders
    theirs = JaxStreamingDecoder(jax_dec, 8, 200)
    ours = StreamingDecoder(dec, 8, 200, native=native)
    stream = np.random.default_rng(3).normal(size=(8, 200 * 3 + 17)).astype(np.float32)
    pos, decoded = 0, 0
    try:
        for size in CHUNKS * 4:
            chunk = stream[:, pos:pos + size]
            if chunk.shape[-1] == 0:
                break
            theirs.push(chunk)
            ours.push(chunk)
            pos += chunk.shape[-1]
            assert ours.ready == theirs.ready == (pos >= 200)
            if ours.ready:
                np.testing.assert_allclose(ours.decode_latest(), theirs.decode_latest(),
                                           rtol=RTOL, atol=ATOL)
                assert ours.last_end == pos
                decoded += 1
    finally:
        ours.close()
    assert decoded >= 8


def test_the_two_rings_hand_over_the_same_window():
    """For identical pushes the native-backed decoder sees the window the
    numpy-backed one sees, bit for bit (tests/test_ringbuf.py's check)."""
    seen = {}

    def fake_decoder(x):
        seen["window"] = np.asarray(x)[0]
        return np.full((1, 5), 0.2, np.float32)

    chunks = [np.random.default_rng(3).normal(size=(4, n)).astype(np.float32)
              for n in (7, 40, 13, 29, 300)]
    py = StreamingDecoder(fake_decoder, 4, 64)
    nat = StreamingDecoder(fake_decoder, 4, 64, native=True)
    for i, ch in enumerate(chunks):
        py.push(ch)
        nat.push(ch)
        assert py.ready == nat.ready
        if py.ready:
            np.testing.assert_array_equal(py.decode_latest(), nat.decode_latest())
            py_window = seen["window"].copy()
            py.decode_latest()
            np.testing.assert_array_equal(seen["window"], py_window)
            assert py.last_end == nat.last_end == sum(c.shape[1] for c in chunks[:i + 1])
    assert py.ready
    nat.close()


def test_not_ready_and_small_ring_raise():
    sd = StreamingDecoder(lambda x: x, 4, 64)
    sd.push(np.zeros((4, 10), np.float32))
    assert not sd.ready
    with pytest.raises(RuntimeError, match="10/64"):
        sd.decode_latest()
    with pytest.raises(ValueError, match="ring_capacity"):
        StreamingDecoder(lambda x: x, 4, 64, native=True, ring_capacity=32)
    nat = StreamingDecoder(lambda x: x, 4, 64, native=True)
    assert nat._ring.capacity == 4 * 64  # the default: four windows
    nat.close()


def test_big_chunk_replaces_the_numpy_ring():
    sd = StreamingDecoder(lambda x: x, 4, 64)
    chunk = np.random.default_rng(1).normal(size=(4, 64 + 50))
    sd.push(chunk)
    assert sd.buffer.dtype == np.float32
    np.testing.assert_array_equal(sd.buffer, chunk[:, -64:].astype(np.float32))
