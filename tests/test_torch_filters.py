"""PyTorch port's IIR filters (plain path on the CPU) against the JAX
package's scan path, its Pallas kernel in interpret mode, and SciPy."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

from imagined_speech_decoding_tpu.ops import filters as jax_filters
from imagined_speech_decoding_tpu.ops.pallas import sosfiltfilt_pallas
from imagined_speech_decoding_tpu_torch.ops import filters
from imagined_speech_decoding_tpu_torch.ops.cuda.iir import (
    prepare_filter,
    sosfilt_time_major,
    sosfilt_time_major_plain,
    sosfiltfilt_chain,
    sosfiltfilt_chain_plain,
)

torch.set_num_threads(1)

RTOL = 1e-4  # tests/test_pallas.py; atol = RTOL * max|ref|


def _close(ours, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        np.asarray(ours), ref, rtol=RTOL, atol=RTOL * np.abs(ref).max()
    )


SOS = {
    "band4": sps.butter(4, [4.0 / 125, 40.0 / 125], btype="bandpass", output="sos"),
    "low2": sps.butter(2, 30.0 / 125, btype="lowpass", output="sos"),
    "notch": sps.tf2sos(*sps.iirnotch(60.0, 30.0, fs=250.0)),
}


@pytest.fixture(scope="module")
def eeg():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 4, 400)).astype(np.float64)
    x = np.cumsum(x, axis=-1) * 0.05 + x
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def eeg_full():
    """Two full-width trials (64 channels x 800 samples)."""
    return np.random.default_rng(1).normal(size=(2, 64, 800)).astype(np.float32)


class TestSosfilt:
    @pytest.mark.parametrize("name", sorted(SOS))
    def test_matches_jax_scan_with_zi(self, eeg, name):
        sos = SOS[name]
        zi = np.random.default_rng(2).normal(size=eeg.shape[:-1] + (sos.shape[0], 2))
        zi = zi.astype(np.float32)
        y, zf = filters.sosfilt(sos, torch.from_numpy(eeg), zi=torch.from_numpy(zi))
        y_ref, zf_ref = jax_filters.sosfilt(sos, jnp.asarray(eeg), zi=jnp.asarray(zi))
        _close(y, y_ref)
        _close(zf, zf_ref)

    def test_matches_scipy(self, eeg):
        sos = SOS["band4"]
        _close(filters.sosfilt(sos, torch.from_numpy(eeg)), sps.sosfilt(sos, eeg.astype(np.float64)))

    def test_chunked_continuation_matches_whole(self, eeg):
        """Two chunks joined through the returned zf equal one pass."""
        sos = SOS["band4"]
        x = torch.from_numpy(eeg)
        zi0 = torch.zeros(eeg.shape[:-1] + (sos.shape[0], 2))
        whole, _ = filters.sosfilt(sos, x, zi=zi0)
        half = eeg.shape[-1] // 2
        y1, zf = filters.sosfilt(sos, x[..., :half], zi=zi0)
        y2, _ = filters.sosfilt(sos, x[..., half:], zi=zf)
        torch.testing.assert_close(torch.cat([y1, y2], dim=-1), whole, rtol=1e-5, atol=1e-5)

    def test_cpu_route_is_plain_and_uncounted(self, eeg):
        sos = SOS["notch"]
        xt = torch.from_numpy(eeg.reshape(-1, eeg.shape[-1]).T.copy())
        before = sosfilt_time_major.launches
        y, zf = sosfilt_time_major(sos, xt)
        y_plain, zf_plain = sosfilt_time_major_plain(sos, xt)
        assert sosfilt_time_major.launches == before
        assert torch.equal(y, y_plain) and torch.equal(zf, zf_plain)

    def test_non_cpu_tensor_never_falls_back(self):
        """A tensor off the CPU goes to the kernel's checks, never to the
        plain loop: here a meta tensor is refused as not CUDA."""
        xt = torch.zeros((10, 3), device="meta")
        with pytest.raises(ValueError, match="CUDA tensor"):
            sosfilt_time_major(SOS["low2"], xt)

    def test_unbuilt_section_count_raises(self):
        """The kernel takes S = 1 to 8; a longer cascade off the CPU is
        refused before it is launched."""
        sos = sps.butter(9, [4.0 / 125, 40.0 / 125], btype="bandpass", output="sos")
        assert sos.shape[0] == 9
        xt = torch.zeros((10, 3), device="meta")
        with pytest.raises(ValueError, match="built for S in"):
            sosfilt_time_major(sos, xt)


class TestSosfiltfilt:
    @pytest.mark.parametrize("name", sorted(SOS))
    def test_matches_jax_scan(self, eeg, name):
        ours = filters.sosfiltfilt(SOS[name], torch.from_numpy(eeg))
        _close(ours, jax_filters.sosfiltfilt(SOS[name], jnp.asarray(eeg)))

    @pytest.mark.parametrize("name", ["band4", "notch"])
    def test_matches_pallas_interpret(self, eeg, name):
        ours = filters.sosfiltfilt(SOS[name], torch.from_numpy(eeg))
        _close(ours, sosfiltfilt_pallas(SOS[name], jnp.asarray(eeg), interpret=True))

    @pytest.mark.parametrize("name", sorted(SOS))
    def test_matches_scipy(self, eeg, name):
        ours = filters.sosfiltfilt(SOS[name], torch.from_numpy(eeg))
        _close(ours, sps.sosfiltfilt(SOS[name], eeg.astype(np.float64), axis=-1))

    def test_serving_chain_full_width_matches_jax(self, eeg_full):
        """The decode chain's notch then band-pass on (2, 64, 800)."""
        x = torch.from_numpy(eeg_full)
        ours = filters.sosfiltfilt(SOS["band4"], filters.sosfiltfilt(SOS["notch"], x))
        xj = jnp.asarray(eeg_full)
        ref = jax_filters.sosfiltfilt(SOS["band4"], jax_filters.sosfiltfilt(SOS["notch"], xj))
        _close(ours, ref)

    def test_explicit_padlen(self, eeg):
        ours = filters.sosfiltfilt(SOS["low2"], torch.from_numpy(eeg), padlen=50)
        _close(ours, sps.sosfiltfilt(SOS["low2"], eeg.astype(np.float64), padlen=50))

    def test_short_input_raises_like_scipy(self):
        with pytest.raises(ValueError, match="greater than padlen"):
            filters.sosfiltfilt(SOS["band4"], torch.zeros(2, 20))

    def test_design_matches_jax(self):
        np.testing.assert_array_equal(
            filters.butter_sos(250.0, 4.0, 40.0), jax_filters.butter_sos(250.0, 4.0, 40.0)
        )
        for a, b in zip(filters.notch_ba(250.0, 60.0), jax_filters.notch_ba(250.0, 60.0)):
            np.testing.assert_array_equal(a, b)


class TestSosfiltfiltChain:
    """The chain entry on the CPU: the plain version, on the prepared
    filters' ``sosfilt_zi`` and ``padlen``."""

    def test_equals_the_old_composition_bit_for_bit(self, eeg_full):
        x = torch.from_numpy(eeg_full)
        chain = [prepare_filter(SOS["notch"]), prepare_filter(SOS["band4"])]
        before = sosfiltfilt_chain.launches
        ours = sosfiltfilt_chain(chain, x)
        assert sosfiltfilt_chain.launches == before
        old = filters.sosfiltfilt(SOS["band4"], filters.sosfiltfilt(SOS["notch"], x))
        assert torch.equal(ours, old)
        assert torch.equal(ours, sosfiltfilt_chain_plain(chain, x))

    def test_serving_chain_full_width_matches_jax(self, eeg_full):
        ours = sosfiltfilt_chain([prepare_filter(SOS["notch"]), prepare_filter(SOS["band4"])],
                                 torch.from_numpy(eeg_full))
        xj = jnp.asarray(eeg_full)
        _close(ours, jax_filters.sosfiltfilt(SOS["band4"], jax_filters.sosfiltfilt(SOS["notch"], xj)))

    @pytest.mark.parametrize("padlens", [(0, 5), (50, 0)])
    def test_explicit_padlens_match_scipy(self, eeg, padlens):
        chain = [prepare_filter(SOS["low2"]), prepare_filter(SOS["notch"])]
        ours = sosfiltfilt_chain(chain, torch.from_numpy(eeg), padlens=padlens)
        ref = eeg.astype(np.float64)
        for name, p in zip(("low2", "notch"), padlens):
            ref = sps.sosfiltfilt(SOS[name], ref, padlen=p)
        _close(ours, ref)

    def test_short_input_raises_like_scipy(self):
        with pytest.raises(ValueError, match="greater than padlen"):
            sosfiltfilt_chain([prepare_filter(SOS["band4"])], torch.zeros(2, 27))

    def test_limits_are_refused(self):
        with pytest.raises(ValueError, match="1 to 8 sections"):
            prepare_filter(sps.butter(9, [4.0 / 125, 40.0 / 125], btype="bandpass", output="sos"))
        chain = [prepare_filter(SOS["notch"])] * 3
        with pytest.raises(ValueError, match="1 to 2 filters"):
            sosfiltfilt_chain(chain, torch.zeros(2, 100))
        with pytest.raises(ValueError, match="up to 6144 samples"):
            sosfiltfilt_chain(chain[:1], torch.zeros((2, 6200), device="meta"))

    def test_non_cpu_tensor_never_falls_back(self):
        with pytest.raises(ValueError, match="CUDA tensor"):
            sosfiltfilt_chain([prepare_filter(SOS["notch"])], torch.zeros((3, 100), device="meta"))
