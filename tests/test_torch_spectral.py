"""The port's windowing, filtering and spectral ops (``ops/windowing.py``,
``ops/filters.py``, ``ops/spectral.py``) against the JAX package's on the
CPU, on the same numpy inputs (8 channels x 256 samples at 250 Hz, as the
JAX package's tests/test_baseline_pipelines.py).

Tolerances. Windowing is exact. The spectra: rtol 1e-4 (the JAX
package's own pin against SciPy), with an absolute floor of 1e-6 x
max|ref| for the bins near zero, where the two FFTs' roundings (pocketfft
in both, with their own plans) are all that differs. The filters: rtol
1e-4, atol 1e-4 x max|ref| (B1's tolerance, tests/test_pallas.py): an IIR
carries each rounding into every later sample. Log band powers: rtol
1e-4 and atol 1e-5, for the logs of powers near 1 (log ~ 0)."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import butter

from imagined_speech_decoding_tpu.ops import filters as jax_filters
from imagined_speech_decoding_tpu.ops import spectral as jax_spectral
from imagined_speech_decoding_tpu.ops import windowing as jax_windowing
from imagined_speech_decoding_tpu_torch.ops import filters, spectral, windowing

torch.set_num_threads(1)

RTOL = 1e-4
FS = 250.0


@pytest.fixture(scope="module")
def x():
    rng = np.random.default_rng(0)
    t = np.arange(256) / FS
    tones = sum(np.sin(2 * np.pi * f * t + p) for f, p in ((6.0, 0.3), (11.0, 1.0), (40.0, 2.0)))
    return (rng.normal(size=(4, 8, 256)) + tones).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def spectrum_close(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    atol = 1e-6 * np.abs(ref).max()
    if np.iscomplexobj(ref):
        for part in (np.real, np.imag):
            np.testing.assert_allclose(part(ours), part(ref), rtol=RTOL, atol=atol)
    else:
        np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=atol)


def filter_close(ours, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=RTOL, atol=RTOL * np.abs(ref).max())


def test_windowing_matches_jax(x):
    """``num_windows``, ``sliding_window`` (a view), ``edge_pad``,
    ``baseline_correct``, ``epoch_continuous`` and ``zone_gather``,
    element for element."""
    xt = _t(x)
    assert windowing.num_windows(800, 250, 125) == jax_windowing.num_windows(800, 250, 125) == 5
    for w, s in ((64, 16), (100, 50), (7, 1)):
        ours = windowing.sliding_window(xt, w, s)
        assert ours.data_ptr() == xt.data_ptr()
        np.testing.assert_array_equal(ours.numpy(), jax_windowing.sliding_window(jnp.asarray(x),
                                                                                 w, s))
    with pytest.raises(ValueError, match="no window"):
        windowing.sliding_window(xt, 300, 1)
    np.testing.assert_array_equal(windowing.edge_pad(xt[..., :251], 256).numpy(),
                                  jax_windowing.edge_pad(jnp.asarray(x[..., :251]), 256))
    assert windowing.edge_pad(xt, 200) is xt
    np.testing.assert_allclose(windowing.baseline_correct(xt, 25).numpy(),
                               jax_windowing.baseline_correct(jnp.asarray(x), 25), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(windowing.epoch_continuous(xt, [0, 17, 100], 64).numpy(),
                                  jax_windowing.epoch_continuous(jnp.asarray(x), [0, 17, 100], 64))
    indices = np.array([[0, 3, 5], [1, 2, 0], [7, 0, 0]])
    mask = np.array([[1, 1, 1], [1, 1, 0], [1, 0, 0]], np.float32)
    ours, m = windowing.zone_gather(xt, indices, mask)
    ref, rm = jax_windowing.zone_gather(jnp.asarray(x), indices, mask)
    np.testing.assert_array_equal(ours.numpy(), ref)
    np.testing.assert_array_equal(m.numpy(), rm)


@pytest.mark.parametrize("nperseg,noverlap", [(64, 32), (64, 56), (50, None), (33, 20)])
def test_stft_matches_jax(x, nperseg, noverlap):
    """``stft`` (SciPy's zero boundary and padding, ``scaling='spectrum'``):
    frequencies and times exactly, the complex spectrum at the spectra's
    tolerance."""
    f, t, z = spectral.stft(_t(x), fs=FS, nperseg=nperseg, noverlap=noverlap)
    rf, rt, rz = jax_spectral.stft(jnp.asarray(x), fs=FS, nperseg=nperseg, noverlap=noverlap)
    np.testing.assert_array_equal(f, rf)
    np.testing.assert_array_equal(t, rt)
    spectrum_close(z.numpy(), rz)
    with pytest.raises(NotImplementedError):
        spectral.stft(_t(x), window="hamming")


def test_welch_psd_matches_jax_and_scipy_rules(x):
    """``welch_psd`` at 128 and 100 samples a segment; an ``nperseg`` past the
    signal is clamped with SciPy's warning, in both; ``noverlap >= nperseg``
    raises SciPy's ``ValueError`` in both, also after the clamp."""
    for nperseg, noverlap in ((128, None), (100, 60)):
        f, p = spectral.welch_psd(_t(x), fs=FS, nperseg=nperseg, noverlap=noverlap)
        rf, rp = jax_spectral.welch_psd(jnp.asarray(x), fs=FS, nperseg=nperseg, noverlap=noverlap)
        np.testing.assert_array_equal(f, rf)
        spectrum_close(p.numpy(), rp)
    short = x[..., :100]
    with pytest.warns(UserWarning, match="nperseg = 256 is greater") as ours_w:
        f, p = spectral.welch_psd(_t(short), fs=FS, nperseg=256)
    with pytest.warns(UserWarning, match="nperseg = 256 is greater") as ref_w:
        rf, rp = jax_spectral.welch_psd(jnp.asarray(short), fs=FS, nperseg=256)
    assert str(ours_w[0].message) == str(ref_w[0].message)
    np.testing.assert_array_equal(f, rf)
    spectrum_close(p.numpy(), rp)
    for args in (dict(nperseg=64, noverlap=64), dict(nperseg=256, noverlap=100)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with pytest.raises(ValueError, match="must be less than nperseg"):
                spectral.welch_psd(_t(short), **args)
            with pytest.raises(ValueError, match="must be less than nperseg"):
                jax_spectral.welch_psd(jnp.asarray(short), **args)


@pytest.mark.parametrize("log", [True, False])
def test_band_power_and_features_match_jax(x, log):
    """``band_power`` over the canonical bands (inclusive edges) and over a
    band between bins; ``log_bandpower_features``' ``(..., C * 5)`` layout."""
    bands = list(spectral.BANDS.values()) + [(50.0, 50.5)]
    ours = spectral.band_power(_t(x), FS, bands, nperseg=128, log=log)
    ref = jax_spectral.band_power(jnp.asarray(x), FS, bands, nperseg=128, log=log)
    if log:
        np.testing.assert_allclose(ours.numpy(), ref, rtol=RTOL, atol=1e-5)
    else:
        spectrum_close(ours.numpy(), ref)
    feats = spectral.log_bandpower_features(_t(x), FS, nperseg=128)
    assert feats.shape == (4, 8 * 5)
    np.testing.assert_allclose(feats.numpy(),
                               jax_spectral.log_bandpower_features(jnp.asarray(x), FS, nperseg=128),
                               rtol=RTOL, atol=1e-5)


def test_band_stft_heatmap_matches_jax(x):
    """Mean ``|STFT|`` per band; the Delta band has no bin at nperseg 16
    and takes its nearest, in both."""
    for nperseg, noverlap in ((64, 32), (16, 8)):
        names, times, ours = spectral.band_stft_heatmap(_t(x), FS, nperseg, noverlap)
        rnames, rtimes, ref = jax_spectral.band_stft_heatmap(jnp.asarray(x), FS, nperseg,
                                                             noverlap)
        assert names == rnames
        np.testing.assert_array_equal(times, rtimes)
        spectrum_close(ours.numpy(), ref)


@pytest.mark.parametrize("method", ["iir", "fir"])
def test_bandpass_and_filterbank_match_jax(x, method):
    """``bandpass_filter`` both ways (the IIR as one B1 chain, here its plain
    version; the FIR through ``fir_filter``) and a two-band
    ``filterbank``."""
    filter_close(filters.bandpass_filter(_t(x), FS, 8.0, 30.0, method=method).numpy(),
                 jax_filters.bandpass_filter(jnp.asarray(x), FS, 8.0, 30.0, method=method))
    bank = spectral.filterbank(_t(x), FS, [(4.0, 8.0), (13.0, 30.0)], method=method)
    assert bank.shape == (4, 8, 2, 256)
    filter_close(bank.numpy(), jax_spectral.filterbank(jnp.asarray(x), FS, [(4.0, 8.0),
                                                                            (13.0, 30.0)],
                                                       method=method))
    with pytest.raises(ValueError, match="unknown method"):
        filters.bandpass_filter(_t(x), FS, 8.0, 30.0, method="fft")


@pytest.mark.parametrize("l_freq,h_freq", [(4.0, 40.0), (None, 30.0), (8.0, None)])
def test_mne_style_taps_and_fir_filter_match_jax(x, l_freq, h_freq):
    """The MNE-default taps (band, low and high pass) equal the JAX
    package's; ``fir_filter`` zero-phase (reflected edges) and causal."""
    taps = filters.mne_style_fir_taps(FS, l_freq, h_freq)
    np.testing.assert_array_equal(taps, jax_filters.mne_style_fir_taps(FS, l_freq, h_freq))
    if len(taps) // 2 >= x.shape[-1]:
        taps = taps[len(taps) // 2 - 100: len(taps) // 2 + 101]
    for zero_phase in (True, False):
        filter_close(filters.fir_filter(taps, _t(x), zero_phase=zero_phase).numpy(),
                     jax_filters.fir_filter(taps, jnp.asarray(x), zero_phase=zero_phase))


def test_lfilter_filtfilt_and_notch_match_jax(x):
    """``lfilter`` (with and without an initial state, whose final state
    comes back), ``filtfilt`` (``lfilter_zi`` seeding, default and explicit
    padlen) and ``notch_filter`` (the notch as one B1 section with
    ``filtfilt``'s padlen, here the plain chain) against JAX's scans."""
    b, a = butter(2, [0.1, 0.3], btype="band")
    xt = _t(x[:2])
    filter_close(filters.lfilter(b, a, xt).numpy(), jax_filters.lfilter(b, a, jnp.asarray(x[:2])))
    zi = np.random.default_rng(1).normal(size=(2, 8, 4)).astype(np.float32)
    y, zf = filters.lfilter(b, a, xt, zi=_t(zi))
    ry, rzf = jax_filters.lfilter(b, a, jnp.asarray(x[:2]), zi=jnp.asarray(zi))
    filter_close(y.numpy(), ry)
    filter_close(zf.numpy(), rzf)
    nb, na = filters.notch_ba(FS, 60.0)
    for padlen in (None, 20):
        filter_close(filters.filtfilt(nb, na, xt, padlen=padlen).numpy(),
                     jax_filters.filtfilt(nb, na, jnp.asarray(x[:2]), padlen=padlen))
    filter_close(filters.notch_filter(_t(x), FS).numpy(),
                 jax_filters.notch_filter(jnp.asarray(x), FS))
    filter_close(filters.notch_filter(_t(x), FS, 50.0, 20.0).numpy(),
                 jax_filters.notch_filter(jnp.asarray(x), FS, 50.0, 20.0))
