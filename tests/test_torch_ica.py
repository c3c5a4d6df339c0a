"""``ops.ica.fast_ica`` against scikit-learn's ``FastICA`` with the artifact
CLI's settings, and ``cli.artifact_analysis`` against the JAX CLI, on the
CPU.

FastICA is held at 1e-6 (relative to max|ref|) in float64: ``mixing_``,
``components_``, the sources and ``n_iter_`` (equal). In float32 it is
held at 5e-4 * max|ref| on the CLI's own input (100 synthetic trials, 15
components: 80,000 x 64), and its mixing matrix no farther from sklearn's
float64 one than twice sklearn's own float32 run is. On a 12-trial input,
which converges slowly, float32 rounding grows through the iterations in
both packages alike, so float32 is compared on the CLI's input only.
"""

import os
import warnings

import numpy as np
import pytest
import torch

from imagined_speech_decoding_tpu_torch.cli import artifact_analysis
from imagined_speech_decoding_tpu_torch.data.synthetic import synthetic_trials
from imagined_speech_decoding_tpu_torch.ops.ica import ConvergenceWarning, fast_ica

torch.set_num_threads(1)
sklearn_decomposition = pytest.importorskip("sklearn.decomposition")


def _cli_input(n_trials, seed):
    """The JAX artifact CLI's ICA input: trials end to end, centred."""
    x, _ = synthetic_trials(seed, n_trials, 64, 800)
    cont = np.transpose(x, (1, 0, 2)).reshape(64, -1).T
    return cont - cont.mean(0)


def _mixture():
    """Five non-Gaussian sources mixed into 12 channels."""
    rng = np.random.default_rng(0)
    n = 4000
    src = np.stack([rng.laplace(size=n), rng.uniform(-1, 1, n),
                    np.sign(rng.normal(size=n)) * rng.exponential(size=n),
                    np.sin(np.arange(n) / 7.0), rng.laplace(size=n) ** 3], 1)
    return src @ rng.normal(size=(5, 12)) + 0.01 * rng.normal(size=(n, 12))


def _sklearn(x, k, seed, max_iter=500):
    ica = sklearn_decomposition.FastICA(n_components=k, random_state=seed, max_iter=max_iter,
                                        whiten="unit-variance")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sources = ica.fit_transform(x.copy())
    return ica, sources, [w.category.__name__ for w in caught]


def _held(got, ica, sources, rel, x=None):
    """Each array within ``rel * max|ref|``; the feature means (of ``x``,
    when given) within ``rel * max|x|``."""
    for ours, ref in ((got.mixing, ica.mixing_), (got.components, ica.components_),
                      (got.sources, sources)):
        assert ours.dtype == torch.from_numpy(ref).dtype
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=rel * np.abs(ref).max())
    if x is not None:
        np.testing.assert_allclose(got.mean.numpy(), ica.mean_, rtol=0,
                                   atol=rel * np.abs(x).max())
    assert got.n_iter == ica.n_iter_


@pytest.mark.parametrize("data", ["cli_12_trials", "cli_100_trials", "mixture"])
def test_fast_ica_matches_sklearn_in_float64(data):
    x, k, seed = {"cli_12_trials": (_cli_input(12, 3), 15, 3),
                  "cli_100_trials": (_cli_input(100, 0), 15, 0),
                  "mixture": (_mixture(), 5, 3)}[data]
    x = x.astype(np.float64)
    ica, sources, caught = _sklearn(x, k, seed)
    assert not caught
    _held(fast_ica(torch.from_numpy(x), k, seed=seed, max_iter=500), ica, sources, 1e-6, x)


def test_fast_ica_matches_sklearn_in_float32():
    x = _cli_input(100, 0)
    assert x.dtype == np.float32
    ica, sources, _ = _sklearn(x, 15, 0)
    got = fast_ica(torch.from_numpy(x), 15, seed=0, max_iter=500)
    _held(got, ica, sources, 5e-4, x)
    ref64 = _sklearn(x.astype(np.float64), 15, 0)[0].mixing_
    scale = np.abs(ref64).max()
    own = np.abs(ica.mixing_ - ref64).max() / scale  # sklearn's float32 against its float64
    assert np.abs(got.mixing.numpy() - ref64).max() / scale <= 2 * own


def test_fast_ica_warns_as_sklearn_does():
    """Stopped at ``max_iter`` it warns ``ConvergenceWarning`` and keeps the
    iterate, as sklearn; ``n_components`` past the features is clamped
    with a warning."""
    x = _cli_input(12, 3).astype(np.float64)
    ica, sources, caught = _sklearn(x, 15, 3, max_iter=3)
    assert caught == ["ConvergenceWarning"]
    with pytest.warns(ConvergenceWarning, match="did not converge"):
        got = fast_ica(torch.from_numpy(x), 15, seed=3, max_iter=3)
    _held(got, ica, sources, 1e-6, x)
    small = _mixture()[:, :4]
    ica, sources, caught = _sklearn(small, 6, 1)
    assert "UserWarning" in caught and ica.mixing_.shape == (4, 4)
    with pytest.warns(UserWarning, match="n_components is too large: it will be set to 4"):
        got = fast_ica(torch.from_numpy(small), 6, seed=1)
    _held(got, ica, sources, 1e-6, small)


def test_artifact_analysis_matches_the_jax_cli(tmp_path):
    """``psd.npz`` equals the JAX CLI's (and SciPy's Welch), the same files
    are written, and the CLI's ICA equals sklearn's on its input."""
    import scipy.signal as sps

    from imagined_speech_decoding_tpu.cli import artifact_analysis as jax_cli

    argv = ["--synthetic", "--n_trials", "12", "--n_components", "5", "--seed", "3"]
    jax_cli.main(argv + ["--output_dir", str(tmp_path / "jax")])
    out = artifact_analysis.main(argv + ["--output_dir", str(tmp_path / "port")], device="cpu")
    assert sorted(os.listdir(out)) == sorted(os.listdir(tmp_path / "jax"))
    ours, ref = np.load(os.path.join(out, "psd.npz")), np.load(tmp_path / "jax" / "psd.npz")
    assert sorted(ours.files) == sorted(ref.files) == ["freqs", "pxx"]
    np.testing.assert_array_equal(ours["freqs"], ref["freqs"])
    np.testing.assert_allclose(ours["pxx"], ref["pxx"], rtol=1e-5, atol=0)
    x, _ = synthetic_trials(3, 12, 64, 800)
    _, p_ref = sps.welch(x.astype(np.float64), fs=250, nperseg=256)
    np.testing.assert_allclose(ours["pxx"], p_ref.mean(0), rtol=1e-4, atol=1e-8)

    mix = _mixture()  # (4000, 12): one trial of 12 channels
    arrays = artifact_analysis.qc_arrays(torch.from_numpy(mix.T[None].copy()), 5, 3)
    ica, sources, _ = _sklearn(mix - mix.mean(0), 5, 3)
    _held(arrays["ica"], ica, sources, 1e-6)
