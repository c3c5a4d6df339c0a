"""Kernel B1's time-parallel route (``csrc/iir.cu``), emulated on the CPU in
float32, against the JAX package's IIR filters.

``cascade`` below walks a row as the kernel does: tiles from
``ops.cuda.iir.chunking`` (the causal entry) or of 32 x 31 samples (the
chain entry), 32 lanes of odd chunks per tile, each chunk
run from a zero state (the first from the true state), a Kogge-Stone scan
of the end states with the ``A^L`` powers of ``ops.cuda.iir.section_table``
(f64 on the host, rounded to f32), and each chunk's homogeneous response
added in the next section's pass. ``filtfilt`` wraps it in the chain
kernel's odd extension, seeding, reverse pass and crop. Held against the
JAX package's ``ops.filters.sosfilt`` (with ``zi``) and ``sosfiltfilt``,
and its Pallas kernel in interpret mode, at rtol 1e-4, atol 1e-4 *
max|ref| (``tests/test_pallas.py``'s tolerance), for the notch (poles at
radius ~0.975, where carry errors would grow first; S = 1), ``low2``
(S = 1), band-passes of S = 2, 4 and 8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

from imagined_speech_decoding_tpu.ops import filters as jax_filters
from imagined_speech_decoding_tpu.ops.pallas import sosfiltfilt_pallas
from imagined_speech_decoding_tpu_torch.ops.cuda.iir import (
    CHUNK_MAX,
    chunking,
    default_padlen,
    section_table,
)

torch.set_num_threads(1)

RTOL = 1e-4
LANES = 32
SOS = {
    "notch": sps.tf2sos(*sps.iirnotch(60.0, 30.0, fs=250.0)),
    "band4": sps.butter(4, [4.0 / 125, 40.0 / 125], btype="bandpass", output="sos"),
    "low2": sps.butter(2, 30.0 / 125, btype="lowpass", output="sos"),
    "band2": sps.butter(2, [4.0 / 125, 40.0 / 125], btype="bandpass", output="sos"),
    "band8": sps.butter(8, [4.0 / 125, 40.0 / 125], btype="bandpass", output="sos"),
}


def _shift(c, d):
    """Each lane's value from the lane ``d`` below it (zeros for the first
    ``d``): ``__shfl_up_sync`` over the lane axis 1."""
    out = torch.zeros_like(c)
    out[:, d:] = c[:, :-d]
    return out


def cascade(sos, x, seeds, lanes=LANES, exact=True):
    """The kernel's walk of ``x (R, n)`` through the sections of ``sos``
    from the true states ``seeds (R, 2S)``: returns ``(y, zf)``. ``exact``:
    the causal entry's walk (``chunking``; lanes stop at the row's end).
    Otherwise the chain entry's: chunks of ``CHUNK_MAX``, tiles of ``lanes *
    CHUNK_MAX``, the last one run past the row's end on its last sample
    (``zf`` is then not the row's)."""
    rows, n = x.shape
    sections = sos.shape[0]
    tile, chunk = chunking(n, lanes) if exact else (lanes * CHUNK_MAX, CHUNK_MAX)
    assert chunk <= CHUNK_MAX and chunk % 2 == 1
    tab = torch.as_tensor(section_table(sos, chunk))
    y = torch.empty_like(x)
    state = seeds.clone()
    lane = torch.arange(lanes)
    for t0 in range(0, n, tile):
        tile_len = min(tile, n - t0)
        if exact:
            length = (tile_len - lane * chunk).clamp(0, chunk)  # (G,)
            last = (tile_len - 1) // chunk
            v = torch.zeros((rows, lanes, chunk))
            v.view(rows, -1)[:, :tile_len] = x[:, t0 : t0 + tile_len]
        else:
            length = torch.full((lanes,), chunk)
            last = lanes - 1
            v = x[:, (t0 + torch.arange(tile)).clamp(max=n - 1)].reshape(rows, lanes, chunk)
        h = torch.zeros((rows, lanes, 2))
        prev_a, prev_e = (0.0, 0.0), None
        new_state = torch.empty_like(state)
        for s in range(sections):
            b0, b1, b2, a1, a2 = (float(c) for c in tab[s, :5])
            z = torch.zeros((rows, lanes, 2))
            z[:, 0] = state[:, 2 * s : 2 * s + 2]
            for j in range(chunk):
                live = (j < length)[None, :]
                xj = v[:, :, j] + h[..., 0]
                nh = torch.stack([-prev_a[0] * h[..., 0] + h[..., 1], -prev_a[1] * h[..., 0]], -1)
                yj = b0 * xj + z[..., 0]
                nz = torch.stack([(b1 * xj + z[..., 1]) - a1 * yj, b2 * xj - a2 * yj], -1)
                h = torch.where(live[..., None], nh, h)
                z = torch.where(live[..., None], nz, z)
                v[:, :, j] = torch.where(live, yj, v[:, :, j])
            if s > 0:
                new_state[:, 2 * s - 2 : 2 * s] = prev_e[:, last] + h[:, last]
            c = z.clone()
            for k in range(int(np.log2(lanes))):
                w = _shift(c, 1 << k)
                p = tab[s, 8 + 4 * k : 12 + 4 * k].view(2, 2)
                upd = c + w @ p.T
                c = torch.where((lane >= 1 << k)[None, :, None], upd, c)
            h = _shift(c, 1)
            prev_a, prev_e = (a1, a2), z
        for j in range(chunk):
            live = (j < length)[None, :]
            v[:, :, j] = torch.where(live, v[:, :, j] + h[..., 0], v[:, :, j])
            nh = torch.stack([-prev_a[0] * h[..., 0] + h[..., 1], -prev_a[1] * h[..., 0]], -1)
            h = torch.where(live[..., None], nh, h)
        new_state[:, 2 * sections - 2 :] = prev_e[:, last] + h[:, last]
        y[:, t0 : t0 + tile_len] = v.view(rows, -1)[:, :tile_len]
        state = new_state
    return y, state


def filtfilt(sos, x, padlen=None):
    """The chain kernel's zero-phase filter of ``x (R, T)``: odd extension,
    a forward walk seeded with ``zi * ext[0]``, a reverse walk seeded with
    ``zi * y[n - 1]``, the crop."""
    p = default_padlen(sos) if padlen is None else padlen
    zi = torch.as_tensor(sps.sosfilt_zi(sos).reshape(1, -1), dtype=torch.float32)
    t_len = x.shape[-1]
    ext = torch.cat([2 * x[:, :1] - x[:, 1 : p + 1].flip(-1), x,
                     2 * x[:, -1:] - x[:, t_len - 1 - p : t_len - 1].flip(-1)], -1)
    fwd, _ = cascade(sos, ext, zi * ext[:, :1], exact=False)
    rev, _ = cascade(sos, fwd.flip(-1), zi * fwd[:, -1:], exact=False)
    return rev.flip(-1)[:, p : p + t_len]


def _close(ours, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=RTOL, atol=RTOL * np.abs(ref).max())


def _signal(t_len, rows=4, seed=0):
    rng = np.random.default_rng(seed + t_len)
    x = rng.normal(size=(rows, t_len))
    return (np.cumsum(x, -1) * 0.05 + x).astype(np.float32)


@pytest.mark.parametrize("t_len", [400, 800, 2048])
@pytest.mark.parametrize("name", sorted(SOS))
def test_causal_walk_with_zi_matches_jax(name, t_len):
    sos = SOS[name]
    x = _signal(t_len)
    zi = np.random.default_rng(1).normal(size=(4, sos.shape[0], 2)).astype(np.float32)
    y, zf = cascade(sos, torch.from_numpy(x), torch.from_numpy(zi.reshape(4, -1)))
    y_ref, zf_ref = jax_filters.sosfilt(sos, jnp.asarray(x), zi=jnp.asarray(zi))
    _close(y, y_ref)
    _close(zf.view(4, -1, 2), zf_ref)


@pytest.mark.parametrize("t_len", [400, 800, 2048])
@pytest.mark.parametrize("name", sorted(SOS))
def test_zero_phase_walk_matches_jax(name, t_len):
    x = _signal(t_len)
    _close(filtfilt(SOS[name], torch.from_numpy(x)),
           jax_filters.sosfiltfilt(SOS[name], jnp.asarray(x)))


@pytest.mark.parametrize("name", ["notch", "band4"])
def test_zero_phase_walk_matches_pallas_interpret(name):
    x = _signal(800, rows=3)
    _close(filtfilt(SOS[name], torch.from_numpy(x)),
           sosfiltfilt_pallas(SOS[name], jnp.asarray(x), interpret=True))


def test_decode_chain_matches_jax():
    """The decoder's notch then band-pass, as one chain launch walks it."""
    x = _signal(800, rows=3, seed=5)
    ours = filtfilt(SOS["band4"], filtfilt(SOS["notch"], torch.from_numpy(x)))
    ref = jax_filters.sosfiltfilt(SOS["band4"], jax_filters.sosfiltfilt(SOS["notch"],
                                                                         jnp.asarray(x)))
    _close(ours, ref)


@pytest.mark.parametrize("padlen", [0, 1, 50])
def test_explicit_padlen_matches_scipy(padlen):
    x = _signal(400, rows=2)
    _close(filtfilt(SOS["low2"], torch.from_numpy(x), padlen),
           sps.sosfiltfilt(SOS["low2"], x.astype(np.float64), padlen=padlen))


@pytest.mark.parametrize("n,lanes", [(818, 32), (854, 32), (2102, 32), (10, 32), (854, 8),
                                     (337, 1)])
def test_chunking_covers_the_row(n, lanes):
    tile, chunk = chunking(n, lanes)
    assert chunk % 2 == 1 and chunk <= CHUNK_MAX and tile <= lanes * chunk
    assert -(-n // tile) == -(-n // (lanes * CHUNK_MAX))  # no more tiles than needed
