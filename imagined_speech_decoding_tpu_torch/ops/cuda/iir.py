"""Biquad-cascade IIR: CUDA kernel B1, its two entries and their plain
PyTorch versions.

Replaces ``imagined_speech_decoding_tpu/ops/pallas/iir.py``
(``sosfilt_time_major``, kernel body ``_make_kernel``). The kernel source
is ``csrc/iir.cu``; its header says what bounds it on the H100 and how it
walks time in parallel. Two entries share one device routine:

- ``sosfilt_time_major(sos, xt (T, R), zi)`` -> ``(y, zf)``: the TPU
  kernel's own causal interface. ``ops.filters.sosfilt`` and
  ``sosfiltfilt`` go through it.
- ``sosfiltfilt_chain(filters, x (..., T))``: a chain of one or two
  zero-phase filters (SciPy's ``sosfiltfilt`` defaults each: odd
  extension, ``sosfilt_zi`` seeding, forward and reverse pass, crop) in
  one launch, on filters made once by ``prepare_filter``. The online
  decoder runs its notch and band-pass through it.

Both take a row's time axis in chunks, one per lane of a warp: each
chunk runs from a zero state, the chunks' end states are combined by a
warp scan with the chunk transition ``A^L`` of each section (computed
here in f64 and rounded to f32, once per filter and chunk length), and
each chunk adds its homogeneous response to the carry it receives.
``section_table`` lays these constants out for the kernel.

Routing: a CPU tensor goes to the plain version; a CUDA tensor launches
the kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _lib

MAX_SECTIONS = 8  # csrc/iir.cu kMaxSections
CHUNK_MAX = 31  # csrc/iir.cu kChunkMax: samples a lane holds in registers
MAX_CHAIN = 2  # filters one chain launch applies
MAX_EXTENDED = 6144  # csrc/iir.cu kMaxExtended: longest extended row the chain stages
SECTION_FLOATS = 32  # one section's record in a table (csrc/iir.cu kSectionFloats)
LANES = (1, 2, 4, 8, 16, 32)
POWERS = 5  # A^(L 2^k) for k < log2(32): enough for every lane count


def coefficients(sos: np.ndarray) -> np.ndarray:
    """``(S, 6)`` scipy sections, a0-normalised in f64, then rounded to
    f32 — the constants both the scan path and the Pallas kernel use."""
    sos = np.asarray(sos, np.float64)
    return np.ascontiguousarray(sos / sos[:, 3:4], dtype=np.float32)


def default_padlen(sos: np.ndarray) -> int:
    """``scipy.signal.sosfiltfilt``'s default ``padlen`` for ``sos``."""
    sos = np.asarray(sos, np.float64)
    ntaps = 2 * sos.shape[0] + 1
    ntaps -= min((sos[:, 2] == 0).sum(), (sos[:, 5] == 0).sum())
    return 3 * int(ntaps)


def lanes_for(rows: int, causal: bool = False) -> int:
    """Lanes of a warp that share one row, from the row count (measured on
    an H100; ``csrc/iir.cu``'s header): 32 up to 2,048 rows (serving: the
    shortest chain per row), 16 above. The causal entry walks more than
    8,192 rows one lane a row, with no scan: there are rows enough to fill
    the card, and the scan's fix-up would only add work."""
    if causal and rows > 8192:
        return 1
    return 32 if rows <= 2048 else 16


def chunking(n: int, lanes: int) -> Tuple[int, int]:
    """``(tile, chunk)`` of the causal entry's exact walk of a row of ``n``
    samples: tiles of ``tile`` samples, each cut into ``lanes`` chunks of
    ``chunk`` samples (the last lanes' chunks shorter or empty). ``chunk``
    is odd (lanes read shared memory at a stride of ``chunk`` words, so no
    two of them share a bank) and at most ``CHUNK_MAX``. The chain entry
    walks chunks of ``CHUNK_MAX`` and tiles of ``lanes * CHUNK_MAX``."""
    n_tiles = max(1, -(-n // (lanes * CHUNK_MAX)))
    tile = -(-n // n_tiles) if n else 1
    return tile, -(-tile // lanes) | 1


def section_table(sos: np.ndarray, chunk: int, zi: Optional[np.ndarray] = None) -> np.ndarray:
    """``(S, SECTION_FLOATS)`` f32 records, one per section: ``b0 b1 b2 a1
    a2`` (a0-normalised), the seed state ``zi`` (zeros when None), a
    spare word, then ``A^(chunk * 2^k)`` row-major for ``k < POWERS``,
    where ``A = [[-a1, 1], [-a2, 0]]`` moves a section's state by one
    sample when its input is 0. Powers in f64, rounded once. G lanes a
    row read the first ``log2(G)`` of them, so one table serves every G."""
    sos = np.asarray(sos, np.float64)
    sos = sos / sos[:, 3:4]
    table = np.zeros((sos.shape[0], SECTION_FLOATS), np.float64)
    table[:, :5] = sos[:, [0, 1, 2, 4, 5]]
    if zi is not None:
        table[:, 5:7] = zi
    for s, (_, _, _, _, a1, a2) in enumerate(sos):
        power = np.linalg.matrix_power(np.array([[-a1, 1.0], [-a2, 0.0]]), chunk)
        for k in range(POWERS):
            table[s, 8 + 4 * k : 12 + 4 * k] = power.reshape(-1)
            power = power @ power
    return table.astype(np.float32)


@dataclass
class PreparedFilter:
    """One zero-phase filter, made once: the a0-normalised sections, their
    ``sosfilt_zi`` (f64) and the default ``padlen``. ``table`` caches the
    kernel's constants per (chunk, device)."""

    sos: np.ndarray  # (S, 6) f64 as designed
    zi: np.ndarray  # (S, 2) f64, scipy.signal.sosfilt_zi
    padlen: int
    _tables: Dict[tuple, torch.Tensor] = field(default_factory=dict, repr=False)

    @property
    def n_sections(self) -> int:
        return self.sos.shape[0]

    def table(self, chunk: int, device) -> torch.Tensor:
        key = (chunk, str(device))
        if key not in self._tables:
            self._tables[key] = torch.as_tensor(
                section_table(self.sos, chunk, self.zi), device=device)
        return self._tables[key]


def prepare_filter(sos: np.ndarray, padlen: Optional[int] = None) -> PreparedFilter:
    """Make ``sos`` ready for ``sosfiltfilt_chain``: SciPy's ``sosfilt_zi``
    and ``padlen`` are computed here, once, and never per call."""
    from scipy.signal import sosfilt_zi  # host-side design only

    sos = np.asarray(sos, np.float64)
    if not 1 <= sos.shape[0] <= MAX_SECTIONS:
        raise ValueError(f"the kernel takes 1 to {MAX_SECTIONS} sections, got {sos.shape[0]}")
    return PreparedFilter(sos, np.asarray(sosfilt_zi(sos), np.float64),
                          default_padlen(sos) if padlen is None else int(padlen))


def load_tables(filters: Sequence[PreparedFilter], device) -> None:
    """Put the chain kernel's constants on ``device`` now, so that no later
    call copies them."""
    for f in filters:
        f.table(CHUNK_MAX, device)


def sosfilt_time_major_plain(
    sos: np.ndarray, xt: torch.Tensor, zi: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: one step over all rows per
    time sample, the same DF-II-transposed update order as
    ``ops.filters.sosfilt`` in the JAX package. Runs on any device."""
    coef = [[float(c) for c in row] for row in coefficients(sos)]
    t_len, rows = xt.shape
    if zi is None:
        zi = xt.new_zeros((2 * len(coef), rows))
    z = list(zi.to(xt.dtype).unbind(0))
    y = torch.empty_like(xt)
    for t in range(t_len):
        out = xt[t]
        for s, (b0, b1, b2, _, a1, a2) in enumerate(coef):
            v = b0 * out + z[2 * s]
            z[2 * s] = b1 * out - a1 * v + z[2 * s + 1]
            z[2 * s + 1] = b2 * out - a2 * v
            out = v
        y[t] = out
    return y, torch.stack(z)


@functools.lru_cache(maxsize=64)
def _prepared_causal(sos_bytes: bytes, n_sections: int) -> PreparedFilter:
    sos = np.frombuffer(sos_bytes, np.float64).reshape(n_sections, 6)
    return PreparedFilter(sos, np.zeros((n_sections, 2)), 0)


def sosfilt_time_major(
    sos: np.ndarray, xt: torch.Tensor, zi: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal biquad cascade over axis 0 of ``xt (T, R)``.

    ``zi (2S, R)`` holds the initial section states (zeros when None),
    row ``2s + j`` being state ``j`` of section ``s``. Returns ``(y (T, R),
    zf (2S, R))``, ``zf`` the final states for chunked continuation.
    """
    sos = np.asarray(sos, np.float64)
    if zi is None:
        zi = xt.new_zeros((2 * sos.shape[0], xt.shape[1]))
    if xt.device.type == "cpu":
        return sosfilt_time_major_plain(sos, xt, zi)
    return _launch_causal(sos, xt, zi, lanes_for(xt.shape[1], causal=True))


def _check_lanes(lanes: int) -> int:
    if lanes not in LANES:
        raise ValueError(f"lanes must be one of {LANES}, got {lanes}")
    return lanes


def _launch_causal(sos: np.ndarray, xt: torch.Tensor, zi: torch.Tensor,
                   lanes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``sosfilt_time_major``'s launch on a CUDA tensor with ``lanes``
    lanes a row (the card tests and ``chip_smoke.py`` sweep it)."""
    n_sections = sos.shape[0]
    t_len, rows = xt.shape
    if not 1 <= n_sections <= MAX_SECTIONS:
        raise ValueError(f"the kernel is built for S in 1..{MAX_SECTIONS}, got S={n_sections}")
    _lib.require_cuda_f32("xt", xt)
    _lib.require_cuda_f32("zi", zi, (2 * n_sections, rows))
    if zi.device != xt.device:
        raise ValueError(f"zi is on {zi.device}, xt on {xt.device}")
    _lib.require_no_grad("the IIR kernel", xt, zi)
    tile, chunk = chunking(t_len, _check_lanes(lanes))
    table = _prepared_causal(np.ascontiguousarray(sos).tobytes(), n_sections).table(
        chunk, xt.device)
    y = torch.empty_like(xt)
    zf = torch.empty_like(zi)
    lib = _lib.library()
    with torch.cuda.device(xt.device):
        code = lib.isd_sosfilt_time_major(
            xt.data_ptr(), zi.data_ptr(), y.data_ptr(), zf.data_ptr(), table.data_ptr(),
            n_sections, t_len, rows, tile, chunk, lanes, _lib.stream_of(xt),
        )
    _lib.check(code, "isd_sosfilt_time_major")
    sosfilt_time_major.launches += 1
    return y, zf


sosfilt_time_major.launches = 0  # kernel launches; the CPU route does not count


def _padlens(filters: Sequence[PreparedFilter], padlens) -> Tuple[int, ...]:
    if padlens is None:
        return tuple(f.padlen for f in filters)
    padlens = tuple(int(p) for p in padlens)
    if len(padlens) != len(filters) or min(padlens) < 0:
        raise ValueError(f"need one padlen >= 0 per filter, got {padlens}")
    return padlens


def sosfiltfilt_chain_plain(
    filters: Sequence[PreparedFilter], x: torch.Tensor, padlens=None
) -> torch.Tensor:
    """Plain version of the chain: ``ops.filters.sosfiltfilt`` through
    ``sosfilt_time_major_plain``, filter by filter, on the prepared
    ``zi``. Runs on any device."""
    from ..filters import sosfilt, zero_phase  # ops.filters imports this module

    def causal(sos, v, zi):
        return sosfilt(sos, v, zi=zi, time_major=sosfilt_time_major_plain)

    for f, padlen in zip(filters, _padlens(filters, padlens)):
        x = zero_phase(causal, f.sos, x, padlen,
                       torch.as_tensor(f.zi, dtype=x.dtype, device=x.device))
    return x


def sosfiltfilt_chain(
    filters: Sequence[PreparedFilter], x: torch.Tensor, padlens=None
) -> torch.Tensor:
    """Zero-phase filtering of the trailing axis of ``x (..., T)`` by each
    of ``filters`` in turn (``prepare_filter``), each as
    ``scipy.signal.sosfiltfilt`` with its defaults; ``padlens`` overrides
    the filters' own. On a CUDA tensor the whole chain is one launch of
    B1: ``x`` is read once and the result written once."""
    filters = list(filters)
    if not 1 <= len(filters) <= MAX_CHAIN:
        raise ValueError(f"a chain holds 1 to {MAX_CHAIN} filters, got {len(filters)}")
    pads = _padlens(filters, padlens)
    t_len = x.shape[-1]
    for p in pads:
        if t_len <= p:
            raise ValueError(
                f"The length of the input vector x must be greater than padlen, "
                f"which is {p} (got {t_len} samples)"
            )
    if x.device.type == "cpu":
        return sosfiltfilt_chain_plain(filters, x, pads)
    return _launch_chain(filters, x, pads, lanes_for(x.numel() // max(t_len, 1)))


def _launch_chain(filters: Sequence[PreparedFilter], x: torch.Tensor, pads: Tuple[int, ...],
                  lanes: int) -> torch.Tensor:
    """``sosfiltfilt_chain``'s launch on a CUDA tensor with ``lanes``
    lanes a row (the card tests and ``chip_smoke.py`` sweep it)."""
    filters = list(filters)
    t_len = x.shape[-1]
    extended = max(t_len + 2 * p for p in pads)
    if extended > MAX_EXTENDED:
        raise ValueError(f"the chain kernel takes rows of up to {MAX_EXTENDED} samples after "
                         f"the odd extension, got {extended}")
    _lib.require_cuda_f32("x", x)
    _lib.require_no_grad("the IIR kernel", x)
    rows = x.numel() // max(t_len, 1)
    _check_lanes(lanes)
    plans = []  # (table, sections, padlen) per filter; an unused slot repeats the first
    for f, p in zip(filters + filters[:1], pads + pads[:1]):
        plans += [f.table(CHUNK_MAX, x.device).data_ptr(), f.n_sections, p]
    y = torch.empty_like(x)
    lib = _lib.library()
    with torch.cuda.device(x.device):
        code = lib.isd_sosfiltfilt_chain(
            x.data_ptr(), y.data_ptr(), rows, t_len, len(filters), lanes,
            *plans[: 3 * MAX_CHAIN], _lib.stream_of(x),
        )
    _lib.check(code, "isd_sosfiltfilt_chain")
    sosfiltfilt_chain.launches += 1
    return y


sosfiltfilt_chain.launches = 0  # kernel launches; the CPU route does not count
