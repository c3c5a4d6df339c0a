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
  one launch, on filters made once by ``prepare_filter``. The
  preprocessing runs its notch and band-pass through it; the online
  decoder calls its operator with the table it holds.

Both take a row's time axis in chunks, one per lane of a warp: each
chunk runs from a zero state, the chunks' end states are combined by a
warp scan with the chunk transition ``A^L`` of each section (computed
here in f64 and rounded to f32, once per filter and chunk length), and
each chunk adds its homogeneous response to the carry it receives.
``section_table`` lays these constants out for the kernel.

Routing: a CPU tensor goes to the plain version; a CUDA tensor launches
the kernel or raises. There is no fallback between the two. Every caller
of the chain goes through the ``isd::sosfiltfilt_chain`` operator
(``library.py``), which takes the filters as one ``chain_table``: this
module owns that table's layout (``chain_table``, ``filters_of_table``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

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


def chain_table(filters: Sequence[PreparedFilter], device) -> torch.Tensor:
    """The chain kernel's constants of ``filters`` in one ``(sum S,
    SECTION_FLOATS)`` table on ``device``: what the ``isd::sosfiltfilt_chain``
    operator (``ops/cuda/library.py``) takes, with each filter's section
    count and padlen."""
    if not filters:
        return torch.empty((0, SECTION_FLOATS), device=device)
    return torch.cat([f.table(CHUNK_MAX, device) for f in filters])


def filters_of_table(table: torch.Tensor, sections: Sequence[int],
                     padlens: Sequence[int]) -> List[PreparedFilter]:
    """The filters a ``chain_table`` holds, for the plain version: each
    record's a0-normalised f32 coefficients and f32 ``zi``, which are the
    values the plain chain computes with (``coefficients`` rounds the
    sections so, and the chain casts ``zi`` to x's dtype)."""
    rec = table.detach().cpu().double().numpy()
    out, row = [], 0
    for s, p in zip(sections, padlens):
        r = rec[row:row + s]
        row += s
        sos = np.concatenate([r[:, 0:3], np.ones((s, 1)), r[:, 3:5]], axis=1)
        out.append(PreparedFilter(sos, r[:, 5:7].copy(), int(p)))
    if row != rec.shape[0]:
        raise ValueError(f"sections {list(sections)} do not cover the table's {rec.shape[0]} rows")
    return out


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
    _lib.require_cuda("xt", xt, torch.float32)
    _lib.require_cuda("zi", zi, torch.float32, (2 * n_sections, rows))
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
    _lib.count(sosfilt_time_major)
    return y, zf


sosfilt_time_major.launches = 0  # kernel launches; the CPU route does not count
sosfilt_time_major.captures = 0  # launches recorded into a CUDA graph (runs nothing)


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
    the filters' own. Runs the ``isd::sosfiltfilt_chain`` operator: on a
    CUDA tensor the whole chain is one launch of B1 (``x`` read once, the
    result written once), on a CPU tensor the plain version; any other
    device takes the kernel's route, which raises off the card."""
    from . import library  # imports this module

    filters = list(filters)
    pads = _padlens(filters, padlens)
    if x.device.type not in ("cpu", "cuda"):
        return _launch_chain(filters, x, pads, lanes_for(x.numel() // max(x.shape[-1], 1)))
    return library.sosfiltfilt_chain(x, chain_table(filters, x.device),
                                     [f.n_sections for f in filters], list(pads))


def check_chain(n_filters: int, pads: Sequence[int], t_len: int) -> None:
    """A chain holds 1 to ``MAX_CHAIN`` filters, and each padlen is shorter
    than the row (``scipy.signal.sosfiltfilt``'s rule)."""
    if not 1 <= n_filters <= MAX_CHAIN:
        raise ValueError(f"a chain holds 1 to {MAX_CHAIN} filters, got {n_filters}")
    for p in pads:
        if t_len <= p:
            raise ValueError(
                f"The length of the input vector x must be greater than padlen, "
                f"which is {p} (got {t_len} samples)"
            )


def _launch_chain(filters: Sequence[PreparedFilter], x: torch.Tensor, pads: Tuple[int, ...],
                  lanes: int) -> torch.Tensor:
    """``sosfiltfilt_chain``'s launch on a CUDA tensor with ``lanes``
    lanes a row (the card tests and ``chip_smoke.py`` sweep it)."""
    return launch_chain_tables([f.table(CHUNK_MAX, x.device) for f in filters], x, pads, lanes)


def launch_chain_tables(tables: Sequence[torch.Tensor], x: torch.Tensor, pads: Sequence[int],
                        lanes: int) -> torch.Tensor:
    """The chain's launch on a CUDA tensor, each filter given by its
    ``(S, SECTION_FLOATS)`` table on x's device (``PreparedFilter.table``, or
    a slice of a ``chain_table``)."""
    tables, pads = list(tables), tuple(pads)
    t_len = x.shape[-1]
    check_chain(len(tables), pads, t_len)
    extended = max(t_len + 2 * p for p in pads)
    if extended > MAX_EXTENDED:
        raise ValueError(f"the chain kernel takes rows of up to {MAX_EXTENDED} samples after "
                         f"the odd extension, got {extended}")
    _lib.require_cuda("x", x, torch.float32)
    _lib.require_no_grad("the IIR kernel", x)
    for t in tables:
        _lib.require_cuda("table", t, torch.float32)
        if t.dim() != 2 or t.shape[1] != SECTION_FLOATS or not 1 <= t.shape[0] <= MAX_SECTIONS \
                or t.device != x.device:
            raise ValueError(f"a filter's table is ({MAX_SECTIONS} or fewer, {SECTION_FLOATS}) "
                             f"on x's device, got {tuple(t.shape)} on {t.device}")
    rows = x.numel() // max(t_len, 1)
    _check_lanes(lanes)
    plans = []  # (table, sections, padlen) per filter; an unused slot repeats the first
    for t, p in zip(tables + tables[:1], pads + pads[:1]):
        plans += [t.data_ptr(), t.shape[0], p]
    y = torch.empty_like(x)
    lib = _lib.library()
    with torch.cuda.device(x.device):
        code = lib.isd_sosfiltfilt_chain(
            x.data_ptr(), y.data_ptr(), rows, t_len, len(tables), lanes,
            *plans[: 3 * MAX_CHAIN], _lib.stream_of(x),
        )
    _lib.check(code, "isd_sosfiltfilt_chain")
    _lib.count(sosfiltfilt_chain)
    return y


sosfiltfilt_chain.launches = 0  # kernel launches; the CPU route does not count
sosfiltfilt_chain.captures = 0  # launches recorded into a CUDA graph (runs nothing)
