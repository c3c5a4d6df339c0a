"""Online decoding: raw EEG window -> class posteriors, on one device.

Counterpart of ``imagined_speech_decoding_tpu/serving.py``. The chain is
the same (``DecodeChain``):

    raw (B, C, T) -> [60 Hz notch -> 4-40 Hz band-pass, zero-phase IIR]
        -> FAST (default mode, eval) -> softmax posteriors (B, K)

Both filter stages are prepared once, when the chain is built
(``ops.cuda.iir.prepare_filter``: SciPy runs there and never per decode),
their constants put in one table on the model's device, and run as one
``isd::sosfiltfilt_chain`` operator: one launch of kernel B1 on a CUDA
device. The FAST head runs through ``isd::conv4head_fwd``, kernel B2f
(``ops/cuda/library.py``).

Where the JAX package jits the chain, the port captures it: on a CUDA
device, a request is served at the smallest of ``GRAPH_BATCHES`` that
holds it (zero-padded; a larger request in slices of the largest). The
first decode at each such batch runs eagerly, then the chain is captured
into a ``torch.cuda.CUDAGraph`` over a static input buffer, and every
later decode at that batch copies the request into the buffer and
replays the graph (``GraphedChain``). So a decoder holds at most
``len(GRAPH_BATCHES)`` graphs, all in one memory pool, whatever batch
sizes its clients send. A failed capture raises; the decoder never falls
back to eager decodes. On the CPU it calls the chain directly. Weights
are runtime state: ``swap_weights(params, state)`` copies a new
checkpoint into the same parameter storage, which the graphs read, and
its model state (the batch-norm heads' running statistics) into the same
buffers, which the graphs read too. The state travels with the weights
everywhere here: ``make_online_decoder``, ``stack_checkpoints``,
``make_fleet_decoder`` and the exported artifact (as its buffers); the
Conv4Layers FAST has none (``{"head": {}}``).

Also here: the fleet decoder (M models stacked, the window filtered
once), the streaming decoder over a numpy or a native ring, the exported
decoder artifact (``torch.export``) and the weight files.
"""

from __future__ import annotations

import copy
import threading
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .data.constants import SFREQ
from .ops.cuda import library
from .ops.cuda.iir import chain_table, prepare_filter
from .ops.filters import butter_sos, notch_ba
from .transplant import from_jax_params, stack_trees, to_jax_params, to_jax_state

# The batch sizes a card's decoder captures. Trials never interact, so a
# request runs at the smallest that holds it, its padding rows zero.
GRAPH_BATCHES = (1, 2, 4, 8, 16, 32, 64)


class DecodeChain(torch.nn.Module):
    """The serving chain as a module: ``x (B, C, T)`` -> posteriors ``(B, K)``
    for ``FAST(cfg)``, or ``(M, B, K)`` for a stacked ``FAST(cfg, n_models=M)``,
    whose models share one filtered window. ``model`` stays the caller's
    (its weights are the chain's); the filters' table lives on the
    model's device."""

    def __init__(self, model: torch.nn.Module, sfreq: float = SFREQ,
                 notch_hz: Optional[float] = 60.0,
                 band: Optional[Tuple[float, float]] = (4.0, 40.0)):
        super().__init__()
        from scipy.signal import tf2sos

        self.model = model
        filters = []
        if notch_hz:  # the notch's (b, a) pair converts exactly to one second-order section
            filters.append(prepare_filter(tf2sos(*notch_ba(sfreq, notch_hz))))
        if band:
            filters.append(prepare_filter(butter_sos(sfreq, band[0], band[1])))
        self.sections = [f.n_sections for f in filters]
        self.padlens = [f.padlen for f in filters]
        device = next(model.parameters()).device
        self.register_buffer("table", chain_table(filters, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.sections:
            x = library.sosfiltfilt_chain(x, self.table, self.sections, self.padlens)
        if self.model.n_models is not None:
            x = x.expand(self.model.n_models, *x.shape)  # the head materialises it
        return torch.softmax(self.model(x).float(), dim=-1)


def graph_batch(b: int) -> int:
    """The captured batch size a slice of ``b`` trials runs at: the
    smallest of ``GRAPH_BATCHES`` that holds it (``b`` is at most the
    largest; ``GraphedChain`` slices larger requests)."""
    return next(n for n in GRAPH_BATCHES if n >= b)


class GraphedChain:
    """``fn (x tensor) -> tensor`` as ``decode(x array (B, ...)) -> array``
    on ``device``, under inference mode; ``batch_axis`` is the batch's axis
    in ``fn``'s output.

    On a CUDA device, requests run in slices of at most
    ``GRAPH_BATCHES[-1]`` trials, each at ``graph_batch`` of its size, in
    one CUDA graph per such batch (and trailing shape): its first slice
    runs ``fn`` eagerly on the zero-padded buffer (the kernels' library,
    tables and cuBLAS handles are made there, never inside a capture) and
    returns that result, then ``fn`` is captured over the buffer; each
    later slice copies its trials into the buffer and replays. The graphs
    share one memory pool, with those of ``share`` when it is given (the
    fleet's rows and ensemble), and one lock: a replay's output is copied
    out before any graph of the pool replays again. ``graphs`` maps a
    buffer's shape to its graph; ``replays`` and ``eager`` count the
    slices of each kind (a replay advances no wrapper's launch count)."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor], device: torch.device,
                 batch_axis: int = 0, share: Optional["GraphedChain"] = None):
        self.fn = fn
        self.device = torch.device(device)
        self.batch_axis = batch_axis
        self.graphs: Dict[tuple, torch.cuda.CUDAGraph] = {}
        self._static: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.replays = 0
        self.eager = 0
        if share is not None:
            self.pool, self._lock = share.pool, share._lock
        else:
            self._lock = threading.Lock()
            self.pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None

    def __call__(self, x) -> np.ndarray:
        x = np.asarray(x, np.float32)
        if self.device.type != "cuda":
            with torch.inference_mode():
                out = self.fn(torch.tensor(x, device=self.device)).cpu().numpy()
            self.eager += 1
            return out
        if len(x) == 0:
            raise ValueError("a decode needs at least one trial")
        step = GRAPH_BATCHES[-1]
        with self._lock:
            parts = [self._run(x[i:i + step]) for i in range(0, len(x), step)]
        return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=self.batch_axis)

    def _run(self, x: np.ndarray) -> np.ndarray:
        b = len(x)
        key = (graph_batch(b), *x.shape[1:])
        if key in self.graphs:
            static_x, out = self._static[key]
            static_x[:b].copy_(torch.tensor(x))
            static_x[b:].zero_()
            self.graphs[key].replay()
            self.replays += 1
        else:
            out = self._capture(key, x)
        return out.narrow(self.batch_axis, 0, b).cpu().numpy()

    def _capture(self, key: tuple, x: np.ndarray) -> torch.Tensor:
        static_x = torch.zeros(key, device=self.device)
        static_x[:len(x)].copy_(torch.tensor(x))
        with torch.inference_mode():
            out = self.fn(static_x)
        self.eager += 1
        graph = torch.cuda.CUDAGraph()
        with torch.inference_mode(), torch.cuda.graph(graph, pool=self.pool,
                                                      capture_error_mode="thread_local"):
            static_out = self.fn(static_x)
        self.graphs[key] = graph
        self._static[key] = (static_x, static_out)
        return out


def _weight_swapper(model: torch.nn.Module) -> Callable:
    """``swap_weights(params, state=None)``: copy a JAX-layout tree and its
    model state into ``model``'s own parameter and buffer storage
    (``load_state_dict`` copies in place), so captured graphs read the new
    weights and running statistics; raises if any storage moved, or if a
    model with running statistics is given no state."""
    from .train.engine import model_buffers

    tensors = list(model.parameters()) + list(model_buffers(model).values())
    ptrs = [t.data_ptr() for t in tensors]
    stateful = bool(model_buffers(model))

    def swap_weights(new_params, new_state=None) -> None:
        """Replace the serving weights (and model state) in place, same shapes."""
        if stateful and new_state is None:
            raise ValueError("this model carries batch-norm state: swap_weights(params, state)")
        model.load_state_dict(from_jax_params(new_params, new_state if stateful else None))
        if [t.data_ptr() for t in tensors] != ptrs:
            raise RuntimeError("swap_weights moved the parameters' storage; "
                               "the captured graphs would read the old weights")

    return swap_weights


def make_online_decoder(
    model: torch.nn.Module,
    params,
    state=None,
    *,
    sfreq: float = SFREQ,
    notch_hz: Optional[float] = 60.0,
    band: Optional[Tuple[float, float]] = (4.0, 40.0),
) -> GraphedChain:
    """Serve ``model`` (a ``FAST``) with the JAX-layout weights ``params`` and
    model state ``state`` (its batch-norm running statistics; ``None`` or
    ``{"head": {}}`` for Conv4Layers).

    Returns ``decode(x (B, C, T) array) -> posteriors (B, K)`` float32
    array, computed on the model's device (a ``GraphedChain``: one CUDA
    graph per captured batch size on a card), with
    ``decode.swap_weights(params, state)`` that copies new weights and
    statistics into the same parameters and buffers, which every graph
    sees."""
    model.eval()
    swap_weights = _weight_swapper(model)
    swap_weights(params, state)
    chain = DecodeChain(model, sfreq, notch_hz, band)
    decode = GraphedChain(chain, chain.table.device)
    decode.swap_weights = swap_weights
    return decode


def stack_checkpoints(paths, model: torch.nn.Module):
    """Load per-model ``.npz`` checkpoints into ONE stacked JAX-layout
    ``(params, state)``.

    ``model`` is a ``FAST(cfg)`` whose parameters and buffers give the leaf
    templates; every checkpoint must match its geometry (a params-only
    file takes the template's state). Returns both trees with a leading
    model axis of length ``len(paths)`` on every leaf, the layout
    ``FAST(cfg, n_models=len(paths))`` and ``make_fleet_decoder`` take."""
    from .train.checkpoint import load_model_npz

    if not paths:
        raise ValueError("stack_checkpoints needs at least one checkpoint path")
    sd = model.state_dict()
    template, state_template = to_jax_params(sd), to_jax_state(sd)
    loaded = [load_model_npz(p, template, state_template)[:2] for p in paths]
    return stack_trees([p for p, _ in loaded]), stack_trees([s for _, s in loaded])


def make_fleet_decoder(
    model: torch.nn.Module,
    stacked_params,
    stacked_state=None,
    *,
    sfreq: float = SFREQ,
    notch_hz: Optional[float] = 60.0,
    band: Optional[Tuple[float, float]] = (4.0, 40.0),
) -> GraphedChain:
    """Serve a whole fleet (e.g. all 15 subjects' best checkpoints) as one
    chain: ``model`` is ``FAST(cfg, n_models=M)``, ``stacked_params`` and
    ``stacked_state`` its stacked JAX-layout trees (``stack_checkpoints``;
    no state for Conv4Layers). The raw window is
    filtered once (one B1 launch), broadcast to the M models, and their
    stacked forward runs the head as one B2f launch.

    Returns ``decode_all(x (B, C, T)) -> (M, B, K)`` (a ``GraphedChain``)
    with:

    * ``decode_all.ensemble(x) -> (B, K)``: the soft-vote mean over the
      fleet, computed on the device (graphs of its own, in the same pool);
    * ``decode_all.n_models``: M;
    * ``decode_all.swap_weights(stacked_params, stacked_state)``: the whole
      fleet's weights and statistics, copied into the same storage.
    """
    if model.n_models is None:
        raise ValueError("make_fleet_decoder serves a stacked FAST(cfg, n_models=M)")
    model.eval()
    swap_weights = _weight_swapper(model)
    swap_weights(stacked_params, stacked_state)
    chain = DecodeChain(model, sfreq, notch_hz, band)
    device = chain.table.device
    decode_all = GraphedChain(chain, device, batch_axis=1)
    decode_all.ensemble = GraphedChain(lambda x: chain(x).mean(dim=0), device, share=decode_all)
    decode_all.swap_weights = swap_weights
    decode_all.n_models = model.n_models
    return decode_all


class StreamingDecoder:
    """Fixed-latency continuous decoding over a host-side ring buffer.

    Push arbitrary-length sample chunks; once ``seq_len`` samples are
    buffered, ``decode_latest`` runs ``decoder`` on the most recent window,
    always of one shape. ``last_end`` is the global sample count at the end
    of the window it last decoded.

    ``native=True`` backs the ring with the lock-free C++ ring
    (``ringbuf.NativeRingBuffer``): ``push`` may then run on an acquisition
    thread while ``decode_latest`` runs, snapshots being tear-checked,
    whereas the numpy ring serialises producer and consumer through the
    GIL. ``ring_capacity`` (native only, default ``4 * seq_len``) sets how
    far the producer can run ahead during one decode.
    """

    def __init__(self, decoder: Callable, n_channels: int, seq_len: int, *,
                 native: bool = False, ring_capacity: Optional[int] = None):
        self.decoder = decoder
        self.seq_len = seq_len
        self.last_end: Optional[int] = None
        self._ring = None
        if native:
            from .ringbuf import NativeRingBuffer

            cap = ring_capacity or 4 * seq_len
            if cap < seq_len:
                raise ValueError(
                    f"ring_capacity ({cap}) must be >= seq_len ({seq_len}); "
                    "a smaller ring could never hold one decode window"
                )
            self._ring = NativeRingBuffer(n_channels, cap)
        else:
            self.buffer = np.zeros((n_channels, seq_len), np.float32)
            self.filled = 0
            self.total = 0

    def push(self, chunk: np.ndarray) -> None:
        """Append ``(C, n)`` new samples to the ring."""
        if self._ring is not None:
            self._ring.push(chunk)
            return
        n = chunk.shape[-1]
        if n >= self.seq_len:
            self.buffer = chunk[:, -self.seq_len:].astype(np.float32)
        else:
            self.buffer = np.concatenate([self.buffer[:, n:], chunk.astype(np.float32)], axis=-1)
        self.filled = min(self.filled + n, self.seq_len)
        self.total += n

    @property
    def ready(self) -> bool:
        if self._ring is not None:
            return self._ring.ready(self.seq_len)
        return self.filled >= self.seq_len

    def decode_latest(self) -> np.ndarray:
        """Posterior over classes for the latest full window ``(K,)``."""
        if self._ring is not None:
            window, self.last_end = self._ring.snapshot_latest(self.seq_len)
        elif not self.ready:
            raise RuntimeError(
                f"buffer has {self.filled}/{self.seq_len} samples; push more first"
            )
        else:
            window, self.last_end = self.buffer, self.total
        return np.asarray(self.decoder(window[None]))[0]

    def close(self) -> None:
        if self._ring is not None:
            self._ring.close()


def export_decoder_artifact(
    path: str,
    model: torch.nn.Module,
    params,
    state=None,
    *,
    n_channels: int,
    seq_len: int,
    sfreq: float = SFREQ,
    notch_hz: Optional[float] = 60.0,
    band: Optional[Tuple[float, float]] = (4.0, 40.0),
    batch_size: Optional[int] = None,
) -> str:
    """Export the full serving chain (filters, FAST forward, softmax) with
    the weights ``params`` inside it, and the model state ``state`` (the
    batch-norm running statistics) as its buffers, through
    ``torch.export``, to one file
    at ``path`` (``torch.export.save``). Serving it needs no model code,
    only ``torch`` and the operators of ``ops/cuda/library.py``:

        from imagined_speech_decoding_tpu_torch.serving import load_decoder_artifact
        decode = load_decoder_artifact("decoder.pt2")   # on the card by default
        posteriors = decode(raw)                        # (B, C, T) f32 -> (B, K)

    ``model`` is a ``FAST(cfg)`` of the served geometry; a copy of it on
    the CPU, frozen, takes ``params``, so the caller's module is left as
    it was. ``batch_size=None`` exports a symbolic batch (one artifact
    serves any B); an int fixes it. The filters and the head are the
    ``isd::`` operators, one node each: the artifact runs kernels B1 and
    B2f on a card and their plain versions on the CPU, wherever
    ``load_decoder_artifact`` moves it. Write and read an artifact with
    one version of torch."""
    model = copy.deepcopy(model).cpu().eval()
    _weight_swapper(model)(params, state)
    model.requires_grad_(False)
    chain = DecodeChain(model, sfreq, notch_hz, band)
    # An example batch of 1 would specialise the batch to 1: trace at 2.
    example = torch.zeros((2 if batch_size is None else int(batch_size), n_channels, seq_len))
    dynamic = None if batch_size is not None else {"x": {0: torch.export.Dim("batch", min=1)}}
    program = torch.export.export(chain, (example,), dynamic_shapes=dynamic, strict=False)
    torch.export.save(program, path)
    return path


def load_decoder_artifact(path: str, device="cuda") -> Callable:
    """Load an ``export_decoder_artifact`` file onto ``device`` (the card
    unless the caller names the CPU; CUDA raises without one).

    Returns ``decode(x (B, C, T) f32 array) -> posteriors (B, K)`` with the
    program at ``decode.program``. Imports ``torch`` and the ``isd::``
    operators only; no model code."""
    from torch.export.passes import move_to_device_pass

    from .devices import require_device
    from .ops.cuda import library  # noqa: F401  (registers the isd:: operators)

    device = require_device(device)
    program = move_to_device_pass(torch.export.load(path), device)
    module = program.module()

    def decode(x) -> np.ndarray:
        xt = torch.tensor(np.asarray(x, np.float32), device=device)
        with torch.inference_mode():
            return module(xt).cpu().numpy()

    decode.program = program
    return decode


def export_decoder_weights(path: str, params, state=None) -> str:
    """Persist serving weights and model state (flat ``.npz``, see
    ``train.checkpoint``; no state is ``{"head": {}}``); the file reads back
    with the JAX package's ``load_decoder_weights``."""
    from .train.checkpoint import save_state_dict

    return save_state_dict(path, {"params": params,
                                  "state": {"head": {}} if state is None else state})


def load_decoder_weights(path: str, params_template, state_template=None):
    """``(params, state)`` of an ``export_decoder_weights`` file (or of the
    JAX package's), in the structures of ``params_template`` and
    ``state_template`` (default ``{"head": {}}``, Conv4Layers' empty state)."""
    from .train.checkpoint import load_state_dict

    tree = load_state_dict(path, {"params": params_template,
                                  "state": {"head": {}} if state_template is None
                                  else state_template}, strip_prefix="")
    return tree["params"], tree["state"]
