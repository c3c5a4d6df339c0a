"""The serving chain's two kernels as PyTorch custom operators.

``isd::sosfiltfilt_chain`` (kernel B1's chain entry) and
``isd::conv4head_fwd`` (kernel B2f, forward only) are reached from Python
by ``ctypes`` with raw ``data_ptr``s, which ``torch.export`` cannot
trace. As operators they sit in the dispatcher, so one decode chain runs
the same two kernels eagerly, inside a captured CUDA graph and in an
exported program (``serving.export_decoder_artifact``):

- on a CUDA tensor, each launches its kernel through its wrapper's own
  launch (``iir.launch_chain_tables``; ``conv4head._forward``, which
  routes through ``_adapted``) and counts it there, or raises;
- on a CPU tensor, each runs its plain version
  (``iir.sosfiltfilt_chain_plain``, ``conv4head.fused_conv4_head_plain``);
- ``register_fake`` gives the output's shape and dtype, for tracing.

The filters travel as tensors: one ``iir.chain_table`` of the chain's
section records, with each filter's section count and padlen
(``iir.sosfiltfilt_chain``, the preprocessing's entry, and the decode
chain both call the operator so). Importing
this module registers the operators; an exported decoder needs it (and
``torch``) to load, and nothing else of the package.
"""

from __future__ import annotations

from typing import List

import torch

from . import conv4head, iir


@torch.library.custom_op("isd::sosfiltfilt_chain", mutates_args=(), device_types="cpu")
def sosfiltfilt_chain(x: torch.Tensor, table: torch.Tensor, sections: List[int],
                      padlens: List[int]) -> torch.Tensor:
    """Zero-phase filtering of the trailing axis of ``x (..., T)`` by the
    chain in ``table`` (``iir.chain_table``): on the CPU, the plain chain,
    in storage of its own as the kernel's (the plain chain crops a view)."""
    iir.check_chain(len(sections), padlens, x.shape[-1])
    filters = iir.filters_of_table(table, sections, padlens)
    return iir.sosfiltfilt_chain_plain(filters, x, padlens).contiguous()


@sosfiltfilt_chain.register_kernel("cuda")
def _sosfiltfilt_chain_cuda(x, table, sections, padlens):
    return iir.launch_chain_tables(table.split(list(sections)), x, padlens,
                                   iir.lanes_for(x.numel() // max(x.shape[-1], 1)))


@sosfiltfilt_chain.register_fake
def _sosfiltfilt_chain_fake(x, table, sections, padlens):
    return torch.empty_like(x)


@torch.library.custom_op("isd::conv4head_fwd", mutates_args=(), device_types="cpu")
def conv4head_fwd(x: torch.Tensor, w12: torch.Tensor, b12: torch.Tensor, w3: torch.Tensor,
                  w4: torch.Tensor, window_len: int, step: int) -> torch.Tensor:
    """The head's forward on stacked operands, ``x (M, B, C, T)`` ->
    ``(M, B, N, Z*O)`` f32 (``conv4head.fused_conv4_head``): on the CPU,
    the plain version."""
    return conv4head.fused_conv4_head_plain(x, w12, b12, w3, w4, window_len, step)


@conv4head_fwd.register_kernel("cuda")
def _conv4head_fwd_cuda(x, w12, b12, w3, w4, window_len, step):
    return conv4head._forward(x, w12, b12, w3, w4, window_len, step)


@conv4head_fwd.register_fake
def _conv4head_fwd_fake(x, w12, b12, w3, w4, window_len, step):
    m, b, _, t = x.shape
    return x.new_empty((m, b, (t - window_len) // step + 1, w12.shape[1]), dtype=torch.float32)
