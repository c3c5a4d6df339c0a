"""Move FAST weights between the JAX parameter tree and the port's
``state_dict``.

The JAX tree (``imagined_speech_decoding_tpu.models.fast.fast_init``) is a
nested dict of arrays; here its leaves are numpy arrays, as the ``.npz``
checkpoints hold them. JAX linears are ``(d_in, d_out)`` and the port's
``Linear`` weights ``(out, in)``, so linear weights swap their last two
axes; the zone-stacked conv stacks, ``pos_embedding (1, n_tokens + 1, D)``
and ``cls_token (1, 1, D)`` keep their layout. A stacked tree, whose
leaves carry a leading model axis as ``jax.vmap(fast_init)`` gives them,
maps to the ``state_dict`` of ``FAST(cfg, n_models=M)`` the same way.
Both directions only copy or transpose, so a round trip is bit-exact.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from .config import FASTConfig
from .data.constants import zone_layout


def _pairs(num_layers: int) -> Iterator[Tuple[tuple, str, bool]]:
    """``(jax_path, state_dict_key, transposed)`` for every FAST leaf."""
    yield ("head", "cnn1", "w"), "head.cnn1_weight", False
    yield ("head", "cnn1", "b"), "head.cnn1_bias", False
    for i in (2, 3, 4):
        yield ("head", f"cnn{i}", "w"), f"head.cnn{i}_weight", False
    for name in ("input_layer", "last_layer"):
        yield (name, "w"), f"{name}.weight", True
        yield (name, "b"), f"{name}.bias", False
    yield ("pos_embedding",), "pos_embedding", False
    yield ("cls_token",), "cls_token", False
    for i in range(num_layers):
        pre = f"blocks.{i}."
        for ln in ("ln1", "ln2"):
            yield ("blocks", i, ln, "scale"), f"{pre}{ln}.weight", False
            yield ("blocks", i, ln, "bias"), f"{pre}{ln}.bias", False
        for jax_name, torch_name in (("in", "in_proj"), ("out", "out_proj")):
            yield ("blocks", i, "attn", f"{jax_name}_w"), f"{pre}attn.{torch_name}.weight", True
            yield ("blocks", i, "attn", f"{jax_name}_b"), f"{pre}attn.{torch_name}.bias", False
        for fc in ("fc1", "fc2"):
            yield ("blocks", i, fc, "w"), f"{pre}{fc}.weight", True
            yield ("blocks", i, fc, "b"), f"{pre}{fc}.bias", False


def from_jax_params(params) -> Dict[str, torch.Tensor]:
    """JAX-layout FAST tree (numpy or array-like leaves, stacked or not)
    -> ``state_dict``."""
    out = {}
    for path, key, transposed in _pairs(len(params["blocks"])):
        leaf = params
        for p in path:
            leaf = leaf[p]
        arr = np.asarray(leaf)
        # torch.tensor copies: checkpoint leaves may be read-only views
        out[key] = torch.tensor(np.ascontiguousarray(np.swapaxes(arr, -1, -2) if transposed else arr))
    return out


def to_jax_params(state_dict) -> dict:
    """``state_dict`` (stacked or not) -> JAX-layout FAST tree with numpy leaves."""
    num_layers = len({m.group(1) for k in state_dict if (m := re.match(r"blocks\.(\d+)\.", k))})
    tree: dict = {"blocks": [{} for _ in range(num_layers)]}
    for path, key, transposed in _pairs(num_layers):
        arr = state_dict[key].detach().cpu().numpy()
        node = tree
        for p in path[:-1]:
            node = node[p] if isinstance(p, int) else node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(np.swapaxes(arr, -1, -2) if transposed else arr)
    return tree


def init_jax_layout_params(cfg: FASTConfig, seed: int, n_models: Optional[int] = None) -> dict:
    """Random FAST weights in the JAX layout, from a numpy seed, with the
    distributions ``fast_init`` uses (torch defaults: U(+-1/sqrt(fan_in))
    for convs and linears, Xavier-uniform attention in-projection with
    zero biases, unit-normal positional table and CLS token). With
    ``n_models=M``, M models drawn one after another from the seed's
    stream, stacked on a leading axis as ``jax.vmap(fast_init)`` stacks
    them."""
    rng = np.random.default_rng(seed)
    if n_models is None:
        return _draw_params(cfg, rng)
    trees = [_draw_params(cfg, rng) for _ in range(n_models)]
    return _stack(trees)


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, list):
        return [_stack([t[i] for t in trees]) for i in range(len(first))]
    return np.stack(trees)


def _draw_params(cfg: FASTConfig, rng: np.random.Generator) -> dict:
    f32 = np.float32
    layout = zone_layout(cfg.electrodes, cfg.zone_dict)
    z, c_max, o, d, k = layout.n_zones, layout.c_max, cfg.dim_cnn, cfg.dim_token, 5

    def fan_in(shape, n):
        bound = 1.0 / math.sqrt(n)
        return rng.uniform(-bound, bound, shape).astype(f32)

    def linear(d_in, d_out):
        return {"w": fan_in((d_in, d_out), d_in), "b": fan_in((d_out,), d_in)}

    def block():
        xavier = math.sqrt(6.0 / (d + 3 * d))
        return {
            "ln1": {"scale": np.ones(d, f32), "bias": np.zeros(d, f32)},
            "attn": {
                "in_w": rng.uniform(-xavier, xavier, (d, 3 * d)).astype(f32),
                "in_b": np.zeros(3 * d, f32),
                "out_w": fan_in((d, d), d),
                "out_b": np.zeros(d, f32),
            },
            "ln2": {"scale": np.ones(d, f32), "bias": np.zeros(d, f32)},
            "fc1": linear(d, 2 * d),
            "fc2": linear(2 * d, d),
        }

    return {
        "head": {
            "cnn1": {"w": fan_in((z, o, 1, 1, k), k), "b": fan_in((z, o), k)},
            "cnn2": {"w": fan_in((z, o, o, c_max, 1), o * c_max)},
            "cnn3": {"w": fan_in((z, o, o, 1, k), o * k)},
            "cnn4": {"w": fan_in((z, o, o, 1, k), o * k)},
        },
        "input_layer": linear(o * z, d),
        "blocks": [block() for _ in range(cfg.num_layers)],
        "pos_embedding": rng.standard_normal((1, cfg.n_tokens + 1, d)).astype(f32),
        "cls_token": rng.standard_normal((1, 1, d)).astype(f32),
        "last_layer": linear(d, cfg.n_classes),
    }
