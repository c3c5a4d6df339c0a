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

The batch-norm heads (CVBlock, EEGNet_Encoder, HeadConv_Paper_Version)
and TSception keep the JAX layout in the module, so their subtrees map
key for key (``params.head.bn1.scale`` is ``head.bn1.scale``), and their
mutable state, ``BNState(mean, var)`` leaves, maps to the running-
statistics buffers (``state.head.bn1.mean`` is ``head.bn1.mean``).
``from_jax_params(params, state)`` takes both; ``to_jax_params`` and
``to_jax_state`` read them back.

The baseline models: EEGNet and the CNN-BiLSTM keep the JAX layout as
TSception does (``tree_to_flat`` / ``flat_to_trees``); the MLP's layers
are stacked ``Linear``s (``mlp_from_jax`` / ``mlp_to_jax``).
"""

from __future__ import annotations

import math
import re
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from .config import FASTConfig
from .data.constants import zone_layout

_STATE_LEAVES = ("mean", "var")  # BNState's fields: buffers, not parameters


def _pairs(num_layers: int, conv4: bool = True) -> Iterator[Tuple[tuple, str, bool]]:
    """``(jax_path, state_dict_key, transposed)`` for every FAST leaf; the
    head's only for Conv4Layers (``conv4``), whose module names its own."""
    if conv4:
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


def _tensor(leaf) -> torch.Tensor:
    # torch.tensor copies: checkpoint leaves may be read-only views
    return torch.tensor(np.ascontiguousarray(np.asarray(leaf)))


def tree_to_flat(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A JAX-layout subtree (dicts of leaves, ``BNState`` leaves) as
    ``state_dict`` entries keyed by their dot-joined paths."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(tree_to_flat(v, f"{prefix}{k}."))
        elif hasattr(v, "_fields"):  # BNState
            for field in v._fields:
                out[f"{prefix}{k}.{field}"] = _tensor(getattr(v, field))
        else:
            out[f"{prefix}{k}"] = _tensor(v)
    return out


def flat_to_trees(state_dict, prefix: str = "") -> Tuple[dict, dict]:
    """``(params, state)`` subtrees of the ``state_dict`` entries under
    ``prefix`` with numpy leaves: ``mean`` / ``var`` buffers pair into
    ``BNState`` leaves of ``state``, every other entry is a parameter."""
    from .ops.norm import BNState  # (the serving artifact's loader imports no model code)

    params: dict = {}
    stats: dict = {}
    for key, t in state_dict.items():
        if not key.startswith(prefix):
            continue
        path = key[len(prefix):].split(".")
        arr = t.detach().cpu().numpy().copy()
        if path[-1] in _STATE_LEAVES:
            stats.setdefault(".".join(path[:-1]), {})[path[-1]] = arr
            continue
        node = params
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = arr
    state: dict = {}
    for name, fields in stats.items():
        node = state
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = BNState(fields["mean"], fields["var"])
    return params, state


def mlp_from_jax(params) -> Dict[str, torch.Tensor]:
    """The JAX MLP tree (``fc{i}: {"w": ([M,] d_in, d_out), "b"}``) ->
    ``models.mlp.MLP``'s ``state_dict`` (``fc.{i}.weight`` transposed)."""
    out = {}
    for i in range(len(params)):
        leaf = params[f"fc{i}"]
        out[f"fc.{i}.weight"] = _tensor(np.swapaxes(np.asarray(leaf["w"]), -1, -2))
        out[f"fc.{i}.bias"] = _tensor(leaf["b"])
    return out


def mlp_to_jax(state_dict) -> dict:
    """``models.mlp.MLP``'s ``state_dict`` -> the JAX MLP tree, numpy leaves."""
    n = len({k.split(".")[1] for k in state_dict if k.startswith("fc.")})

    def arr(key):
        return state_dict[key].detach().cpu().numpy()

    return {f"fc{i}": {"w": np.ascontiguousarray(np.swapaxes(arr(f"fc.{i}.weight"), -1, -2)),
                       "b": arr(f"fc.{i}.bias").copy()} for i in range(n)}


def from_jax_params(params, state=None) -> Dict[str, torch.Tensor]:
    """JAX-layout FAST tree (numpy or array-like leaves, stacked or not)
    -> ``state_dict``; with ``state`` (the JAX ``{"head": ...}`` model
    state) the running-statistics buffers too."""
    out = {}
    conv4 = "cnn1" in params["head"]
    for path, key, transposed in _pairs(len(params["blocks"]), conv4):
        leaf = params
        for p in path:
            leaf = leaf[p]
        arr = np.asarray(leaf)
        out[key] = torch.tensor(np.ascontiguousarray(np.swapaxes(arr, -1, -2) if transposed else arr))
    if not conv4:
        out.update(tree_to_flat(params["head"], "head."))
    if state is not None:
        out.update(tree_to_flat(state.get("head", {}), "head."))
    return out


def to_jax_state(state_dict) -> dict:
    """The JAX model state ``{"head": {name: BNState(mean, var)}}`` of a FAST
    ``state_dict`` (``{"head": {}}`` for Conv4Layers), numpy leaves."""
    return {"head": flat_to_trees(state_dict, "head.")[1]}


def to_jax_params(state_dict) -> dict:
    """``state_dict`` (stacked or not) -> JAX-layout FAST tree with numpy leaves."""
    num_layers = len({m.group(1) for k in state_dict if (m := re.match(r"blocks\.(\d+)\.", k))})
    tree: dict = {"blocks": [{} for _ in range(num_layers)]}
    conv4 = "head.cnn1_weight" in state_dict
    if not conv4:
        tree["head"] = flat_to_trees(state_dict, "head.")[0]
    for path, key, transposed in _pairs(num_layers, conv4):
        arr = state_dict[key].detach().cpu().numpy()
        node = tree
        for p in path[:-1]:
            node = node[p] if isinstance(p, int) else node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(np.swapaxes(arr, -1, -2) if transposed else arr)
    return tree


def init_jax_layout(cfg: FASTConfig, seed: int, n_models: Optional[int] = None, *,
                    total: Optional[int] = None, offset: int = 0):
    """``(params, state)``: ``init_jax_layout_params`` and the head's initial
    batch-norm state (``{"head": {}}`` for Conv4Layers). ``total`` /
    ``offset``: the block of models ``offset ..`` of a ``total``-model
    draw, so a run in groups starts from the ungrouped run's weights."""
    rng = np.random.default_rng(seed)
    if n_models is None:
        return _draw_model(cfg, rng)
    models = [_draw_model(cfg, rng) for _ in range(total or n_models)]
    models = models[offset:offset + n_models]
    return stack_trees([p for p, _ in models]), stack_trees([s for _, s in models])


def init_jax_layout_params(cfg: FASTConfig, seed: int, n_models: Optional[int] = None) -> dict:
    """Random FAST weights in the JAX layout, from a numpy seed, with the
    distributions ``fast_init`` uses (torch defaults: U(+-1/sqrt(fan_in))
    for convs and linears, Xavier-uniform attention in-projection with
    zero biases, unit-normal positional table and CLS token). With
    ``n_models=M``, M models drawn one after another from the seed's
    stream, stacked on a leading axis as ``jax.vmap(fast_init)`` stacks
    them."""
    return init_jax_layout(cfg, seed, n_models)[0]


def stack_trees(trees):
    """Stack same-structured trees (dicts, lists, array leaves) leaf by leaf
    on a new leading model axis, as ``jax.vmap(fast_init)`` lays them out."""
    first = trees[0]
    if hasattr(first, "_fields"):  # BNState
        return type(first)(*(stack_trees([t[i] for t in trees]) for i in range(len(first))))
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, list):
        return [stack_trees([t[i] for t in trees]) for i in range(len(first))]
    return np.stack(trees)


def _draw_model(cfg: FASTConfig, rng: np.random.Generator):
    """One model's ``(params, state)``: the head from ``heads.head_init``,
    then the trunk."""
    from .models.heads import head_init

    f32 = np.float32
    layout = zone_layout(cfg.electrodes, cfg.zone_dict)
    z, c_max, o, d = layout.n_zones, layout.c_max, cfg.dim_cnn, cfg.dim_token
    head, head_state = head_init(rng, cfg.head, z, c_max, o, cfg.window_len)

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
        "head": head,
        "input_layer": linear(o * z, d),
        "blocks": [block() for _ in range(cfg.num_layers)],
        "pos_embedding": rng.standard_normal((1, cfg.n_tokens + 1, d)).astype(f32),
        "cls_token": rng.standard_normal((1, 1, d)).astype(f32),
        "last_layer": linear(d, cfg.n_classes),
    }, {"head": head_state}
