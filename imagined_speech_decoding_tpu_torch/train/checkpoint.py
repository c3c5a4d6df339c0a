"""Flat-key ``.npz`` model checkpoints, read and written without JAX.

Counterpart of the ``.npz`` half of
``imagined_speech_decoding_tpu/train/checkpoint.py``, with the same key
rules: nested dicts and lists flatten to dot-joined keys
(``params.blocks.0.attn.in_w``), ``save_model_npz`` writes ``params.`` and
``state.`` prefixes, and ``load_state_dict`` strips a legacy ``model.``
prefix. Trees hold numpy arrays in the JAX layout; ``transplant`` moves
them into a module. The JAX rules' NamedTuple case (batch-norm state)
comes with the batch-norm heads.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten_into(template: Any, flat: Dict[str, np.ndarray], prefix: str = "") -> Any:
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}.") for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        seq = [_unflatten_into(v, flat, f"{prefix}{i}.") for i, v in enumerate(template)]
        return type(template)(seq)
    key = prefix[:-1]
    if key not in flat:
        raise KeyError(f"missing weight {key!r} in checkpoint")
    arr = flat[key]
    tmpl = np.asarray(template)
    if arr.shape != tmpl.shape:
        raise ValueError(f"shape mismatch for {key!r}: {arr.shape} vs {tmpl.shape}")
    return np.asarray(arr, dtype=tmpl.dtype)


def save_state_dict(path: str, tree: Any) -> str:
    """Save a param/state tree as a flat-key ``.npz``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez(path, **_flatten(tree))
    return path


def load_state_dict(path: str, template: Any, strip_prefix: str = "model.") -> Any:
    """Load a flat-key ``.npz`` into the structure of ``template``; keys
    carrying ``strip_prefix`` (a wrapper-module artifact) are stripped."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    if strip_prefix and any(k.startswith(strip_prefix) for k in flat):
        flat = {
            (k[len(strip_prefix):] if k.startswith(strip_prefix) else k): v
            for k, v in flat.items()
        }
    return _unflatten_into(template, flat)


def save_model_npz(path: str, params: Any, state: Any) -> str:
    """Persist a model as params + mutable state in one flat ``.npz``."""
    return save_state_dict(path, {"params": params, "state": state})


def load_model_npz(path: str, params_template: Any, state_template: Any):
    """Load ``save_model_npz`` output; also accepts legacy params-only
    files (state then falls back to the template). Returns
    ``(params, state, had_state)``."""
    with np.load(path) as data:
        keys = set(data.files)
    if any(k.startswith("params.") for k in keys):
        tree = load_state_dict(
            path, {"params": params_template, "state": state_template}, strip_prefix=""
        )
        return tree["params"], tree["state"], True
    return load_state_dict(path, params_template), state_template, False


def select_model(tree: Any, index: int) -> Any:
    """Slice model ``index`` out of a stacked tree (leading model axis);
    leaves may be numpy arrays or tensors, containers dicts and lists."""
    if isinstance(tree, dict):
        return {k: select_model(v, index) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(select_model(v, index) for v in tree)
    return tree[index]
