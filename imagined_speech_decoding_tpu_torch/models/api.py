"""Model descriptions for the training engine and the CV driver.

Counterpart of ``imagined_speech_decoding_tpu/models/api.py``. Where the
JAX ``ModelDef`` is an ``(init, apply)`` pair, the port's holds what
``train.cv.train_per_subject_cv`` needs to train a stack and evaluate
its models one at a time:

* ``build(n_models=None, device=None)``: the module, stacked over
  ``n_models`` (``None``: one model with the JAX shapes);
* ``init(seed, n_models, total=None, offset=0)``: the initial JAX-layout
  ``(params, state)`` stacked over ``n_models``, models ``offset ..`` of a
  ``total``-model draw from a numpy seed;
* ``load(module, params, state=None)`` / ``dump(state_dict) -> (params,
  state)``: copy a JAX-layout tree into a module (in place) and read one
  back from a ``state_dict`` (or the engine's dicts of parameters and
  buffers);
* ``augment``: ``(noise_sigma, ch_drop)`` for train-time augmentation
  (``make_augmented_model``), else ``None``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np

from ..config import FASTConfig


def load_into(module, state_dict) -> None:
    """``module.load_state_dict`` in place; a ``state_dict`` without the
    running-statistics buffers keeps the module's own (its initial state
    for a fresh module), and any other missing or extra key raises."""
    from ..train.engine import model_buffers

    missing, unexpected = module.load_state_dict(state_dict, strict=False)
    others = set(missing) - set(model_buffers(module))
    if others or unexpected:
        raise RuntimeError(f"state_dict does not fit the module: missing {sorted(others)}, "
                           f"unexpected {sorted(unexpected)}")


class ModelDef(NamedTuple):
    build: Callable
    init: Callable
    load: Callable
    dump: Callable
    augment: Optional[Tuple[float, float]] = None


def make_fast_model(cfg: FASTConfig, forward_mode: str = "default") -> ModelDef:
    """FAST with ``cfg.head``, its modules bound to ``forward_mode`` (one of
    ``models.fast.FORWARD_MODES``) for training, evaluation and prediction,
    as JAX's ``make_fast_model(cfg, forward_mode)`` binds it into ``apply``;
    the compute dtype is the input's."""
    from .. import transplant
    from .fast import FAST, check_forward_mode

    check_forward_mode(forward_mode)

    def build(n_models=None, device=None):
        return FAST(cfg, n_models=n_models, device=device, forward_mode=forward_mode)

    def init(seed, n_models, total=None, offset=0):
        return transplant.init_jax_layout(cfg, seed, n_models, total=total, offset=offset)

    def load(module, params, state=None):
        load_into(module, transplant.from_jax_params(params, state))

    def dump(sd):
        return transplant.to_jax_params(sd), transplant.to_jax_state(sd)

    return ModelDef(build, init, load, dump)


def _stacked_draws(draw, seed: int, n_models, total=None, offset: int = 0):
    """``draw(rng) -> (params, state)`` of one model, from a numpy ``seed``:
    one model (``n_models`` None), or models ``offset ..`` of a
    ``total``-model draw, stacked on a leading axis."""
    from .. import transplant

    rng = np.random.default_rng(seed)
    if n_models is None:
        return draw(rng)
    models = [draw(rng) for _ in range(total or n_models)][offset:offset + n_models]
    return (transplant.stack_trees([p for p, _ in models]),
            transplant.stack_trees([s for _, s in models]))


def _jax_layout_def(build: Callable, draw: Callable) -> ModelDef:
    """A ``ModelDef`` of a module whose ``state_dict`` is the JAX tree key
    for key (``BNState`` leaves as its ``mean`` / ``var`` buffers)."""
    from .. import transplant

    def init(seed, n_models, total=None, offset=0):
        return _stacked_draws(draw, seed, n_models, total, offset)

    def load(module, params, state=None):
        sd = transplant.tree_to_flat(params)
        if state is not None:
            sd.update(transplant.tree_to_flat(state))
        load_into(module, sd)

    return ModelDef(build, init, load, transplant.flat_to_trees)


def make_tsception_model(n_channels: int, n_samples: int, n_classes: int = 5,
                         sfreq: float = 250.0, dropout: float = 0.5) -> ModelDef:
    """TSception (``models.tsception``) in the JAX layout; ``dropout`` is
    the rate after fc1 (``tsception_apply(dropout=...)``)."""
    from .tsception import TSception, tsception_init

    def build(n_models=None, device=None):
        return TSception(n_channels, n_samples, n_classes, sfreq, dropout=dropout,
                         n_models=n_models, device=device)

    return _jax_layout_def(build, lambda rng: tsception_init(rng, n_channels, n_classes, sfreq))


def make_mlp_model(d_in: int, n_classes: int = 5, hidden=(128, 64),
                   dropout: float = 0.2) -> ModelDef:
    """The MLP (``models.mlp``) over ``d_in`` features; its weights move to
    and from the JAX tree through ``transplant.mlp_from_jax`` /
    ``mlp_to_jax``. ``dropout``: the rate after each hidden layer."""
    from .. import transplant
    from .mlp import MLP, mlp_init

    def build(n_models=None, device=None):
        return MLP(d_in, n_classes, hidden, dropout=dropout, n_models=n_models, device=device)

    def init(seed, n_models, total=None, offset=0):
        return _stacked_draws(lambda rng: mlp_init(rng, d_in, n_classes, hidden), seed, n_models,
                              total, offset)

    def load(module, params, state=None):
        load_into(module, transplant.mlp_from_jax(params))

    def dump(sd):
        return transplant.mlp_to_jax(sd), {}

    return ModelDef(build, init, load, dump)


def make_eegnet_model(n_channels: int, n_samples: int, n_classes: int = 5, in_planes: int = 1,
                      temporal_kernel: int = 64, dropout: float = 0.25) -> ModelDef:
    """EEGNet (``models.eegnet``) in the JAX layout over ``(C, T)`` raw
    trials, or ``(in_planes, C, T)`` planes."""
    from .eegnet import EEGNet, eegnet_init

    def build(n_models=None, device=None):
        return EEGNet(n_channels, n_samples, n_classes, in_planes, temporal_kernel,
                      dropout=dropout, n_models=n_models, device=device)

    return _jax_layout_def(build, lambda rng: eegnet_init(
        rng, n_channels, n_samples, n_classes, in_planes, temporal_kernel))


def make_stft_eegnet_model(n_channels: int, n_samples: int, n_classes: int = 5,
                           dropout: float = 0.25) -> ModelDef:
    """The STFT pipeline's EEGNet (JAX ``pipelines._make_stft_eegnet``): the
    five band planes of ``pipelines.stft_image_featurize`` over
    ``stft_n_frames(n_samples)`` frames, temporal kernel 16 frames (~0.5 s
    at the 31.25 frames a second of an 8-sample hop)."""
    from ..ops.spectral import BANDS
    from ..pipelines import stft_n_frames

    return make_eegnet_model(n_channels, stft_n_frames(n_samples), n_classes,
                             in_planes=len(BANDS), temporal_kernel=16, dropout=dropout)


def make_cnn_bilstm_model(n_channels: int, n_samples: int, n_classes: int = 5,
                          dropout: float = 0.3) -> ModelDef:
    """The CNN-BiLSTM (``models.rnn``) in the JAX layout over raw ``(C, T)``
    trials (any T of at least the pool's 8 samples)."""
    from .rnn import CNNBiLSTM, cnn_bilstm_init

    def build(n_models=None, device=None):
        return CNNBiLSTM(n_channels, n_classes, dropout=dropout, n_models=n_models,
                         device=device)

    return _jax_layout_def(build, lambda rng: cnn_bilstm_init(rng, n_channels, n_classes))


def make_augmented_model(model: ModelDef, noise_sigma: float = 0.1,
                         ch_drop: float = 0.1) -> ModelDef:
    """``model`` with train-time augmentation (``ops.augment.augment_batch``:
    per-trial noise scaled by the trial's std, then whole-channel dropout)
    in the engine's train step only; the draws come from the fit's
    generator. Evaluation, test and serving forwards see the batch as it
    is."""
    return model._replace(augment=(float(noise_sigma), float(ch_drop)))
