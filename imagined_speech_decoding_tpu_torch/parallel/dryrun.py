"""A dry run of multi-rank training: every strategy against the unsharded run.

Counterpart of ``__graft_entry__.py::dryrun_multichip`` on its pinned
geometry (``__graft_entry__.py:160-185``): a tiny FAST (the full 64-channel
montage, dim_cnn 8, dim_token 16, 400 samples, 2 layers, dropout 0.1)
trained as

  1. the data-parallel step (``parallel.dp``) against the same step
     computed shard by shard in one process: loss and parameters within
     1e-5, and the step moves the parameters;
  2. a segmented fit of 5 models with the stack split over a ``model``
     axis of all ranks (padded when 5 does not divide), against the
     unsharded fit: history and best accuracies within 1e-5, and the fit
     learns (mean best val_acc above 0.30 on separable data);
  3. the '2d' strategy on a ``(n // 2, 2)`` grid (two or more ranks):
     history within 1e-5 of the unsharded fit;
  4. the LOSO program (``train.loso.pretrain_loso``) under 'model' against
     its unsharded run: history within 0.05, accuracies and F1 within 0.35;
  5. the sweep-mode fit (``make_fit(sweep=True)``, unit hyperparameters)
     split over 'model', against section 2's unsharded plain fit: history
     within 0.02, accuracies and F1 within 0.35.

The bounds are those the JAX dry run asserts. Each rank is a process of
its own (``mesh.spawn_ranks``; one rank runs in the calling process), over
NCCL on the card (one card a rank: fewer cards than ranks raises) or gloo
on the CPU; every rank runs the unsharded references too and asserts, so
a failure ends every rank.

    python -m imagined_speech_decoding_tpu_torch.parallel.dryrun 2 [--device cpu]
"""

from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch

S, N_PER = 5, 20  # LOSO's subjects x trials: its split is 72 train / 8 validation
N_TRIALS, N_TRAIN, N_VAL = S * N_PER, 72, 8
EP, BATCH, LR = 4, 24, 3e-3
M = S  # the stack: 5 models, padded on a mesh it does not divide


def dryrun_config():
    from ..config import FASTConfig
    from ..data.constants import Electrodes, Zones

    return FASTConfig(electrodes=tuple(Electrodes), zone_dict=Zones, dim_cnn=8, dim_token=16,
                      seq_len=400, window_len=250, slide_step=125, head="Conv4Layers",
                      n_classes=5, num_layers=2, num_heads=4, dropout=0.1)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The dry run on ``n_devices`` ranks: one card each on ``device="cuda"``
    (NCCL; fewer visible cards raise),
    ``n_devices`` processes over gloo on ``device="cpu"``. One rank is this
    process (in the run's world of one, made here if there is none yet).
    Returns when all five sections passed; raises if one failed."""
    import torch.distributed as dist

    from ..devices import require_device
    from .mesh import spawn_ranks

    dev = require_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) needs {n_devices} cards; "
                           f"{torch.cuda.device_count()} are visible")
    if n_devices == 1:
        made = not dist.is_initialized()
        try:
            run_sections(1, dev.type)
        finally:
            if made and dist.is_initialized():
                dist.destroy_process_group()
        return
    if dev.type == "cuda":
        from ..ops.cuda import _lib

        _lib.library()  # built once here, not by every rank at once
    spawn_ranks(_dryrun_rank, n_devices, n_devices, dev.type)


def _max_delta(a: dict, b: dict, keys) -> float:
    return max(float(np.max(np.abs(np.asarray(a[k]) - np.asarray(b[k])))) for k in keys)


def _check(ok: bool, message: str) -> None:
    if not ok:
        raise AssertionError(message)


def _discrete(key: str) -> bool:
    """History rows that jump by a whole trial under one flipped prediction."""
    return "acc" in key or "f1" in key


def _dryrun_rank(n_devices: int, device: str) -> None:
    if device == "cpu":
        torch.set_num_threads(1)
    run_sections(n_devices, device)


def run_sections(n_devices: int, device="cuda") -> dict:
    """The five sections on the run's ranks (each rank calls it); returns
    the deltas measured."""
    from ..data.synthetic import synthetic_trials
    from ..models.api import make_fast_model
    from ..train.engine import fit_segmented, make_fit, model_buffers
    from ..train.loso import pretrain_loso
    from .dp import DPTrainState, make_dp_train_step, shard_generator, weighted_ce_sums
    from .mesh import StackShard, init_world, is_lead, make_mesh

    dev = init_world(device)
    if torch.distributed.get_world_size() != n_devices:
        raise RuntimeError(f"the run has {torch.distributed.get_world_size()} ranks, "
                           f"not {n_devices}")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = dryrun_config()
    mdef = make_fast_model(cfg)
    rng = np.random.default_rng(0)
    t_start = time.perf_counter()
    ticks = [t_start]
    out = {}

    def tick(name: str) -> None:
        now = time.perf_counter()
        if is_lead():
            print(f"dryrun section [{name}] done in {now - ticks[0]:.1f}s "
                  f"(elapsed {now - t_start:.1f}s)", flush=True)
        ticks[0] = now

    # --- 1. the data-parallel step against the same shards in one process
    mesh = make_mesh(("data",), device=dev)
    b = 2 * n_devices
    x = torch.as_tensor(rng.normal(size=(b, cfg.n_channels, cfg.seq_len)).astype(np.float32),
                        device=dev)
    y = torch.as_tensor(rng.integers(0, cfg.n_classes, b), device=dev)
    w = torch.ones(b, device=dev)
    params, mstate = mdef.init(0, None)

    def single():
        model = mdef.build(None, dev)
        mdef.load(model, params, mstate)
        # no warmup: the step's learning rate is the base rate, so it moves
        opt = torch.optim.AdamW(model.parameters(), lr=5e-4, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=0.01)
        return model, opt

    model, opt = single()
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    state = DPTrainState(dict(model.named_parameters()), model_buffers(model), opt, 0)
    state, metrics = make_dp_train_step(model, opt, cfg.n_classes, mesh)(state, x, y, w, 1)
    ref, ref_opt = single()
    ref.train()
    num = torch.zeros((), device=dev)
    per = b // n_devices
    for i in range(n_devices):
        sl = slice(i * per, (i + 1) * per)
        logits = ref(x[sl], generator=shard_generator(1, i, dev))
        num = num + weighted_ce_sums(logits, y[sl], w[sl])[0]
    num.backward()
    for p in ref.parameters():
        p.grad = p.grad / float(w.sum())
    ref_opt.step()
    after = dict(ref.named_parameters())
    out["dp_loss"] = abs(float(metrics["loss"]) - float(num.detach()) / float(w.sum()))
    out["dp_param"] = max(float((p - after[k]).detach().abs().max())
                          for k, p in state.params.items())
    moved = max(float((p.detach() - start[k]).abs().max()) for k, p in state.params.items())
    _check(np.isfinite(float(metrics["loss"])), f"DP step loss {float(metrics['loss'])}")
    _check(moved > 1e-7, f"DP step did not update params (max |delta|={moved})")
    _check(out["dp_loss"] < 1e-5, f"DP sharded vs unsharded loss delta {out['dp_loss']}")
    _check(out["dp_param"] < 1e-5, f"DP sharded vs unsharded param delta {out['dp_param']}")
    tick("1/5 DP train step")

    # --- 2. the stack split over 'model' against the unsharded fit
    x_np, y_np = synthetic_trials(0, N_TRIALS, n_channels=cfg.n_channels,
                                  n_samples=cfg.seq_len, snr=6.0)
    X = torch.as_tensor(x_np, device=dev)
    Y = torch.as_tensor(y_np.astype(np.int64), device=dev)
    perms = np.stack([rng.permutation(N_TRIALS) for _ in range(M)])
    tidx, vidx = perms[:, :N_TRAIN], perms[:, N_TRAIN:N_TRAIN + N_VAL]
    params0, state0 = mdef.init(2, M)

    def fit_run(shard=None, sweep=False, seed=3):
        stack = mdef.build(M if shard is None else shard.m_local, dev)
        mdef.load(stack, *(shard.rows_of((params0, state0)) if shard else (params0, state0)))
        fit = make_fit(stack, cfg.n_classes, epochs=EP, batch_size=BATCH, n_train=N_TRAIN,
                       n_val=N_VAL, learning_rate=LR, warmup_epochs=0, total_epochs=EP,
                       sweep=sweep, shard=shard)
        hyper = ({"lr_scale": np.ones(M, np.float32), "wd_scale": np.ones(M, np.float32)}
                 if sweep else None)
        return fit_segmented(fit, tidx, vidx, X, Y, seed=seed, hyper=hyper)

    mesh_m = make_mesh(("model",), device=dev)
    shard_m = StackShard(mesh_m, M, "model")
    res = fit_run(shard_m)
    plain = fit_run()
    _check(res.history["loss"].shape == (M, EP) and np.isfinite(res.history["loss"]).all(),
           f"sharded fit's loss history {res.history['loss']}")
    out["mean_acc"] = float(np.mean(res.best_val_acc))
    _check(out["mean_acc"] > 0.30,
           f"sharded fit failed to learn: mean best val_acc {out['mean_acc']:.3f} <= 0.30 "
           "(chance 0.2) on separable synthetic data")
    out["hist"] = _max_delta(res.history, plain.history, res.history)
    out["acc"] = float(np.max(np.abs(res.best_val_acc - plain.best_val_acc)))
    _check(out["hist"] < 1e-5, f"sharded vs unsharded history delta {out['hist']}")
    _check(out["acc"] < 1e-5, f"sharded vs unsharded best_val_acc delta {out['acc']}")
    tick("2/5 stacked fit sharded==unsharded")

    # --- 3. '2d': the stack over 'model' and every batch over 'data'
    out["hist2d"] = float("nan")
    if n_devices >= 2:
        mesh2d = make_mesh(("model", "data"), (max(n_devices // 2, 1), 2), device=dev)
        res2d = fit_run(StackShard(mesh2d, M, "model", "data"))
        out["hist2d"] = _max_delta(res2d.history, plain.history, res2d.history)
        _check(out["hist2d"] < 1e-5, f"2d-mesh vs unsharded history delta {out['hist2d']}")
    tick("3/5 2d-mesh fit")

    # --- 4. the LOSO program under 'model' against its unsharded run
    xl, yl = synthetic_trials(1, S * N_PER, n_channels=cfg.n_channels, n_samples=cfg.seq_len,
                              snr=3.0)
    Xl = xl.reshape(S, N_PER, cfg.n_channels, cfg.seq_len)
    Yl = yl.reshape(S, N_PER)
    loso = {}
    for axis in (None, "model"):
        with tempfile.TemporaryDirectory() as td:
            _, loso[axis] = pretrain_loso(
                cfg, Xl, Yl, [f"s{i}" for i in range(S)], cfg.n_classes, save_dir=td,
                epochs=EP, batch_size=BATCH, learning_rate=LR, warmup_epochs=0, seed=0,
                verbose=False, return_result=True, device=dev, mesh_axis=axis)
    hist = loso[None].history
    out["loso"] = _max_delta(hist, loso["model"].history, [k for k in hist if not _discrete(k)])
    out["loso_acc"] = _max_delta(hist, loso["model"].history, [k for k in hist if _discrete(k)])
    _check(out["loso"] < 0.05, f"LOSO sharded vs unsharded history delta {out['loso']}")
    _check(out["loso_acc"] < 0.35, f"LOSO sharded vs unsharded acc/f1 delta {out['loso_acc']}")
    tick("4/5 LOSO program")

    # --- 5. the sweep-mode fit under 'model' at unit hyperparameters
    res_sw = fit_run(shard_m, sweep=True)
    keys = list(res_sw.history)
    out["sweep"] = _max_delta(res_sw.history, plain.history, [k for k in keys if not _discrete(k)])
    out["sweep_acc"] = _max_delta(res_sw.history, plain.history, [k for k in keys if _discrete(k)])
    _check(out["sweep"] < 0.02, f"sweep(unit hypers) vs plain history delta {out['sweep']}")
    _check(out["sweep_acc"] < 0.35,
           f"sweep(unit hypers) vs plain acc/f1 delta {out['sweep_acc']}")
    tick("5/5 sweep program")

    if is_lead():
        print(f"dryrun_multichip({n_devices}) on {dev.type} "
              f"({torch.distributed.get_backend()}): all 5 sections passed in "
              f"{time.perf_counter() - t_start:.1f}s. DP step loss delta {out['dp_loss']:.2e}, "
              f"param delta {out['dp_param']:.2e}; model-axis fit ({M} models padded to "
              f"{shard_m.m_padded}) mean val_acc {out['mean_acc']:.3f}, history delta "
              f"{out['hist']:.2e}, best_val_acc delta {out['acc']:.2e}; 2d history delta "
              f"{out['hist2d']:.2e}; LOSO history delta {out['loso']:.2e} (acc "
              f"{out['loso_acc']:.2e}); sweep vs plain {out['sweep']:.2e} "
              f"(acc {out['sweep_acc']:.2e})", flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="multi-rank dry run of the port's strategies")
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    a = ap.parse_args()
    dryrun_multichip(a.n_devices, a.device)
