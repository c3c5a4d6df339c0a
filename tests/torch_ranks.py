"""Ranks of a ``torch.distributed`` run on the CPU for the port's parallel
tests, and the work they are given (not a test file).

``RankPool(world)`` starts ``world`` processes (spawned, one torch thread
each) that join one gloo process group once and then run the functions
they are sent, each on every rank at once; ``run`` returns every rank's
result. The functions below are what the tests send: each imports the
port only (never JAX), so a rank starts in seconds.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import queue
import traceback
from datetime import timedelta

import numpy as np

TASK_TIMEOUT_S = 400  # a task's wait for every rank's result
COLLECTIVE_TIMEOUT_S = 120


def _worker(rank: int, world: int, port: int, tasks, results) -> None:
    import torch
    import torch.distributed as dist

    from imagined_speech_decoding_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    os.environ.update(GLOO_SOCKET_IFNAME="lo")
    # a rank that fails leaves the others in a collective: let it time out soon
    mesh.TIMEOUT = timedelta(seconds=COLLECTIVE_TIMEOUT_S)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=mesh.TIMEOUT)
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args, kwargs = task
            try:
                results.put((rank, True, fn(*args, **kwargs)))
            except Exception:  # noqa: BLE001 -- reported to the test, which raises
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    """``world`` rank processes on the CPU, joined in one gloo group."""

    def __init__(self, world: int):
        from imagined_speech_decoding_tpu_torch.parallel.mesh import free_port

        ctx = mp.get_context("spawn")
        self.world = world
        self.tasks = [ctx.Queue() for _ in range(world)]
        self.results = ctx.Queue()
        port = free_port()
        self.procs = [ctx.Process(target=_worker, args=(r, world, port, self.tasks[r],
                                                        self.results), daemon=True)
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, fn, *args, **kwargs) -> list:
        """``fn(*args, **kwargs)`` on every rank; each rank's result, by rank.
        A rank that raised fails the call with its traceback."""
        for q in self.tasks:
            q.put((fn, args, kwargs))
        got = {}
        try:
            while len(got) < self.world:
                rank, ok, value = self.results.get(timeout=TASK_TIMEOUT_S)
                got[rank] = (ok, value)
        except queue.Empty:
            self.close()
            raise RuntimeError(f"ranks {sorted(set(range(self.world)) - set(got))} gave no "
                               f"result within {TASK_TIMEOUT_S} s") from None
        failed = [f"rank {r}:\n{v}" for r, (ok, v) in sorted(got.items()) if not ok]
        if failed:
            raise RuntimeError("\n".join(failed))
        return [got[r][1] for r in range(self.world)]

    def close(self) -> None:
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)


# ---------------------------------------------------------------------------
# Work for the ranks (module level: sent by reference)
# ---------------------------------------------------------------------------

def tiny_config(**overrides):
    """The dry run's geometry (64 channels, dim_cnn 8, dim_token 16, 400
    samples, 2 layers, dropout 0.1) with ``overrides``."""
    from imagined_speech_decoding_tpu_torch.parallel.dryrun import dryrun_config

    return dataclasses.replace(dryrun_config(), **overrides)


def fit_summary(fit) -> dict:
    """A ``FitResult`` as numpy arrays."""
    return {
        "history": {k: np.asarray(v) for k, v in fit.history.items()},
        "best_val_acc": np.asarray(fit.best_val_acc),
        "best_epoch": np.asarray(fit.best_epoch),
        "params": {k: v.detach().cpu().numpy() for k, v in fit.params.items()},
        "model_state": {k: v.detach().cpu().numpy() for k, v in fit.model_state.items()},
    }


def cv_run(cfg, tc, X, Y, mesh_axis=None, save_dir=None, **kwargs) -> dict:
    """``train_per_subject_cv`` on the CPU (every rank, or alone)."""
    from imagined_speech_decoding_tpu_torch.train.cv import train_per_subject_cv

    subjects = [f"{i + 1:02d}" for i in range(X.shape[0])]
    res = train_per_subject_cv(cfg, tc, X, Y, subjects, cfg.n_classes, save_dir=save_dir,
                               device="cpu", verbose=False, mesh_axis=mesh_axis, **kwargs)
    return {"fit": fit_summary(res.fit), "summary": res.summary,
            "best_fold": res.best_fold_per_subject}


def loso_run(cfg, X, Y, save_dir, mesh_axis=None, **kwargs) -> dict:
    from imagined_speech_decoding_tpu_torch.train.loso import pretrain_loso

    subjects = [f"s{i}" for i in range(X.shape[0])]
    _, res = pretrain_loso(cfg, X, Y, subjects, cfg.n_classes, save_dir=save_dir,
                           verbose=False, return_result=True, device="cpu",
                           mesh_axis=mesh_axis, **kwargs)
    return fit_summary(res)


class SimulatedCrash(Exception):
    pass


def fit_run(cfg, X, Y, tidx, vidx, mesh_axis=None, seed=3, hyper=None, crash_after=None,
            checkpoint_dir=None, params_seed=2, **fit_kwargs) -> dict:
    """``engine.fit_segmented`` of ``make_fit(..., **fit_kwargs)`` on a stack
    of ``len(tidx)`` models, split by ``mesh_axis`` or whole; with
    ``crash_after=k`` the run raises after its k-th segment (the segment
    checkpoint is written) and returns None."""
    import torch

    from imagined_speech_decoding_tpu_torch.models.api import make_fast_model
    from imagined_speech_decoding_tpu_torch.parallel.mesh import StackShard, mesh_strategy
    from imagined_speech_decoding_tpu_torch.train.engine import fit_segmented, make_fit

    mdef = make_fast_model(cfg)
    m = len(tidx)
    params0, state0 = mdef.init(params_seed, m)
    shard = None
    if mesh_axis:
        mesh, stack_axis, data_axis = mesh_strategy(mesh_axis, "cpu")
        shard = StackShard(mesh, m, stack_axis, data_axis)
        params0, state0 = shard.rows_of((params0, state0))
    stack = mdef.build(m if shard is None else shard.m_local, "cpu")
    mdef.load(stack, params0, state0)
    fit = make_fit(stack, cfg.n_classes, shard=shard, **fit_kwargs)
    if crash_after is not None:
        run, calls = fit.run, [0]

        def crashing(*args, **kw):
            if calls[0] == crash_after:
                raise SimulatedCrash
            calls[0] += 1
            return run(*args, **kw)

        fit.run = crashing
    try:
        res = fit_segmented(fit, tidx, vidx, torch.as_tensor(X),
                            torch.as_tensor(Y.astype(np.int64)), seed=seed, hyper=hyper,
                            checkpoint_dir=checkpoint_dir)
    except SimulatedCrash:
        return None
    return fit_summary(res)


def failed_write_run(where: str, cfg, X, Y, tidx, vidx, save_dir, **kwargs) -> str:
    """Rank 0's write fails (``where``: 'segment', the segment checkpoint of
    ``fit_run``; 'loso', a LOSO file of ``loso_run``) under 'model'; returns
    the error this rank raised (every rank must raise one)."""
    import torch.distributed as dist

    from imagined_speech_decoding_tpu_torch.train import checkpoint, loso

    def refuse(*args, **kw):
        raise OSError("disk full")

    owner, name = (checkpoint, "save_segment_checkpoint") if where == "segment" else (
        loso, "save_state_dict")
    kept = getattr(owner, name)
    if dist.get_rank() == 0:
        setattr(owner, name, refuse)
    try:
        if where == "segment":
            fit_run(cfg, X, Y, tidx, vidx, "model", checkpoint_dir=save_dir, **kwargs)
        else:
            loso_run(cfg, X, Y, save_dir, "model", **kwargs)
    except (OSError, RuntimeError) as e:
        return f"{type(e).__name__}: {e}"
    finally:
        setattr(owner, name, kept)
    raise AssertionError("the run went on past rank 0's failed write")


def loso_rank_dirs(cfg, X, Y, base, mesh_axis, **kwargs) -> dict:
    """``loso_run`` with a save directory of each rank's own under ``base``
    (only rank 0 writes into its own)."""
    import torch.distributed as dist

    return loso_run(cfg, X, Y, os.path.join(base, f"rank{dist.get_rank()}"), mesh_axis,
                    **kwargs)


def mesh_made_once() -> bool:
    """Whether a strategy's second ``mesh_strategy`` serves the first's mesh."""
    from imagined_speech_decoding_tpu_torch.parallel.mesh import mesh_strategy

    first = mesh_strategy("2d", "cpu")[0]
    return mesh_strategy("2d", "cpu")[0] is first and first.groups["data"] is not None


def dp_step_run(cfg, tree, x, y, w, lr) -> dict:
    """``parallel.dp``'s train and eval steps of one FAST from its JAX-layout
    ``tree = (params, state)`` under plain SGD at ``lr``, over a 'data' axis
    of all ranks, with the batch-norm heads' dropout off."""
    from imagined_speech_decoding_tpu_torch.models import heads

    kept = heads.CVBlockHead.DROPOUT, heads.EEGNetEncoderHead.DROPOUT
    heads.CVBlockHead.DROPOUT = heads.EEGNetEncoderHead.DROPOUT = 0.0
    try:
        return _dp_step(cfg, tree, x, y, w, lr)
    finally:
        heads.CVBlockHead.DROPOUT, heads.EEGNetEncoderHead.DROPOUT = kept


def _dp_step(cfg, tree, x, y, w, lr):
    import torch

    from imagined_speech_decoding_tpu_torch.models.api import make_fast_model
    from imagined_speech_decoding_tpu_torch.parallel import make_mesh
    from imagined_speech_decoding_tpu_torch.parallel.dp import (DPTrainState, make_dp_eval_step,
                                                                make_dp_train_step)
    from imagined_speech_decoding_tpu_torch.train.engine import model_buffers

    mdef = make_fast_model(cfg)
    model = mdef.build(None, "cpu")
    mdef.load(model, *tree)
    mesh = make_mesh(("data",), device="cpu")
    x, y, w = torch.as_tensor(x), torch.as_tensor(y.astype(np.int64)), torch.as_tensor(w)
    num, den, cm = make_dp_eval_step(model, cfg.n_classes, mesh)(x, y, w)
    opt = torch.optim.SGD(model.parameters(), lr=lr)
    state = DPTrainState(dict(model.named_parameters()), model_buffers(model), opt, 0)
    state, metrics = make_dp_train_step(model, opt, cfg.n_classes, mesh)(state, x, y, w, 0)
    params, mstate = mdef.dump(model.state_dict())
    return {"loss": float(metrics["loss"]), "acc": float(metrics["acc"]), "step": state.step,
            "params": params, "state": mstate, "eval": (float(num), float(den), cm.numpy())}


def replicate_run() -> dict:
    """``mesh.replicate`` and ``mesh.shard_model_stack`` on each rank's own
    tensors (rank r fills them with r)."""
    import torch
    import torch.distributed as dist

    from imagined_speech_decoding_tpu_torch.parallel import make_mesh, replicate
    from imagined_speech_decoding_tpu_torch.parallel.mesh import shard_model_stack

    rank = dist.get_rank()
    mesh = make_mesh(("model",), device="cpu")
    replicated = replicate(mesh, {"a": torch.full((4,), float(rank))})["a"]
    stack = np.arange(5 * 3, dtype=np.float32).reshape(5, 3)
    (rows,), (corpus,), m_padded = shard_model_stack(
        "model", 5, [stack], [np.full(2, float(rank), np.float32)], mesh=mesh)
    return {"replicated": replicated.numpy(), "rows": rows, "corpus": corpus,
            "m_padded": m_padded}


def ensemble_run(cfg, tc, X, Y, test, save_dir, mesh_axis) -> dict:
    from imagined_speech_decoding_tpu_torch.train.ensemble import train_seed_ensemble

    subjects = [f"{i + 1:02d}" for i in range(X.shape[0])]
    res = train_seed_ensemble(cfg, tc, X, Y, subjects, cfg.n_classes, test, save_dir,
                              n_members=2, verbose=False, device="cpu", mesh_axis=mesh_axis)
    return {"summary": res.summary, "members": [m.fit.history for m in res.members]}


def cli_rank(fast_argv, base_argv) -> None:
    """A rank of ``cli.train_fast`` then ``cli.train_baselines`` on the CPU
    (``mesh.spawn_ranks`` set torchrun's environment)."""
    import torch

    from imagined_speech_decoding_tpu_torch.cli import train_baselines, train_fast

    torch.set_num_threads(1)
    train_fast.main(fast_argv, device="cpu")
    train_baselines.main(base_argv, device="cpu")
