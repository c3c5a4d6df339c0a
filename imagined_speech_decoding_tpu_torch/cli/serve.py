"""Serve a trained FAST decoder over TCP, from PyTorch.

Counterpart of ``imagined_speech_decoding_tpu/cli/serve.py``, with its
three sources:

  * ``--artifact decoder.pt2``: the exported decoder from
    ``cli.export_decoder`` (filters + FAST + softmax, weights inside),
    served as it is: immutable, needs no config;
  * ``--checkpoint best_subject.npz [--config cfg.yaml]``: live weights
    through ``serving.make_online_decoder``; clients hot-swap a checkpoint
    with RELOAD;
  * ``--checkpoint-dir results/FAST``: fleet mode, every
    ``sub-*/best_subject.npz`` stacked into one ``FAST(cfg, n_models=M)``
    (``serving.make_fleet_decoder``): DECODE answers the ensemble's
    soft vote, DECODE_ALL the per-subject posteriors.

    python -m imagined_speech_decoding_tpu_torch.cli.serve --artifact decoder.pt2 --port 9333
    python -m imagined_speech_decoding_tpu_torch.cli.serve \\
        --checkpoint results/FAST/sub-01/best_subject.npz --port 9333
    python -m imagined_speech_decoding_tpu_torch.cli.serve --checkpoint-dir results/FAST

Checkpoints are the JAX package's flat ``.npz`` (``save_model_npz``).
``--config`` reads the model's YAML (PyYAML, imported only then); the
default ``configs/default.yaml`` falls back to the built-in defaults
when the file or PyYAML is missing. Every source serves on the GPU;
without one it raises (a Python caller passes
``build_server(args, device="cpu")`` to serve from the CPU). The
protocol is the port's own copy of ISD1 (``server.py``; clients use
``server.DecoderClient``).
"""

from __future__ import annotations

import argparse
import os

from .train_fast import DEFAULT_CONFIG


def build_parser():
    p = argparse.ArgumentParser(description="Serve a decoder over TCP (PyTorch)")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--artifact", type=str, help="exported decoder from cli.export_decoder")
    src.add_argument("--checkpoint", type=str,
                     help="best_subject.npz (live mode; supports RELOAD)")
    src.add_argument("--checkpoint-dir", type=str,
                     help="results dir with sub-*/best_subject.npz: serve the whole fleet "
                          "as one stacked model (DECODE = ensemble soft-vote, "
                          "DECODE_ALL = per-subject posteriors)")
    p.add_argument("--config", type=str, default=DEFAULT_CONFIG,
                   help="model config YAML (live and fleet modes)")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=9333, help="0 picks a free port")
    p.add_argument("--notch", type=float, default=60.0,
                   help="live and fleet modes: notch Hz; 0 disables")
    p.add_argument("--band", type=float, nargs=2, default=[4.0, 40.0],
                   metavar=("LO", "HI"), help="live and fleet modes: band edges; 0 0 disables")
    p.add_argument("--max-requests", type=int, default=None,
                   help="exit after N decode requests (smoke tests)")
    p.add_argument("--reload-root", type=str, default=None,
                   help="live mode: directory RELOAD paths are confined to "
                        "(default: the served checkpoint's results tree)")
    p.add_argument("--auth-token", type=str, default=None,
                   help="shared secret required on RELOAD/SHUTDOWN requests "
                        "(read-only requests stay open)")
    return p


def build_server(args, device="cuda"):
    """Construct the (unstarted) ``DecoderServer`` for ``args`` on
    ``device``; CUDA raises ``RuntimeError`` when no card is visible."""
    from ..devices import require_device
    from ..server import DecoderServer, artifact_meta

    device = require_device(device)
    common = dict(host=args.host, port=args.port, max_requests=args.max_requests,
                  auth_token=args.auth_token)
    if args.artifact:
        from ..serving import load_decoder_artifact

        decode = load_decoder_artifact(args.artifact, device)
        return DecoderServer(
            decode,
            info_extra={"source": os.path.abspath(args.artifact), "mode": "artifact",
                        "device": str(device)},
            **artifact_meta(decode.program), **common,
        )

    from ..models.fast import FAST
    from ..serving import make_fleet_decoder, make_online_decoder, stack_checkpoints
    from ..train.checkpoint import load_model_npz
    from ..transplant import to_jax_params, to_jax_state
    from .train_fast import resolve_config

    cfg = resolve_config(args, {}).model
    model = FAST(cfg, device=device)
    band = tuple(args.band) if args.band and args.band[0] > 0 else None
    shape = dict(n_channels=cfg.n_channels, seq_len=cfg.seq_len, n_classes=cfg.n_classes)

    if args.checkpoint_dir:
        import glob

        paths = sorted(glob.glob(os.path.join(args.checkpoint_dir, "sub-*", "best_subject.npz")))
        if not paths:
            raise SystemExit(f"no sub-*/best_subject.npz under {args.checkpoint_dir}")
        params, state = stack_checkpoints(paths, model)
        fleet = make_fleet_decoder(FAST(cfg, n_models=len(paths), device=device), params, state,
                                   notch_hz=args.notch or None, band=band)
        return DecoderServer(
            fleet.ensemble,
            decode_all_fn=fleet,
            info_extra={
                "source": os.path.abspath(args.checkpoint_dir), "mode": "fleet",
                "n_models": fleet.n_models,
                "subjects": [os.path.basename(os.path.dirname(p)) for p in paths],
                "device": str(device),
            },
            **shape, **common,
        )

    sd = model.state_dict()
    template, state_template = to_jax_params(sd), to_jax_state(sd)

    def load(path: str):
        """The checkpoint's weights and model state (batch-norm statistics)."""
        params, state, _ = load_model_npz(path, template, state_template)
        return params, state

    decode = make_online_decoder(
        model, *load(args.checkpoint), notch_hz=args.notch or None, band=band
    )

    def reload_weights(path: str) -> None:
        decode.swap_weights(*load(path))

    # RELOAD confinement: the results tree that holds the served
    # checkpoint (…/results/FAST for …/results/FAST/sub-01/best_subject.npz).
    reload_root = args.reload_root or os.path.dirname(
        os.path.dirname(os.path.abspath(args.checkpoint))
    )
    return DecoderServer(
        decode,
        reload_fn=reload_weights,
        reload_root=reload_root,
        info_extra={
            "source": os.path.abspath(args.checkpoint), "mode": "live",
            "reload_root": os.path.realpath(reload_root), "device": str(device),
        },
        **shape, **common,
    )


def _warn_if_exposed_unauthenticated(args) -> None:
    """Without --auth-token, RELOAD and SHUTDOWN are open to any peer that
    can reach the socket: warn when binding a non-loopback address."""
    import ipaddress
    import sys

    if args.auth_token is not None:
        return
    try:
        loopback = ipaddress.ip_address(args.host).is_loopback
    except ValueError:  # a hostname: "localhost" is the loopback spelling
        loopback = args.host == "localhost"
    if not loopback:
        print(
            f"WARNING: serving on non-loopback {args.host} with no --auth-token: "
            "any network peer can RELOAD or SHUT DOWN this daemon.",
            file=sys.stderr, flush=True,
        )


def main(argv=None):
    args = build_parser().parse_args(argv)
    _warn_if_exposed_unauthenticated(args)
    server = build_server(args)
    host, port = server.address
    meta = server.info
    print(
        f"serving {meta['mode']} decoder on {host}:{port} ({meta['device']}) — "
        f"({meta['n_channels']}, {meta['seq_len']}) f32 windows -> "
        f"{meta['n_classes']} posteriors"
        + (" (reloadable)" if meta["reloadable"] else "")
        + (f" (fleet of {meta['n_models']})" if meta.get("fleet") else ""),
        flush=True,
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
    return server


if __name__ == "__main__":
    main()
