"""Serve a trained FAST decoder over TCP, from PyTorch.

Counterpart of ``imagined_speech_decoding_tpu/cli/serve.py`` in live mode:

    python -m imagined_speech_decoding_tpu_torch.cli.serve \\
        --checkpoint results/FAST/sub-01/best_subject.npz --port 9333

The checkpoint is the JAX package's flat ``.npz`` (``save_model_npz``),
served with ``FASTConfig.default()`` on the GPU; without one it raises
(a Python caller passes ``build_server(args, device="cpu")`` to serve
from the CPU). Clients hot-swap weights with RELOAD. The protocol is
the port's own copy of ISD1 (``server.py``; clients use
``server.DecoderClient``). The artifact and fleet sources and YAML
configs are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import os

_NOT_PORTED = "is not ported to the PyTorch package yet; see ROADMAP.md"


def build_parser():
    p = argparse.ArgumentParser(description="Serve a decoder over TCP (PyTorch)")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--artifact", type=str, help=f"AOT artifact mode {_NOT_PORTED}")
    src.add_argument("--checkpoint", type=str,
                     help="best_subject.npz (live mode; supports RELOAD)")
    src.add_argument("--checkpoint-dir", type=str, help=f"fleet mode {_NOT_PORTED}")
    p.add_argument("--config", type=str, default=None,
                   help=f"model config YAML {_NOT_PORTED}; FASTConfig.default() is served")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=9333, help="0 picks a free port")
    p.add_argument("--notch", type=float, default=60.0, help="notch Hz; 0 disables")
    p.add_argument("--band", type=float, nargs=2, default=[4.0, 40.0],
                   metavar=("LO", "HI"), help="band edges; 0 0 disables")
    p.add_argument("--max-requests", type=int, default=None,
                   help="exit after N decode requests (smoke tests)")
    p.add_argument("--reload-root", type=str, default=None,
                   help="directory RELOAD paths are confined to "
                        "(default: the served checkpoint's results tree)")
    p.add_argument("--auth-token", type=str, default=None,
                   help="shared secret required on RELOAD/SHUTDOWN requests "
                        "(read-only requests stay open)")
    return p


def build_server(args, device="cuda"):
    """Construct the (unstarted) ``DecoderServer`` for ``args`` on
    ``device``; CUDA raises ``RuntimeError`` when no card is visible."""
    for flag, value in (("--artifact", args.artifact),
                        ("--checkpoint-dir", args.checkpoint_dir),
                        ("--config", args.config)):
        if value:
            raise NotImplementedError(f"{flag} {_NOT_PORTED}")

    from ..config import FASTConfig
    from ..devices import require_device
    from ..models.fast import FAST
    from ..server import DecoderServer
    from ..serving import make_online_decoder
    from ..train.checkpoint import load_model_npz
    from ..transplant import to_jax_params

    device = require_device(device)
    cfg = FASTConfig.default()
    model = FAST(cfg, device=device)
    template = to_jax_params(model.state_dict())
    band = tuple(args.band) if args.band and args.band[0] > 0 else None

    def load(path: str):
        params, _, _ = load_model_npz(path, template, {"head": {}})
        return params

    decode = make_online_decoder(
        model, load(args.checkpoint), notch_hz=args.notch or None, band=band
    )

    def reload_weights(path: str) -> None:
        decode.swap_weights(load(path))

    # RELOAD confinement: the results tree that holds the served
    # checkpoint (…/results/FAST for …/results/FAST/sub-01/best_subject.npz).
    reload_root = args.reload_root or os.path.dirname(
        os.path.dirname(os.path.abspath(args.checkpoint))
    )
    return DecoderServer(
        decode,
        n_channels=cfg.n_channels, seq_len=cfg.seq_len, n_classes=cfg.n_classes,
        host=args.host, port=args.port,
        reload_fn=reload_weights,
        reload_root=reload_root,
        info_extra={
            "source": os.path.abspath(args.checkpoint), "mode": "live",
            "reload_root": os.path.realpath(reload_root), "device": str(device),
        },
        max_requests=args.max_requests,
        auth_token=args.auth_token,
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
        f"{meta['n_classes']} posteriors (reloadable)",
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
