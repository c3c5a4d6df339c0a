"""Export a trained FAST checkpoint as a deployable decoder artifact.

Counterpart of ``imagined_speech_decoding_tpu/cli/export_decoder.py``,
with the same flags. Packs the online-decoding chain (notch + band-pass
zero-phase IIR -> FAST forward -> softmax, weights inside) into one file
through ``torch.export`` (``serving.export_decoder_artifact``). Serving
it then needs only torch and the port's ``isd::`` operators, no model
code and no checkpoint loading:

    python -m imagined_speech_decoding_tpu_torch.cli.export_decoder \\
        --checkpoint results/FAST/sub-01/best_subject.npz --out decoder.pt2
    # later:
    decode = serving.load_decoder_artifact("decoder.pt2")   # on the card
    python -m imagined_speech_decoding_tpu_torch.cli.serve --artifact decoder.pt2

Tracing runs on the CPU and launches nothing; the artifact runs kernels
B1 and B2f on a card and their plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import os

from .train_fast import DEFAULT_CONFIG


def build_parser():
    p = argparse.ArgumentParser(description="Export a serving artifact (torch.export)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="best_subject.npz (omit for freshly initialized weights)")
    p.add_argument("--config", type=str, default=DEFAULT_CONFIG)
    p.add_argument("--out", type=str, default="decoder.pt2")
    p.add_argument("--batch_size", type=int, default=None,
                   help="fixed serving batch; default exports a symbolic "
                        "batch dimension (one artifact serves any B)")
    p.add_argument("--platforms", type=str, nargs="+", default=["cuda", "cpu"],
                   choices=("cuda", "cpu"),
                   help="the JAX CLI's flag: the artifact runs on either device "
                        "(load_decoder_artifact moves it), and on no TPU")
    p.add_argument("--notch", type=float, default=60.0,
                   help="notch frequency in Hz; 0 disables the stage")
    p.add_argument("--band", type=float, nargs=2, default=[4.0, 40.0],
                   metavar=("LO", "HI"), help="band-pass edges in Hz; 0 0 disables")
    p.add_argument("--seed", type=int, default=0, help="init seed when no checkpoint")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ..data.constants import SFREQ
    from ..models.fast import FAST
    from ..serving import export_decoder_artifact
    from ..train.checkpoint import load_model_npz
    from ..transplant import init_jax_layout
    from .train_fast import resolve_config

    cfg = resolve_config(args, {}).model
    params, state = init_jax_layout(cfg, args.seed)
    if args.checkpoint:
        params, state, _ = load_model_npz(args.checkpoint, params, state)
    else:
        print("note: no --checkpoint given; exporting freshly initialized weights")

    band = tuple(args.band) if args.band and args.band[0] > 0 else None
    path = export_decoder_artifact(
        args.out, FAST(cfg), params, state,
        n_channels=cfg.n_channels, seq_len=cfg.seq_len, sfreq=SFREQ,
        notch_hz=args.notch or None, band=band,
        batch_size=args.batch_size,
    )
    size = os.path.getsize(path)
    b = args.batch_size if args.batch_size is not None else "b (symbolic)"
    print(
        f"exported {path} ({size / 1e6:.2f} MB): "
        f"({b}, {cfg.n_channels}, {cfg.seq_len}) f32 -> "
        f"({b}, {cfg.n_classes}) posteriors"
    )
    return path


if __name__ == "__main__":
    main()
