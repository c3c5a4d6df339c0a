"""Preprocess CLI: raw dataset -> HDF5 cache, filtered on the card.

Counterpart of ``imagined_speech_decoding_tpu/cli/preprocess.py`` with
the same parser. It builds the official-splits cache (``--layout
official``) or the per-subject groups (``--layout subjects``), then, with
``--notch`` and / or ``--bandpass``, filters every ``X*`` dataset on the
device and writes it back: each split is one launch of kernel B1's chain
entry, the notch then the band-pass, each zero-phase
(``ops.filters.filter_corpus``). In strict mode (the default) the
cache is then held to the documented manifest (``data.cache.manifest_check``).

    python -m imagined_speech_decoding_tpu_torch.cli.preprocess \\
        --data_folder BCIC2020Track3 --output data/processed/BCIC2020Track3.h5 \\
        --notch 60 --bandpass 4 40

With a filter the device is the GPU: without one the run raises
``RuntimeError`` before it reads a file. A Python caller filters on the
CPU with ``main(argv, device="cpu")``; the parser has no device flag.
Needs ``h5py`` (the cache and the v7.3 test split are HDF5).
"""

from __future__ import annotations

import argparse
import os
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Build BCIC2020Track3 HDF5 caches")
    p.add_argument("--data_folder", type=str, default="BCIC2020Track3")
    p.add_argument("--excel_path", type=str, default=None)
    p.add_argument("--output", type=str, default="data/processed/BCIC2020Track3.h5")
    p.add_argument("--layout", choices=["official", "subjects"], default="official",
                   help="official: X_train/..., subjects: per-subject groups")
    p.add_argument("--notch", type=float, default=None, help="notch frequency (e.g. 60)")
    p.add_argument("--bandpass", type=float, nargs=2, default=None, metavar=("LO", "HI"))
    p.add_argument("--no-compress", action="store_true")
    p.add_argument("--no-strict", action="store_true",
                   help="disable strict schema validation of the raw files (strict is the "
                   "default: a present-but-deviating .mat/.xlsx fails loudly with the expected "
                   "schema instead of caching silently wrong arrays)")
    return p


def filter_h5(path: str, notch, bandpass, device) -> dict:
    """Filter every ``X*`` dataset of the cache at ``path`` in place on
    ``device``. Returns ``{dataset: seconds}``: host seconds around the
    copy in, the filter and the copy out, and on a card also the filter's
    own time by CUDA events (``{dataset}/filter_ms``)."""
    import numpy as np
    import torch

    from ..data.ingest import h5py_for
    from ..ops.filters import filter_corpus

    h5py = h5py_for(path)
    names = []
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: names.append(name)
                     if isinstance(obj, h5py.Dataset) and name.split("/")[-1].startswith("X")
                     else None)
    timings = {}
    with h5py.File(path, "r+") as f:
        for name in names:
            t0 = time.perf_counter()
            x = torch.from_numpy(np.asarray(f[name][...], np.float32)).to(device)
            if device.type == "cuda":
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
            y = filter_corpus(x, notch, bandpass)
            if device.type == "cuda":
                end.record()
                end.synchronize()
                timings[f"{name}/filter_ms"] = start.elapsed_time(end)
            f[name][...] = y.cpu().numpy()
            timings[name] = time.perf_counter() - t0
    return timings


def main(argv=None, device="cuda", timings=None):
    """Build the cache and filter it; returns its path. ``timings``, where
    given, receives the host seconds (``ingest_s``, ``write_s``, each
    filtered dataset) and, on a card, each dataset's filter time by CUDA
    events."""
    args = build_parser().parse_args(argv)
    from ..data.cache import build_official_cache, build_subject_cache, manifest_check
    from ..data.ingest import resolve_data_folder
    from ..devices import require_device

    filtering = args.notch is not None or args.bandpass is not None
    device = require_device(device) if filtering else None
    base = resolve_data_folder(args.data_folder)
    os.makedirs(os.path.dirname(os.path.abspath(args.output)) or ".", exist_ok=True)

    strict = not args.no_strict
    timings = {} if timings is None else timings
    if args.layout == "official":
        path = build_official_cache(base, args.output, excel_path=args.excel_path,
                                    compression=None if args.no_compress else "gzip",
                                    strict=strict, timings=timings)
    else:
        path = build_subject_cache(base, args.output, strict=strict, timings=timings)

    if filtering:
        print(f"filtering cache on {device} (notch={args.notch}, bandpass={args.bandpass})")
        timings.update(filter_h5(path, args.notch, args.bandpass, device))

    if strict:
        manifest_check(path)

    print(f"cache written: {path} ({os.path.getsize(path) / 1e6:.1f} MB)")
    return path


if __name__ == "__main__":
    main()
