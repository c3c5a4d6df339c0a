#!/usr/bin/env python3
"""Times kernel B1 (the biquad IIR cascade) of the package that sits
beside this script, by the two yardsticks of ``kernel_timing.py`` over
50 back-to-back calls:

    python3 iir_timing.py --label new            # from a checkout's root, on a card
    python3 other/iir_timing.py --label old      # with kernel_timing.py, in another checkout

Work timed, with the band-pass of the online decoder (4-40 Hz, order 4,
250 Hz) and its 60 Hz notch:
- the causal entry ``ops.cuda.iir.sosfilt_time_major`` on (854, R), with
  zi, for R = 64, 512, 4,096 and 22,400 (device time: its kernel only);
- the decode's filter stage at B = 1 and 8 (64 channels, 800 samples),
  through ``ops.filters.sosfiltfilt`` once per filter and, where the
  package has it, through ``ops.cuda.iir.sosfiltfilt_chain`` on filters
  prepared once (device time: every kernel and copy, and their count).

Prints the card's name and power limit, one line per row, and as the
last line a JSON object of the rows. Exits non-zero without a card.
"""

from __future__ import annotations

import numpy as np
import torch

import kernel_timing as kt
from imagined_speech_decoding_tpu_torch.ops.cuda import iir
from imagined_speech_decoding_tpu_torch.ops.filters import butter_sos, notch_ba, sosfiltfilt

ITERS = 50
CAUSAL_ROWS = (64, 512, 4096, 22400)
DECODE_BATCHES = (1, 8)


def main() -> None:
    args = kt.start(__doc__, "iir_timing.py")
    from scipy.signal import tf2sos

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    band = butter_sos(250.0, 4.0, 40.0)
    notch = tf2sos(*notch_ba(250.0, 60.0))
    rows = []
    with torch.inference_mode():
        for r in CAUSAL_ROWS:
            xt = torch.tensor(rng.normal(size=(854, r)).astype(np.float32), device=dev)
            zi = torch.tensor(rng.normal(size=(2 * band.shape[0], r)).astype(np.float32),
                              device=dev)
            fn = lambda: iir.sosfilt_time_major(band, xt, zi)  # noqa: E731
            dms, n = kt.device_ms(fn, ITERS, "sosfilt_time_major_kernel")
            rows.append({"work": "causal", "shape": [854, r], "event_ms": kt.event_ms(fn, ITERS),
                         "device_ms": dms, "device_ops": n})
        routes = {"sosfiltfilt x2": lambda x: sosfiltfilt(band, sosfiltfilt(notch, x))}
        if hasattr(iir, "sosfiltfilt_chain"):
            chain = [iir.prepare_filter(notch), iir.prepare_filter(band)]
            routes["sosfiltfilt_chain"] = lambda x: iir.sosfiltfilt_chain(chain, x)
        for b in DECODE_BATCHES:
            x = torch.tensor(rng.normal(size=(b, 64, 800)).astype(np.float32), device=dev)
            for name, route in routes.items():
                fn = lambda: route(x)  # noqa: E731
                dms, n = kt.device_ms(fn, ITERS)
                rows.append({"work": f"decode filters, {name}", "shape": [b, 64, 800],
                             "event_ms": kt.event_ms(fn, ITERS), "device_ms": dms,
                             "device_ops": n})
    for row in rows:
        print(f"[{args.label}] {row['work']} {tuple(row['shape'])}: {row['event_ms']:.4f} ms a "
              f"call (CUDA events), {row['device_ms']:.4f} ms on the device over "
              f"{row['device_ops']:g} kernels and copies", flush=True)
    kt.finish(args.label, rows)


if __name__ == "__main__":
    main()
