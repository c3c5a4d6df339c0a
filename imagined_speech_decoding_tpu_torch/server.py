"""The ISD1 wire protocol: ``DecoderServer`` and ``DecoderClient``.

One implementation serves both packages: this module loads the JAX
package's ``server.py`` (stdlib + numpy only) by file path, which does
not run ``imagined_speech_decoding_tpu/__init__.py`` and so imports
neither ``jax`` nor ``yaml``.
"""

from __future__ import annotations

import importlib.util
import os

_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "imagined_speech_decoding_tpu",
    "server.py",
)
_spec = importlib.util.spec_from_file_location(f"{__name__}._isd1", _PATH)
_isd1 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_isd1)

DecoderServer = _isd1.DecoderServer
DecoderClient = _isd1.DecoderClient
