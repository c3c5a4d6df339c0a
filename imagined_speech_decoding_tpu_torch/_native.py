"""Build and load the port's C++ native tier (``native/*.cpp`` in this package).

Counterpart of ``imagined_speech_decoding_tpu/_native.py``. Each source
compiles with ``g++ -O3 -std=c++17 -fPIC -shared -pthread`` (the flags of
the JAX package's ``native/build.sh``) into its own shared library under
``build/isd_torch_native/`` beside the package, at first use, never at
import; the file name carries a hash of the source and the flags, as
``ops/cuda/_lib.py`` names the kernel library, so an edited source
rebuilds. Nothing is written into the repository's ``native/``, which
holds the JAX package's build. A failed build or load raises
``RuntimeError``; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

_PKG = os.path.dirname(os.path.abspath(__file__))
NATIVE_SRC = os.path.join(_PKG, "native")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "isd_torch_native")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def build(name: str) -> str:
    """Compile ``native/<name>.cpp`` unless the library for its current
    source is built; returns the library's path."""
    src = os.path.join(NATIVE_SRC, f"{name}.cpp")
    with open(src, "rb") as f:
        digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + f.read()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
    if os.path.exists(path):
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"lib{name}: no g++ to build {src} with")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, src, "-o", tmp], capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"lib{name}: g++ failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent build never sees a partial file
    return path


def load_native_lib(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>``, built on first call; raises
    ``RuntimeError`` when it cannot be built or loaded."""
    with _lock:
        if name not in _loaded:
            path = build(name)
            try:
                _loaded[name] = ctypes.CDLL(path)
            except OSError as e:
                raise RuntimeError(f"lib{name} could not be loaded from {path} ({e})") from e
        return _loaded[name]
