"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file compiles with ``nvcc`` for ``sm_90a`` (one
``nvcc`` per source, all started together) and the objects link into ONE
shared library with a plain C interface, loaded with ``ctypes``. The
build happens on first use, never at import, into
``build/isd_torch_cuda/`` beside the package; the file name carries a
hash of the sources, headers and flags, so an edited source rebuilds and
an unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "isd_torch_cuda")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # name: (argtypes, restype)
    "isd_sosfilt_time_major": ([_P] * 5 + [_I] * 6 + [_P], _I),
    "isd_sosfiltfilt_chain": ([_P] * 2 + [_I] * 4 + ([_P] + [_I] * 2) * 2 + [_P], _I),
    "isd_conv4head_fwd": ([_P] * 6 + [_I] * 12 + [_P], _I),
    "isd_conv4head_smem_bytes": ([_I] * 4, _I),
    "isd_conv4head_bwd_w": ([_P] * 14 + [_I] * 12 + [_P], _I),
    "isd_conv4head_bwd_x": ([_P] * 8 + [_I] * 12 + [_P], _I),
    "isd_conv4head_bwd_x_smem_bytes": ([_I] * 4, _I),
    "isd_conv4head_bwd_w_smem_bytes": ([_I] * 4, _I),
    "isd_conv4head_fwd_bf16": ([_P] * 6 + [_I] * 12 + [_P], _I),
    "isd_conv4head_fwd_bf16_smem_bytes": ([_I] * 6, _I),
    "isd_conv4head_fwd_bf16_phases": ([_P] * 6 + [_I] * 12 + [_P, _P], _I),
    "isd_conv4head_bwd_w_bf16": ([_P] * 14 + [_I] * 12 + [_P], _I),
    "isd_conv4head_bwd_w_bf16_smem_bytes": ([_I] * 4, _I),
    "isd_conv4head_bwd_w_bf16_phases": ([_P] * 14 + [_I] * 12 + [_P, _P], _I),
    "isd_wgmma_selftest": ([_P, _I, _P, _P] + [_I] * 7 + [_P, _P], _I),
    "isd_cuda_error_string": ([_I], ctypes.c_char_p),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_info: Dict[str, object] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"
    )
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def build() -> Dict[str, object]:
    """Compile the kernels if the library for the current sources is not
    built yet. Returns ``{"path", "seconds", "log"}``: ``seconds`` is 0.0
    and ``log`` empty when the library was already there."""
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + headers:
        with open(src, "rb") as f:
            digest.update(f.read())
    path = os.path.join(BUILD_DIR, f"libisd_kernels_{digest.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return {"path": path, "seconds": 0.0, "log": ""}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    objects = [f"{tmp}.{os.path.basename(src)}.o" for src in sources]
    t0 = time.perf_counter()
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for cmd in ([_nvcc(), *NVCC_FLAGS, "-c", src, "-o", obj]
                    for src, obj in zip(sources, objects))
    ]
    logs = [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in procs]
    link = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", tmp, *objects]
    try:
        for cmd, out, code in logs:
            if code != 0:
                raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{out}")
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({' '.join(link)}):\n{proc.stdout}{proc.stderr}")
    finally:
        for obj in objects:
            if os.path.exists(obj):
                os.remove(obj)
    seconds = time.perf_counter() - t0
    os.replace(tmp, path)  # atomic: a concurrent build never sees a partial file
    return {"path": path, "seconds": seconds, "log": "".join(out for _, out, _ in logs)}


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            _build_info.update(build())
            lib = ctypes.CDLL(_build_info["path"])
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
    return _lib


def build_info() -> Dict[str, object]:
    """What ``library()`` built or found: path, compile seconds, nvcc log."""
    library()
    return dict(_build_info)


def check(code: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if code != 0:
        msg = library().isd_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_no_grad(what: str, *tensors: torch.Tensor) -> None:
    """A forward-only kernel refuses to cut an autograd graph."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what} has no backward kernel yet (see ROADMAP.md); "
            "call it under torch.no_grad() or torch.inference_mode()"
        )


def require_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, shape=None) -> None:
    """The kernels take contiguous device tensors of an exact dtype and shape."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
