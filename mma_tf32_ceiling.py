#!/usr/bin/env python3
"""The rate of warp-level TF32 tensor-core products (``mma.sync``
m16n8k8 .tf32, f32 accumulators) on this card: the ceiling of kernel
B2w's route, which issues only these (three per f32 product, 3xTF32).

    python3 mma_tf32_ceiling.py        # on a machine with a card and nvcc

Each warp runs rounds of independent ``mma.sync`` on register operands,
one block per SM, at 4 to 16 warps per SM and 4 to 16 accumulators per
warp. Prints the card's name and power limit, then TFLOP/s per setting
(2 x 16 x 8 x 8 FLOPs per mma) against the card's dense TF32 peak of
495 TFLOP/s (H100 SXM data sheet). Exits non-zero without a card.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

import torch

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>
template <int NACC>
__global__ void mma_rounds(float* out, int rounds) {
  float acc[NACC][4] = {};
  const float v = threadIdx.x * 1e-3f;
  const uint32_t a0 = __float_as_uint(v), a1 = __float_as_uint(v + 1.f),
                 a2 = __float_as_uint(v + 2.f), a3 = __float_as_uint(v + 3.f),
                 b0 = __float_as_uint(2.f * v), b1 = __float_as_uint(3.f * v);
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int j = 0; j < NACC; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                   : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
                   : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  float s = 0.f;
  for (int j = 0; j < NACC; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_rounds_launch(float* out, int blocks, int threads, int rounds, int nacc) {
  if (nacc == 4) mma_rounds<4><<<blocks, threads>>>(out, rounds);
  else if (nacc == 8) mma_rounds<8><<<blocks, threads>>>(out, rounds);
  else if (nacc == 16) mma_rounds<16><<<blocks, threads>>>(out, rounds);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
"""
TF32_PEAK_TFLOPS = 495.0
ROUNDS = 20000


def build(build_dir: str) -> ctypes.CDLL:
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    os.makedirs(build_dir, exist_ok=True)
    src, lib = os.path.join(build_dir, "mma_rounds.cu"), os.path.join(build_dir, "mma_rounds.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", lib, src], check=True)
    dll = ctypes.CDLL(lib)
    dll.mma_rounds_launch.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
    dll.mma_rounds_launch.restype = ctypes.c_int
    return dll


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("mma_tf32_ceiling.py needs a CUDA GPU: torch.cuda.is_available() is false")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    dll = build(os.path.join(here, "build", "mma_tf32_ceiling"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 512, device="cuda")
    best = 0.0
    for warps in (4, 8, 16):
        for nacc in (4, 8, 16):
            def launch(rounds):
                code = dll.mma_rounds_launch(out.data_ptr(), sms, 32 * warps, rounds, nacc)
                if code:
                    raise RuntimeError(f"mma_rounds launch failed: CUDA error {code}")
            launch(100)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            launch(ROUNDS)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
            tflops = sms * warps * ROUNDS * nacc * 2 * 16 * 8 * 8 / ms / 1e9
            best = max(best, tflops)
            print(f"warps/SM {warps:2d}, accumulators/warp {nacc:2d}: {ms:8.3f} ms, "
                  f"{tflops:6.1f} TFLOP/s TF32 ({tflops / TF32_PEAK_TFLOPS:.1%} of "
                  f"{TF32_PEAK_TFLOPS:.0f})", flush=True)
    print(f"mma.sync m16n8k8 TF32 ceiling: {best:.1f} TFLOP/s; 3xTF32 f32-equivalent: "
          f"{best / 3:.1f} TFLOP/s", flush=True)


if __name__ == "__main__":
    sys.exit(main())
