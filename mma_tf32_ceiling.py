#!/usr/bin/env python3
"""The rate of tensor-core products on this card, in three modes: TF32
(``mma.sync`` m16n8k8 .tf32, f32 accumulators), the ceiling of the route
of kernels B2f, B2w and B2x, which issue only these (three per f32
product, 3xTF32); bf16 (``mma.sync`` m16n8k16 .bf16, f32 accumulators),
the ceiling of B2f-bf16 (one per product); and wgmma (``wgmma.mma_async``
m64n32k16 .bf16, both operands in shared memory, no swizzle, f32
accumulators), the ceiling of B2w-bf16's route.

    python3 mma_tf32_ceiling.py [--mode tf32|bf16|wgmma|all]   # on a machine with a card and nvcc

In the ``mma.sync`` modes each warp runs rounds of independent ``mma.sync``
on register operands, one block per SM, at 4 to 16 warps per SM and 4 to
16 accumulators per warp. In the wgmma mode each of 1 to 4 warpgroups a
block (one block per SM) runs rounds over 1 to 8 independent accumulator
chains, every wgmma reading its 64 x 16 and 16 x 32 tiles from shared
memory. Prints the card's name and power limit, then TFLOP/s per setting
(2 x 16 x 8 x 8 FLOPs per TF32 mma, 2 x 16 x 8 x 16 per bf16 one, 2 x 64
x 32 x 16 per wgmma) against the card's dense peak, 495 TFLOP/s TF32 and
989 bf16 (H100 SXM data sheet). Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

import torch

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>
template <int NACC, bool BF16>
__global__ void mma_rounds(float* out, int rounds) {
  float acc[NACC][4] = {};
  const float v = threadIdx.x * 1e-3f;
  const uint32_t a0 = __float_as_uint(v), a1 = __float_as_uint(v + 1.f),
                 a2 = __float_as_uint(v + 2.f), a3 = __float_as_uint(v + 3.f),
                 b0 = __float_as_uint(2.f * v), b1 = __float_as_uint(3.f * v);
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int j = 0; j < NACC; ++j) {
      if (BF16) {
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                     "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                     : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
                     : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      } else {
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                     "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                     : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
                     : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      }
    }
  }
  float s = 0.f;
  for (int j = 0; j < NACC; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <bool BF16>
int launch(float* out, int blocks, int threads, int rounds, int nacc) {
  if (nacc == 4) mma_rounds<4, BF16><<<blocks, threads>>>(out, rounds);
  else if (nacc == 8) mma_rounds<8, BF16><<<blocks, threads>>>(out, rounds);
  else if (nacc == 16) mma_rounds<16, BF16><<<blocks, threads>>>(out, rounds);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
extern "C" int mma_rounds_launch(float* out, int blocks, int threads, int rounds, int nacc,
                                 int bf16) {
  return bf16 ? launch<true>(out, blocks, threads, rounds, nacc)
              : launch<false>(out, blocks, threads, rounds, nacc);
}
// wgmma m64n32k16 bf16, A (64 x 16) and B (32 x 16) K-major in shared memory
// (no swizzle: 8 x 16-byte core matrices, 128 bytes apart along M / N, 1 KB
// along K), NACC accumulator chains a warpgroup.
template <int NACC>
__global__ void __launch_bounds__(512, 1) wgmma_rounds(float* out, int rounds) {
  __shared__ __align__(128) uint16_t tiles[64 * 16 + 32 * 16];
  for (int i = threadIdx.x; i < 64 * 16 + 32 * 16; i += blockDim.x) tiles[i] = 0x3c00u;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(tiles));
  const uint64_t da = ((base >> 4) & 0x3FFF) | (uint64_t(1024 >> 4) << 16) |
                      (uint64_t(128 >> 4) << 32);
  const uint64_t db = (((base + 2048) >> 4) & 0x3FFF) | (uint64_t(512 >> 4) << 16) |
                      (uint64_t(128 >> 4) << 32);
  float d[NACC][16];
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int j = 0; j < NACC; ++j) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
          "%16, %17, p, 1, 1, 0, 0;\n}\n"
          : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3]), "+f"(d[j][4]),
            "+f"(d[j][5]), "+f"(d[j][6]), "+f"(d[j][7]), "+f"(d[j][8]), "+f"(d[j][9]),
            "+f"(d[j][10]), "+f"(d[j][11]), "+f"(d[j][12]), "+f"(d[j][13]), "+f"(d[j][14]),
            "+f"(d[j][15])
          : "l"(da), "l"(db), "r"(r));
    }
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NACC; ++j) {
#pragma unroll
    for (int i = 0; i < 16; ++i) s += d[j][i];
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int wgmma_rounds_launch(float* out, int blocks, int threads, int rounds, int nacc) {
  if (nacc == 1) wgmma_rounds<1><<<blocks, threads>>>(out, rounds);
  else if (nacc == 2) wgmma_rounds<2><<<blocks, threads>>>(out, rounds);
  else if (nacc == 4) wgmma_rounds<4><<<blocks, threads>>>(out, rounds);
  else if (nacc == 8) wgmma_rounds<8><<<blocks, threads>>>(out, rounds);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
"""
PEAK_TFLOPS = {"tf32": 495.0, "bf16": 989.0, "wgmma": 989.0}
MMA_K = {"tf32": 8, "bf16": 16}  # reduction depth of one mma.sync: m16n8k8 / m16n8k16
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
    dll.mma_rounds_launch.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5
    dll.mma_rounds_launch.restype = ctypes.c_int
    dll.wgmma_rounds_launch.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
    dll.wgmma_rounds_launch.restype = ctypes.c_int
    return dll


def timed_ms(launch) -> float:
    """CUDA-event milliseconds of ``launch(ROUNDS)`` after a short warm-up."""
    launch(100)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    launch(ROUNDS)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def check(code: int) -> None:
    if code:
        raise RuntimeError(f"launch failed: CUDA error {code}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--mode", choices=("tf32", "bf16", "wgmma", "all"), default="all")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("mma_tf32_ceiling.py needs a CUDA GPU: torch.cuda.is_available() is false")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    dll = build(os.path.join(here, "build", "mma_tf32_ceiling"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 512, device="cuda")
    for mode in (("tf32", "bf16", "wgmma") if args.mode == "all" else (args.mode,)):
        peak, best = PEAK_TFLOPS[mode], 0.0
        if mode == "wgmma":
            for groups in (1, 2, 4):
                for nacc in (1, 2, 4, 8):
                    ms = timed_ms(lambda rounds: check(dll.wgmma_rounds_launch(
                        out.data_ptr(), sms, 128 * groups, rounds, nacc)))
                    tflops = sms * groups * ROUNDS * nacc * 2 * 64 * 32 * 16 / ms / 1e9
                    best = max(best, tflops)
                    ns = 1e6 * ms / (ROUNDS * nacc * groups)
                    print(f"wgmma warpgroups/SM {groups}, chains/warpgroup {nacc}: {ms:8.3f} ms, "
                          f"{tflops:6.1f} TFLOP/s ({tflops / peak:.1%} of {peak:.0f}); "
                          f"{ns:.2f} ns a wgmma an SM", flush=True)
            print(f"wgmma m64n32k16 bf16 (shared-memory operands) ceiling: {best:.1f} TFLOP/s",
                  flush=True)
            continue
        for warps in (4, 8, 16):
            for nacc in (4, 8, 16):
                ms = timed_ms(lambda rounds: check(dll.mma_rounds_launch(
                    out.data_ptr(), sms, 32 * warps, rounds, nacc, int(mode == "bf16"))))
                tflops = sms * warps * ROUNDS * nacc * 2 * 16 * 8 * MMA_K[mode] / ms / 1e9
                best = max(best, tflops)
                print(f"{mode} warps/SM {warps:2d}, accumulators/warp {nacc:2d}: {ms:8.3f} ms, "
                      f"{tflops:6.1f} TFLOP/s ({tflops / peak:.1%} of {peak:.0f})", flush=True)
        if mode == "tf32":
            print(f"mma.sync m16n8k8 TF32 ceiling: {best:.1f} TFLOP/s; 3xTF32 f32-equivalent: "
                  f"{best / 3:.1f} TFLOP/s", flush=True)
        else:
            print(f"mma.sync m16n8k16 bf16 ceiling: {best:.1f} TFLOP/s", flush=True)


if __name__ == "__main__":
    sys.exit(main())
