"""Times the ways the FPS grid kernel's blocks could agree on a round's
winner, alone, on one CUDA card: what one round of ``csrc/fps.cu``'s grid
kernel pays besides its arithmetic.

Run from the repository root on a machine with a CUDA card:

    python -m pytorch3d_pointops_tpu_torch.tune_fps_exchange

It builds a small CUDA program (``nvcc``, into ``build/``) that launches one
block an SM (cooperative launch) of 256 or 1024 threads and runs 20,000
rounds of each exchange, every block publishing a key a round:

* ``grid.sync``: cooperative groups' grid barrier alone (what the parent
  kernel paid, before it read the partials and the winner's point);
* ``counter``: one relaxed ``atomicAdd`` a block and a spin on the count,
  then a block barrier (no data moves);
* ``atomicMax``: the key by ``red.max``, an arrival count with release
  order, then the key and the winner's coordinates read back (two
  dependent reads);
* ``records x1`` / ``records x4``: each block stores a 32-byte record whose
  words carry the round's tag (in 1 or 4 copies), and ceil(blocks / 32)
  warps of every block poll all of them, then a block barrier (the grid
  kernel's exchange);
* ``2 barriers``: two ``__syncthreads`` (the block's share of a round);
* ``ping-pong``: two blocks hand a word back and forth: two one-way trips
  through L2.

It prints one line per exchange and block size (microseconds a round,
CUDA events over the launch), then the card's name and power limit. Exits
1 without a CUDA device.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

from . import _build

_SOURCE = r"""
#include <cooperative_groups.h>
#include <cstdio>
#include <vector>
namespace cg = cooperative_groups;
typedef unsigned long long u64;
constexpr u64 kTag = 1ull << 63;
__device__ __forceinline__ u64 ld(const u64* p) {
  u64 v; asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory"); return v; }
__device__ __forceinline__ void st(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" :: "l"(p), "l"(v) : "memory"); }
__device__ __forceinline__ void ld2(const u64* p, u64& a, u64& b) {
  asm volatile("ld.relaxed.gpu.global.v2.u64 {%0, %1}, [%2];" : "=l"(a), "=l"(b) : "l"(p) : "memory"); }
__device__ __forceinline__ void st2(u64* p, u64 a, u64 b) {
  asm volatile("st.relaxed.gpu.global.v2.u64 [%0], {%1, %2};" :: "l"(p), "l"(a), "l"(b) : "memory"); }

__global__ void exchange(int mode, int rounds, u64* buf, unsigned* count, u64* sink) {
  const int nb = gridDim.x, b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __shared__ u64 s_w[32];
  u64 acc = 0;
  for (int r = 0; r < rounds; ++r) {
    const u64 tag = (u64)((r >> 1) & 1) << 63;
    const u64 key = ((u64)((r * 7 + b * 13) % 1000) << 32) | (0xFFFFFFFFu - b);
    if (mode == 0) {
      cg::this_grid().sync();
    } else if (mode == 1) {
      if (tid == 0) {
        atomicAdd(count, 1u);
        while (*(volatile unsigned*)count < (unsigned)nb * (r + 1)) {}
      }
      __syncthreads();
    } else if (mode == 2) {
      u64* keys = buf + 8 * (r % 3);
      u64* recs = buf + 64 + (size_t)(r & 1) * nb * 4;
      if (tid == 0) {
        st2(recs + b * 4, 1, 2);
        asm volatile("red.relaxed.gpu.global.max.u64 [%0], %1;" :: "l"(keys), "l"(key) : "memory");
        asm volatile("red.release.gpu.global.add.u32 [%0], 1;" :: "l"(count) : "memory");
        unsigned c;
        do { asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(c) : "l"(count) : "memory"); }
        while (c < (unsigned)nb * (r + 1));
        const u64 w = ld(keys);
        u64 x, y;
        ld2(recs + (0xFFFFFFFFu - (unsigned)w) * 4, x, y);
        s_w[0] = w + x + y;
        if (b == 0) st(buf + 8 * ((r + 2) % 3), 0);
      }
      __syncthreads();
      acc += s_w[0];
    } else if (mode == 3 || mode == 4) {
      const int copies = mode == 3 ? 1 : 4;
      u64* round = buf + 64 + (size_t)(r & 1) * copies * nb * 4;
      if (tid < copies) {
        st2(round + ((size_t)tid * nb + b) * 4, tag | key, tag | 1);
        st2(round + ((size_t)tid * nb + b) * 4 + 2, tag | 2, tag | 3);
      }
      if (warp * 32 < nb) {
        const int j = warp * 32 + lane;
        const u64* rec = round + ((size_t)(b % copies) * nb + j) * 4;
        u64 e0 = 0, e1 = 0, e2 = 0, e3 = 0;
        bool done = j >= nb;
        while (true) {
          if (!done) {
            ld2(rec, e0, e1);
            ld2(rec + 2, e2, e3);
            done = (e0 & kTag) == tag && (e1 & kTag) == tag && (e2 & kTag) == tag &&
                   (e3 & kTag) == tag;
          }
          if (__all_sync(~0u, done)) break;
          __nanosleep(64);
        }
        if (lane == 0) s_w[warp] = e0;
      }
      __syncthreads();
      acc += s_w[0];
    } else if (mode == 5) {
      __syncthreads();
      __syncthreads();
    } else if (mode == 6) {
      if (tid == 0 && b < 2) {
        u64* there = buf + (b == 0 ? 16 : 24);
        const u64* back = buf + (b == 0 ? 24 : 16);
        if (b == 0) st(there, r + 1);
        while (ld(back) != (u64)r + 1) {}
        if (b == 1) st(there, r + 1);
      }
    }
  }
  if (tid == 0) sink[b] = acc;
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  u64 *buf, *sink;
  unsigned* count;
  const size_t bytes = 1 << 20;
  cudaMalloc(&buf, bytes);
  cudaMalloc(&sink, 8 * 1024);
  cudaMalloc(&count, 4);
  const char* names[] = {"grid.sync", "counter", "atomicMax", "records x1", "records x4",
                         "2 barriers", "ping-pong"};
  for (int threads : {256, 1024}) {
    for (int mode = 0; mode < 7; ++mode) {
      int rounds = 20000;
      cudaMemset(buf, mode == 6 ? 0 : 0xff, bytes);
      if (mode == 2) cudaMemset(buf, 0, 64 * 8);
      cudaMemset(count, 0, 4);
      void* args[] = {&mode, &rounds, &buf, &count, &sink};
      cudaEvent_t a, e;
      cudaEventCreate(&a);
      cudaEventCreate(&e);
      cudaEventRecord(a);
      cudaError_t err = cudaLaunchCooperativeKernel((void*)exchange, dim3(sms), dim3(threads),
                                                    args, 0, 0);
      cudaEventRecord(e);
      cudaEventSynchronize(e);
      if (err == cudaSuccess) err = cudaGetLastError();
      float ms = 0;
      cudaEventElapsedTime(&ms, a, e);
      if (err != cudaSuccess) {
        printf("%s: CUDA error %d\n", names[mode], (int)err);
        return 1;
      }
      printf("{\"exchange\": \"%s\", \"threads\": %d, \"blocks\": %d, \"us_a_round\": %.4f}\n",
             names[mode], threads, sms, ms * 1e3 / rounds);
    }
  }
  return 0;
}
"""


def main() -> int:
    if not torch.cuda.is_available():
        print("tune_fps_exchange: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, "tune_fps_exchange.cu")
    exe = os.path.join(_build.BUILD_DIR, "tune_fps_exchange")
    with open(src, "w") as f:
        f.write(_SOURCE)
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-std=c++17", src, "-o", exe], check=True)
    subprocess.run([exe], check=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
