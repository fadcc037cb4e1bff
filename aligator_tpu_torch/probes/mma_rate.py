"""The latency and the issue rate of the warp-level TF32 matrix product
(``mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32``, SASS ``HMMA``)
on the card, the instruction the layout probe's products and any
error-compensated 3×TF32 product of the Riccati kernels are built from.

One block of W warps on one SM; each warp runs C independent accumulator
chains of ``ITERS`` products each and reads ``clock64()`` before and after.
Cycles per product of one chain at W = 1, C = 1 is the latency; at C = 8
the issue interval of one warp; with W = 4, 8, 16 warps (one to four a
sub-core) the SM's rate, reported as cycles per product per sub-core.

Run on a machine with a CUDA card::

    python -m aligator_tpu_torch.probes.mma_rate
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
import sys

import torch

from aligator_tpu_torch.utils import cuda_build

ITERS = 4096
SOURCE = r"""
#include <cuda_runtime.h>

__device__ __forceinline__ void mma_tf32_m16n8k8(float (&d)[4], const float (&a)[4],
                                                 const float (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
                 "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])),
                 "r"(__float_as_uint(b[0])), "r"(__float_as_uint(b[1])));
}

template <int C>
__global__ void chains(float* out, long long* cycles, int iters) {
  const int lane = threadIdx.x & 31;
  float a[4] = {1e-3f * lane, 2e-3f, 3e-3f, 4e-3f}, b[2] = {1e-3f, -1e-3f * lane};
  float d[C][4] = {};
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < C; ++c) mma_tf32_m16n8k8(d[c], a, b);
  }
  const long long t1 = clock64();
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[threadIdx.x] = s;
  if (lane == 0) cycles[threadIdx.x / 32] = t1 - t0;
}

extern "C" int run_chains(int c, int warps, int iters, void* out, void* cycles) {
  switch (c) {
    case 1: chains<1><<<1, 32 * warps>>>((float*)out, (long long*)cycles, iters); break;
    case 2: chains<2><<<1, 32 * warps>>>((float*)out, (long long*)cycles, iters); break;
    case 4: chains<4><<<1, 32 * warps>>>((float*)out, (long long*)cycles, iters); break;
    default: chains<8><<<1, 32 * warps>>>((float*)out, (long long*)cycles, iters); break;
  }
  return (int)cudaGetLastError();
}
"""


def build() -> ctypes.CDLL:
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha256((SOURCE + " ".join(cuda_build.NVCC_FLAGS)).encode()).hexdigest()[:12]
    cu = cuda_build.BUILD_DIR / f"mma_rate-{digest}.cu"
    so = cu.with_suffix(".so")
    if not so.exists():
        cu.write_text(SOURCE)
        r = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                           capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"nvcc failed on the mma rate probe:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.run_chains.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    lib.run_chains.restype = ctypes.c_int
    return lib


def cycles_per_product(lib, chains: int, warps: int) -> float:
    """The slowest warp's cycles for one product of one of its chains."""
    out = torch.empty(32 * warps, device="cuda")
    cycles = torch.empty(warps, dtype=torch.int64, device="cuda")
    for _ in range(2):  # the first launch warms the instruction cache
        err = lib.run_chains(chains, warps, ITERS, out.data_ptr(), cycles.data_ptr())
        if err:
            raise RuntimeError(f"mma rate probe launch failed: cudaError {err}")
        torch.cuda.synchronize()
    return float(cycles.max()) / ITERS


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("the mma rate probe needs a CUDA card")
    lib = build()
    print(f"card: {torch.cuda.get_device_name(0)}")
    for warps in (1, 4, 8, 16):
        for chains in (1, 2, 4, 8):
            per_chain = cycles_per_product(lib, chains, warps)
            per_warp = per_chain / chains
            per_subcore = per_warp / max(1, warps // 4)
            print(f"mma tf32 m16n8k8: {warps} warps, {chains} chains a warp: "
                  f"{per_chain:.2f} cycles a product of one chain, {per_warp:.2f} a product "
                  f"of one warp, {per_subcore:.2f} a product of one sub-core")
    return 0


if __name__ == "__main__":
    sys.exit(main())
