"""Compile a CUDA source of the port with g++ on the CPU, against an
emulation of the CUDA built-ins its kernels use, so that the tests can run
the kernel's own device code (its indexing, its barriers, its cp.async
ring) where there is no card and no nvcc.

The emulation: one std::thread per CUDA thread (a block at a time),
std::barrier for ``__syncthreads`` and ``__syncwarp``, a per-warp exchange
for ``__shfl_sync`` (every lane of the warp must take part, as on the card;
a warp whose lanes diverge at a shuffle hangs), cp.async copies held back
until ``cp.async.wait_all`` (so a buffer read before its wait holds stale
data) and refused when misaligned; the CUDA runtime calls of the host side
are stubs, and a launch ``k<<<grid, block, smem, stream>>>(args)`` runs the
blocks one after another. The ``asm`` statements of cp.async and the
``extern __shared__`` array are replaced by text substitution (an empty
``asm volatile("" : "+r"(x))`` stays: g++ takes it as it is). Arithmetic
is the CPU's: ``__fdividef`` divides exactly, ``fmaf`` is the C library's.
"""

from __future__ import annotations

import hashlib
import re
import shutil
import subprocess
from pathlib import Path

EMU_H = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <stdexcept>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
#define __restrict__ __restrict

struct uint3 { unsigned x, y, z; };
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidDevice = 101 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaFuncSetAttribute(const void*, cudaFuncAttribute, int) { return cudaSuccess; }
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* b, const void*, int, size_t) {
  *b = 1;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

namespace emu {
struct Block {
  std::barrier<> all;
  std::vector<std::unique_ptr<std::barrier<>>> warp;
  std::vector<float> slots;
  std::vector<float4> smem;
  Block(int nt, size_t smem_bytes) : all(nt), slots(nt), smem(smem_bytes / 16 + 1) {
    for (int w = 0; w < (nt + 31) / 32; ++w)
      warp.emplace_back(new std::barrier<>(std::min(32, nt - 32 * w)));
  }
};
struct Copy { void* dst; const void* src; int bytes; };
inline thread_local Block* blk = nullptr;
inline thread_local std::vector<Copy> pending;
}  // namespace emu

inline thread_local uint3 threadIdx, blockIdx, blockDim;

inline void __syncthreads() { emu::blk->all.arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu::blk->warp[threadIdx.x / 32]->arrive_and_wait();
}
inline float __shfl_sync(unsigned, float v, int lane) {
  const int w = threadIdx.x / 32;
  emu::blk->slots[threadIdx.x] = v;
  emu::blk->warp[w]->arrive_and_wait();
  const float r = emu::blk->slots[32 * w + (lane & 31)];
  emu::blk->warp[w]->arrive_and_wait();
  return r;
}
template <class T> inline T __ldg(const T* p) { return *p; }
inline float __fdividef(float a, float b) { return a / b; }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline unsigned __umulhi(unsigned a, unsigned b) {
  return (unsigned)(((unsigned long long)a * b) >> 32);
}

namespace emu {
inline std::atomic<int> faults{0};
inline void cp_async(void* dst, const void* src, int bytes) {
  if (reinterpret_cast<uintptr_t>(src) % bytes || reinterpret_cast<uintptr_t>(dst) % bytes)
    ++faults;
  pending.push_back({dst, src, bytes});
}
inline void commit() {}
inline void wait_all() {
  for (auto& c : pending) std::memcpy(c.dst, c.src, c.bytes);
  pending.clear();
}
template <class F>
void launch(int grid, int nt, size_t smem, F&& f) {
  for (int b = 0; b < grid; ++b) {
    Block block(nt, smem);
    std::vector<std::thread> ts;
    for (int t = 0; t < nt; ++t)
      ts.emplace_back([&, b, t] {
        threadIdx = {(unsigned)t, 0, 0};
        blockIdx = {(unsigned)b, 0, 0};
        blockDim = {(unsigned)nt, 1, 1};
        blk = &block;
        pending.clear();
        f();
        if (!pending.empty()) ++faults;  // copies never waited for
      });
    for (auto& t : ts) t.join();
  }
}
}  // namespace emu

extern "C" int emu_faults() { return emu::faults.load(); }
"""


def translate(src: str) -> str:
    """The CUDA source as C++ for g++ against ``emu.h``."""
    src = src.replace("#include <cuda_runtime.h>", '#include "emu.h"')
    src = re.sub(r"const unsigned s = static_cast<unsigned>\(__cvta_generic_to_shared\(dst\)\);"
                 r"\s*asm volatile\(\"cp\.async\.ca\.shared\.global.*?: \"memory\"\);",
                 "emu::cp_async(dst, src, BYTES);", src, flags=re.S)
    src = re.sub(r'asm volatile\("cp\.async\.commit_group;\\n" ::: "memory"\);',
                 "emu::commit();", src)
    src = re.sub(r'asm volatile\("cp\.async\.wait_all;\\n" ::: "memory"\);',
                 "emu::wait_all();", src)
    src = src.replace("extern __shared__ float4 smem4[];",
                      "float4* smem4 = emu::blk->smem.data();")
    src = re.sub(r"(\w+<[^<>;]*>)<<<([^,]+),\s*([^,]+),\s*([^,]+),\s*([^>]+)>>>\((.*?)\);",
                 lambda m: (f"emu::launch({m.group(2)}, {m.group(3)}, {m.group(4)}, [&]() "
                            f"{{ {m.group(1)}({m.group(6)}); }});"), src, flags=re.S)
    if re.search(r'asm volatile\("[^"]', src) or "<<<" in src:
        raise ValueError("the source uses a construct the emulation does not translate")
    return src


def compiler() -> str | None:
    return shutil.which("g++")


def build(cu: Path, out_dir: Path) -> Path:
    """A shared library of the translated source in ``out_dir``."""
    code = translate(cu.read_text())
    digest = hashlib.sha256((code + EMU_H).encode()).hexdigest()[:12]
    so = out_dir / f"{cu.stem}-emu-{digest}.so"
    if so.exists():
        return so
    (out_dir / "emu.h").write_text(EMU_H)
    cpp = so.with_suffix(".cpp")
    cpp.write_text(code)
    r = subprocess.run([compiler(), "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                        "-fno-strict-aliasing", "-Wno-unknown-pragmas", "-I", str(out_dir),
                        "-o", str(so), str(cpp)], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"g++ failed on the emulated {cu.name}:\n{r.stderr[-8000:]}")
    return so
