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
blocks one after another. A thread-block cluster (``cudaLaunchKernelEx``
with ``cudaLaunchAttributeClusterDimension``) runs the threads of all its
blocks at once, clusters one after another: ``cooperative_groups``'
``cluster_group`` gives ``sync()``, ``barrier_arrive()`` and
``barrier_wait()`` (one std::barrier across the cluster's threads),
``block_rank()``, ``num_blocks()`` and ``map_shared_rank`` (the same offset
in another block's dynamic shared memory; a pointer outside it counts as a
fault); ``cudaOccupancyMaxActiveClusters`` says 1. The ``asm`` statements of
cp.async and the ``extern __shared__`` array are replaced by text
substitution (an empty
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
#include <optional>
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
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidDevice = 101 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  union {
    struct { unsigned x, y, z; } clusterDim;
  } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaFuncSetAttribute(const void*, cudaFuncAttribute, int) { return cudaSuccess; }
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* b, const void*, int, size_t) {
  *b = 1;
  return cudaSuccess;
}
template <class K>
inline cudaError_t cudaOccupancyMaxActiveClusters(int* n, K, const cudaLaunchConfig_t*) {
  *n = 1;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

namespace emu {
struct Cluster;
struct Block {
  std::barrier<> all;
  std::vector<std::unique_ptr<std::barrier<>>> warp;
  std::vector<float> slots;
  std::vector<float4> smem;
  Cluster* cluster = nullptr;
  int rank = 0;
  Block(int nt, size_t smem_bytes) : all(nt), slots(nt), smem(smem_bytes / 16 + 1) {
    for (int w = 0; w < (nt + 31) / 32; ++w)
      warp.emplace_back(new std::barrier<>(std::min(32, nt - 32 * w)));
  }
};
struct Cluster {
  std::barrier<> all;
  std::vector<Block*> blocks;
  explicit Cluster(int threads) : all(threads) {}
};
struct Copy { void* dst; const void* src; int bytes; };
inline thread_local Block* blk = nullptr;
inline thread_local std::vector<Copy> pending;
inline thread_local std::optional<std::barrier<>::arrival_token> arrival;
inline std::atomic<int> faults{0};
}  // namespace emu

namespace cooperative_groups {
struct cluster_group {
  struct arrival_token {};
  static void sync() { emu::blk->cluster->all.arrive_and_wait(); }
  static arrival_token barrier_arrive() {
    emu::arrival.emplace(emu::blk->cluster->all.arrive());
    return {};
  }
  static void barrier_wait(arrival_token&& = {}) {
    emu::blk->cluster->all.wait(std::move(*emu::arrival));
    emu::arrival.reset();
  }
  static unsigned block_rank() { return (unsigned)emu::blk->rank; }
  static unsigned num_blocks() { return (unsigned)emu::blk->cluster->blocks.size(); }
  template <class T>
  static T* map_shared_rank(T* p, int r) {
    char* base = reinterpret_cast<char*>(emu::blk->smem.data());
    const std::ptrdiff_t off = reinterpret_cast<char*>(p) - base;
    const std::ptrdiff_t size = (std::ptrdiff_t)(emu::blk->smem.size() * sizeof(float4));
    if (off < 0 || off >= size || r < 0 || r >= (int)emu::blk->cluster->blocks.size()) {
      ++emu::faults;
      return p;
    }
    return reinterpret_cast<T*>(
        reinterpret_cast<char*>(emu::blk->cluster->blocks[r]->smem.data()) + off);
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups

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
// Runs the grid as clusters of `cs` blocks, one cluster after another, the
// threads of a cluster's blocks all at once.
template <class F>
void launch_clusters(int grid, int nt, size_t smem, int cs, F&& f) {
  for (int c0 = 0; c0 < grid; c0 += cs) {
    const int n = std::min(cs, grid - c0);
    Cluster cluster(n * nt);
    std::vector<std::unique_ptr<Block>> blocks;
    for (int r = 0; r < n; ++r) {
      blocks.emplace_back(new Block(nt, smem));
      blocks.back()->cluster = &cluster;
      blocks.back()->rank = r;
      cluster.blocks.push_back(blocks.back().get());
    }
    std::vector<std::thread> ts;
    for (int r = 0; r < n; ++r)
      for (int t = 0; t < nt; ++t)
        ts.emplace_back([&, r, t] {
          threadIdx = {(unsigned)t, 0, 0};
          blockIdx = {(unsigned)(c0 + r), 0, 0};
          blockDim = {(unsigned)nt, 1, 1};
          blk = blocks[r].get();
          pending.clear();
          f();
          if (!pending.empty()) ++faults;  // copies never waited for
        });
    for (auto& t : ts) t.join();
  }
}
template <class F>
void launch(int grid, int nt, size_t smem, F&& f) {
  launch_clusters(grid, nt, smem, 1, f);
}
}  // namespace emu

template <class... P, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(P...), A&&... args) {
  int cs = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension)
      cs = (int)cfg->attrs[i].val.clusterDim.x;
  if (cs < 1 || cfg->gridDim.x % cs) return cudaErrorInvalidValue;
  emu::launch_clusters((int)cfg->gridDim.x, (int)cfg->blockDim.x, cfg->dynamicSmemBytes, cs,
                       [&]() { kernel(args...); });
  return cudaSuccess;
}

extern "C" int emu_faults() { return emu::faults.load(); }
"""


def translate(src: str) -> str:
    """The CUDA source as C++ for g++ against ``emu.h``."""
    src = src.replace("#include <cuda_runtime.h>", '#include "emu.h"')
    src = src.replace("#include <cooperative_groups.h>\n", "")
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
