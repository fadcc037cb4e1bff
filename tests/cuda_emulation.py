"""Compile a CUDA source of the port with g++ on the CPU, against an
emulation of the CUDA built-ins its kernels use, so that the tests can run
the kernel's own device code (its indexing, its barriers, its copy rings)
where there is no card and no nvcc.

The emulation runs each CUDA thread as a fiber: a stack of its own and a
hand-written context switch (x86-64; ``ucontext`` elsewhere), all the
threads of a block, or of a thread-block cluster, on the calling thread,
blocks and clusters one after another. A thread runs until it waits, then
the next runs. Barriers (``__syncthreads``, ``__syncwarp``, a named
barrier ``bar.sync id, n``, the cluster's) count arrivals and let their
threads go on once all are in; ``__shfl_sync`` exchanges through a
per-warp slot between two warp barriers (every lane of the warp must take
part, as on the card). A launch in which every live thread waits with no
arrival left to come is a deadlock: it stops, and counts a fault.

Asynchronous copies: cp.async copies are held back until
``cp.async.wait_all`` or until the mbarrier they are tied to
(``cp.async.mbarrier.arrive.noinc``) completes its phase, so a buffer read
before its wait holds stale data, and are refused when misaligned. An
mbarrier (``mbar_*`` helpers of the source, replaced here by name) counts
arrivals and the bytes of its transaction; a 1-D bulk copy
(``bulk_copy``) lands when its barrier's phase completes, and counts a
fault when its addresses or size are not multiples of 16 bytes, or when
the bytes landed exceed those expected. A waiter on a phase that has not
completed yields.

Thread-block clusters (``cudaLaunchKernelEx`` with
``cudaLaunchAttributeClusterDimension``) run the threads of all their
blocks at once: ``cooperative_groups``' ``cluster_group`` gives
``sync()``, ``barrier_arrive()`` and ``barrier_wait()``, ``block_rank()``,
``num_blocks()`` and ``map_shared_rank`` (the same offset in another
block's dynamic shared memory; a pointer outside it counts as a fault);
``cudaOccupancyMaxActiveClusters`` says 1. The CUDA runtime calls of the
host side are stubs. The ``asm`` statements of cp.async, an ``extern
__shared__`` array of any type and the ``<<<...>>>`` launches, of
templates or not, are replaced by text substitution (an empty ``asm
volatile("" : "+r"(x))`` stays: g++ takes it as it is). Arithmetic is the
CPU's: ``__fdividef`` divides exactly, ``fmaf`` is the C library's. The
tensor cores' TF32 product (``mma_tf32_m16n8k8``, replaced by name) is a
warp-wide exchange: each input rounded as ``cvt.rna.tf32.f32`` rounds it
(``to_tf32``), the fragments laid out as the PTX ISA lays out m16n8k8
``.tf32``, the exact products summed in float32.
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
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <map>
#include <memory>
#include <stdexcept>
#include <vector>
#include <sys/mman.h>
#if !defined(__x86_64__)
#include <ucontext.h>
#endif

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
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
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
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 132;
  return cudaSuccess;
}
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

extern "C" void emu_switch(void** save_sp, void* load_sp);

namespace emu {
struct Copy { void* dst; const void* src; int bytes; bool tx; };
// A barrier of threads: arrivals count up to `expected`, then the phase
// moves on and the waiters go.
struct Bar {
  int expected = 0, count = 0;
  unsigned phase = 0;
};
// An mbarrier: pending arrivals, the transaction's bytes, and the copies
// that land when the phase completes.
struct Mbar {
  int expected = 0, arrivals = 0;
  long long tx = 0;
  unsigned phase = 0;
  std::vector<Copy> copies;
};
struct Cluster;
struct Block {
  Bar all;
  std::vector<Bar> warp;
  std::map<int, Bar> named;
  std::map<const void*, Mbar> mbars;
  std::vector<float> slots;
  std::vector<float> mma;  // a warp's fragments, exchanged by mma_tf32_m16n8k8
  std::vector<float4> smem;
  Cluster* cluster = nullptr;
  int rank = 0;
  Block(int nt, size_t smem_bytes) : slots(nt), smem(smem_bytes / 16 + 1) {
    all.expected = nt;
    for (int w = 0; w < (nt + 31) / 32; ++w) {
      warp.emplace_back();
      warp.back().expected = std::min(32, nt - 32 * w);
    }
  }
};
struct Cluster {
  Bar all;
  std::vector<Block*> blocks;
};
struct Fiber {
  void* sp = nullptr;
#if !defined(__x86_64__)
  ucontext_t ctx;
#endif
  char* stack = nullptr;
  uint3 tid, bid;
  Block* blk = nullptr;
  std::vector<Copy> pending;
  std::vector<size_t> groups;
  unsigned cluster_token = 0;
  bool done = false;
};
constexpr size_t kStack = 256 * 1024;
inline int faults_ = 0;
inline long long changes = 0;  // arrivals and completed phases: progress
inline Fiber* cur = nullptr;
inline void* sched_sp = nullptr;
#if !defined(__x86_64__)
inline ucontext_t sched_ctx;
#endif
inline std::vector<char*> stack_pool;
inline const std::function<void()>* body = nullptr;
}  // namespace emu

namespace emu {
inline thread_local Block* blk = nullptr;
inline thread_local std::vector<Copy>* pending = nullptr;
inline thread_local std::vector<size_t>* groups = nullptr;  // ends of committed groups
}  // namespace emu
inline thread_local uint3 threadIdx, blockIdx, blockDim, gridDim;

namespace emu {
inline void yield() {
#if defined(__x86_64__)
  emu_switch(&cur->sp, sched_sp);
#else
  swapcontext(&cur->ctx, &sched_ctx);
#endif
}
inline void arrive_and_wait(Bar& b) {
  const unsigned ph = b.phase;
  ++changes;
  if (++b.count == b.expected) {
    b.count = 0;
    ++b.phase;
    return;
  }
  while (b.phase == ph) yield();
}
inline unsigned arrive(Bar& b) {
  const unsigned ph = b.phase;
  ++changes;
  if (++b.count == b.expected) {
    b.count = 0;
    ++b.phase;
  }
  return ph;
}
inline void wait(Bar& b, unsigned ph) {
  while (b.phase == ph) yield();
}
}  // namespace emu

namespace cooperative_groups {
struct cluster_group {
  struct arrival_token {};
  static void sync() { emu::arrive_and_wait(emu::blk->cluster->all); }
  static arrival_token barrier_arrive() {
    emu::cur->cluster_token = emu::arrive(emu::blk->cluster->all);
    return {};
  }
  static void barrier_wait(arrival_token&& = {}) {
    emu::wait(emu::blk->cluster->all, emu::cur->cluster_token);
  }
  static unsigned block_rank() { return (unsigned)emu::blk->rank; }
  static unsigned num_blocks() { return (unsigned)emu::blk->cluster->blocks.size(); }
  template <class T>
  static T* map_shared_rank(T* p, int r) {
    char* base = reinterpret_cast<char*>(emu::blk->smem.data());
    const std::ptrdiff_t off = reinterpret_cast<char*>(p) - base;
    const std::ptrdiff_t size = (std::ptrdiff_t)(emu::blk->smem.size() * sizeof(float4));
    if (off < 0 || off >= size || r < 0 || r >= (int)emu::blk->cluster->blocks.size()) {
      ++emu::faults_;
      return p;
    }
    return reinterpret_cast<T*>(
        reinterpret_cast<char*>(emu::blk->cluster->blocks[r]->smem.data()) + off);
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups

inline void __syncthreads() { emu::arrive_and_wait(emu::blk->all); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu::arrive_and_wait(emu::blk->warp[threadIdx.x / 32]);
}
inline float __shfl_sync(unsigned, float v, int lane) {
  const int w = threadIdx.x / 32;
  emu::blk->slots[threadIdx.x] = v;
  emu::arrive_and_wait(emu::blk->warp[w]);
  const float r = emu::blk->slots[32 * w + (lane & 31)];
  emu::arrive_and_wait(emu::blk->warp[w]);
  return r;
}
inline float __shfl_xor_sync(unsigned m, float v, int mask) {
  return __shfl_sync(m, v, (int)(threadIdx.x & 31) ^ mask);
}
template <class T> inline T __ldg(const T* p) { return *p; }
template <class T> inline T __ldcs(const T* p) { return *p; }
inline float __fdividef(float a, float b) { return a / b; }
inline int min(int a, int b) { return a < b ? a : b; }
[[noreturn]] inline void __trap() { std::abort(); }
// A clock that moves one tick a read: stamps see time pass, not its amount.
inline long long clock64() {
  static long long ticks = 0;
  return ++ticks;
}
template <class T>
cudaError_t cudaMemcpyFromSymbol(void* dst, const T& symbol, size_t bytes) {
  std::memcpy(dst, &symbol, bytes);
  return cudaSuccess;
}
template <class T>
cudaError_t cudaMemcpyToSymbol(T& symbol, const void* src, size_t bytes) {
  std::memcpy(&symbol, src, bytes);
  return cudaSuccess;
}
inline void __nanosleep(unsigned) {}
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline float __uint_as_float(unsigned i) { float f; std::memcpy(&f, &i, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned i; std::memcpy(&i, &f, 4); return i; }
inline unsigned __umulhi(unsigned a, unsigned b) {
  return (unsigned)(((unsigned long long)a * b) >> 32);
}

namespace emu {
inline bool misaligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes != 0;
}
inline void cp_async(void* dst, const void* src, int bytes) {
  if (misaligned(src, bytes) || misaligned(dst, bytes)) ++faults_;
  pending->push_back({dst, src, bytes, false});
}
inline void commit() {}
inline void wait_all() {
  for (auto& c : *pending) std::memcpy(c.dst, c.src, c.bytes);
  pending->clear();
  groups->clear();
}
inline Mbar& mbar(const void* p) {
  auto it = blk->mbars.find(p);
  if (it == blk->mbars.end()) {
    ++faults_;  // an mbarrier used before its init
    it = blk->mbars.emplace(p, Mbar{}).first;
  }
  return it->second;
}
inline void mbar_arrive_on(Mbar& m) {
  ++changes;
  if (--m.arrivals < 0) ++faults_;  // more arrivals than the phase expects
}
// Completes the phase once every arrival is in and every byte expected
// has landed: the copies land here and not before.
inline void mbar_settle(Mbar& m) {
  if (m.arrivals != 0) return;
  for (auto& c : m.copies) {
    std::memcpy(c.dst, c.src, c.bytes);
    if (c.tx) m.tx -= c.bytes;
  }
  m.copies.clear();
  if (m.tx < 0) ++faults_;  // more bytes landed than were expected
  if (m.tx != 0) return;
  ++m.phase;
  m.arrivals = m.expected;
  ++changes;
}
}  // namespace emu

// The mbarrier, bulk-copy and named-barrier helpers of a source, by name.
inline void mbar_init(unsigned long long* bar, unsigned count) {
  emu::Mbar m;
  m.expected = m.arrivals = (int)count;
  emu::blk->mbars[bar] = m;
  ++emu::changes;
}
inline void mbar_fence_init() {}
inline void mbar_arrive(unsigned long long* bar) { emu::mbar_arrive_on(emu::mbar(bar)); }
inline void mbar_arrive_tx(unsigned long long* bar, unsigned bytes) {
  emu::Mbar& m = emu::mbar(bar);
  m.tx += bytes;
  emu::mbar_arrive_on(m);
}
inline bool mbar_try_wait(unsigned long long* bar, unsigned parity) {
  emu::Mbar& m = emu::mbar(bar);
  emu::mbar_settle(m);
  if ((m.phase & 1u) != parity) return true;
  emu::yield();
  return false;
}
inline void bulk_copy(void* dst, const void* src, unsigned bytes, unsigned long long* bar) {
  if (emu::misaligned(dst, 16) || emu::misaligned(src, 16) || bytes % 16) ++emu::faults_;
  emu::mbar(bar).copies.push_back({dst, src, (int)bytes, true});
}
template <int BYTES>
inline void async_copy(float* dst, const float* src) { emu::cp_async(dst, src, BYTES); }
inline void async_commit() { emu::groups->push_back(emu::pending->size()); }
// cp.async.wait_group N: the copies of all but the N youngest committed
// groups land.
template <int N>
inline void async_wait() {
  auto& g = *emu::groups;
  if (g.size() <= (size_t)N) return;
  const size_t upto = g[g.size() - N - 1];
  for (size_t i = 0; i < upto; ++i) {
    const emu::Copy& c = (*emu::pending)[i];
    std::memcpy(c.dst, c.src, c.bytes);
  }
  emu::pending->erase(emu::pending->begin(), emu::pending->begin() + upto);
  g.erase(g.begin(), g.end() - N);
  for (auto& e : g) e -= upto;
}
// bar.sync id, n: the first arrivals of n threads at barrier id release
// them (ids above 0; 0 is __syncthreads').
inline void named_sync(int id, int n) {
  emu::Bar& b = emu::blk->named[id];
  if (b.expected == 0) b.expected = n;
  if (b.expected != n) ++emu::faults_;
  emu::arrive_and_wait(b);
}
// cvt.rna.tf32.f32: to 10 mantissa bits, to nearest, ties away from zero
// (the magnitude's bits rounded up at half); infinities and NaN as they are.
inline float to_tf32(float x) {
  unsigned u = __float_as_uint(x);
  if ((u & 0x7f800000u) != 0x7f800000u) u = (u + 0x1000u) & 0xffffe000u;
  return __uint_as_float(u);
}
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, d += a·b: each lane
// posts its fragments (each input rounded as cvt.rna.tf32 rounds it), the
// warp meets, and each lane forms its four outputs from the PTX ISA's
// fragment layout (g = lane / 4, q = lane % 4: a = A[g][q], A[g+8][q],
// A[g][q+4], A[g+8][q+4]; b = B[q][g], B[q+4][g]; d = D[g][2q],
// D[g][2q+1], D[g+8][2q], D[g+8][2q+1]): the eight exact products summed
// in float32 in k's order, then added to d.
inline void mma_tf32_m16n8k8(float (&d)[4], const float (&a)[4], const float (&b)[2]) {
  emu::Block& blk = *emu::blk;
  if (blk.mma.empty()) blk.mma.resize(blk.slots.size() * 6);
  const int w = threadIdx.x / 32, lane = threadIdx.x & 31;
  float* mine = &blk.mma[threadIdx.x * 6];
  for (int e = 0; e < 4; ++e) mine[e] = to_tf32(a[e]);
  for (int e = 0; e < 2; ++e) mine[4 + e] = to_tf32(b[e]);
  emu::arrive_and_wait(blk.warp[w]);
  const float* f = &blk.mma[32 * w * 6];
  const int g = lane >> 2, q = lane & 3;
  float out[4];
  for (int e = 0; e < 4; ++e) {
    const int r = g + 8 * (e >> 1), c = 2 * q + (e & 1);
    float s = 0.f;
    for (int k = 0; k < 8; ++k) {
      const float av = f[((r % 8) * 4 + k % 4) * 6 + r / 8 + 2 * (k / 4)];
      const float bv = f[(c * 4 + k % 4) * 6 + 4 + k / 4];
      s += av * bv;
    }
    out[e] = d[e] + s;
  }
  emu::arrive_and_wait(blk.warp[w]);
  for (int e = 0; e < 4; ++e) d[e] = out[e];
}
inline void async_copy_arrive(unsigned long long* bar) {
  emu::Mbar& m = emu::mbar(bar);
  for (auto& c : *emu::pending) m.copies.push_back(c);
  emu::pending->clear();
  emu::mbar_arrive_on(m);
}

namespace emu {
[[noreturn]] inline void fiber_main() {
  (*body)();
  cur->done = true;
  ++changes;
  for (;;) yield();
}
inline char* take_stack() {
  if (!stack_pool.empty()) {
    char* s = stack_pool.back();
    stack_pool.pop_back();
    return s;
  }
  void* p = mmap(nullptr, kStack, PROT_READ | PROT_WRITE, MAP_PRIVATE | MAP_ANONYMOUS |
                 MAP_NORESERVE, -1, 0);
  if (p == MAP_FAILED) throw std::runtime_error("no memory for a fiber's stack");
  mprotect(p, 4096, PROT_NONE);  // a guard page below the stack
  return static_cast<char*>(p);
}
inline void start(Fiber& f) {
  f.stack = take_stack();
#if defined(__x86_64__)
  auto top = reinterpret_cast<uintptr_t>(f.stack + kStack) & ~uintptr_t(15);
  void** sp = reinterpret_cast<void**>(top);
  *--sp = nullptr;                                  // fiber_main's return address
  *--sp = reinterpret_cast<void*>(&fiber_main);     // where emu_switch returns to
  for (int i = 0; i < 6; ++i) *--sp = nullptr;      // rbp, rbx, r12-r15
  f.sp = sp;
#else
  getcontext(&f.ctx);
  f.ctx.uc_stack.ss_sp = f.stack + 4096;
  f.ctx.uc_stack.ss_size = kStack - 4096;
  f.ctx.uc_link = nullptr;
  makecontext(&f.ctx, (void (*)())fiber_main, 0);
#endif
}
inline unsigned seed = 0;  // 0: every warp each round; else warps at random speeds
inline unsigned launches = 0;
// Runs the fibers round robin until all have returned. With a seed, each
// warp of the launch gets a speed of 1, 1/2 or 1/4 (it runs every round,
// every second or every fourth), so warps drift apart as they may on the
// card; every fourth round runs them all. A round that runs them all in
// which nothing arrived, completed or returned is a deadlock.
inline void run(std::vector<Fiber>& fibers, const std::function<void()>& f, int nt) {
  body = &f;
  for (auto& fb : fibers) start(fb);
  std::vector<unsigned> period((fibers.size() / nt) * ((nt + 31) / 32), 1);  // one a warp
  if (seed) {
    unsigned x = seed * 2654435761u + 0x9e3779b9u * ++launches;
    for (auto& p : period) {
      x ^= x << 13;
      x ^= x >> 17;
      x ^= x << 5;
      p = 1u << (x % 3);
    }
  }
  size_t live = fibers.size();
  for (unsigned round = 0; live; ++round) {
    const long long before = changes;
    for (size_t i = 0; i < fibers.size(); ++i) {
      Fiber& fb = fibers[i];
      if (fb.done) continue;
      const size_t w = (i / nt) * ((nt + 31) / 32) + fb.tid.x / 32;  // the warp's index
      if (round % period[w]) continue;
      cur = &fb;
      threadIdx = fb.tid;
      blockIdx = fb.bid;
      blk = fb.blk;
      pending = &fb.pending;
      groups = &fb.groups;
#if defined(__x86_64__)
      emu_switch(&sched_sp, fb.sp);
#else
      swapcontext(&sched_ctx, &fb.ctx);
#endif
      if (fb.done) {
        --live;
        if (!fb.pending.empty()) ++faults_;  // copies never waited for
      }
    }
    if (round % 4 == 0 && live && changes == before) {
      ++faults_;  // every live thread waits on something that cannot come
      std::fprintf(stderr, "emulation: deadlock with %zu threads waiting\n", live);
      break;
    }
  }
  for (auto& fb : fibers)
    if (fb.done) stack_pool.push_back(fb.stack);  // a deadlocked fiber's stack is dropped
  cur = nullptr;
}
// Runs the grid as clusters of `cs` blocks (along x), one cluster after
// another, the threads of a cluster's blocks all at once.
template <class F>
void launch_clusters(dim3 grid, int nt, size_t smem, int cs, F&& f) {
  const std::function<void()> fn = f;
  for (unsigned gy = 0; gy < grid.y; ++gy)
    for (unsigned c0 = 0; c0 < grid.x; c0 += cs) {
      const int n = std::min<int>(cs, (int)(grid.x - c0));
      Cluster cluster;
      cluster.all.expected = n * nt;
      std::vector<std::unique_ptr<Block>> blocks;
      for (int r = 0; r < n; ++r) {
        blocks.emplace_back(new Block(nt, smem));
        blocks.back()->cluster = &cluster;
        blocks.back()->rank = r;
        cluster.blocks.push_back(blocks.back().get());
      }
      std::vector<Fiber> fibers(n * nt);
      for (int r = 0; r < n; ++r)
        for (int t = 0; t < nt; ++t) {
          Fiber& fb = fibers[r * nt + t];
          fb.tid = {(unsigned)t, 0, 0};
          fb.bid = {c0 + r, gy, 0};
          fb.blk = blocks[r].get();
        }
      blockDim = {(unsigned)nt, 1, 1};
      gridDim = {grid.x, grid.y, grid.z};
      run(fibers, fn, nt);
    }
}
template <class F>
void launch(dim3 grid, int nt, size_t smem, F&& f) {
  launch_clusters(grid, nt, smem, 1, f);
}
}  // namespace emu

#if defined(__x86_64__)
// Saves the callee-saved registers and the stack pointer of the running
// context in *save_sp, and resumes the one whose stack pointer is load_sp.
asm(R"(
.text
.globl emu_switch
.type emu_switch,@function
emu_switch:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
.size emu_switch, .-emu_switch
)");
#endif

template <class... P, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(P...), A&&... args) {
  int cs = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension)
      cs = (int)cfg->attrs[i].val.clusterDim.x;
  if (cs < 1 || cfg->gridDim.x % cs) return cudaErrorInvalidValue;
  emu::launch_clusters(cfg->gridDim, (int)cfg->blockDim.x, cfg->dynamicSmemBytes, cs,
                       [&]() { kernel(args...); });
  return cudaSuccess;
}

extern "C" int emu_faults() { return emu::faults_; }
extern "C" void emu_set_seed(unsigned s) { emu::seed = s; }
"""

# Device helpers that a source defines with inline PTX and the emulation
# replaces, by name (EMU_H defines each with the same signature).
EMULATED_HELPERS = ("smem_addr", "async_commit", "async_wait", "mbar_init", "mbar_fence_init",
                    "mbar_arrive", "mbar_arrive_tx", "mbar_try_wait",
                    "bulk_copy", "async_copy", "async_copy_arrive", "named_sync",
                    "mma_tf32_m16n8k8")


def _drop_helpers(src: str) -> str:
    """The source without its definitions of ``EMULATED_HELPERS``."""
    for name in EMULATED_HELPERS:
        m = re.search(r"(?:template <[^>]*>\s*)?__device__ __forceinline__ [\w ]+?\b"
                      + name + r"\(", src)
        if not m:
            continue
        depth, i = 0, src.index("{", m.end())
        for j in range(i, len(src)):
            depth += {"{": 1, "}": -1}.get(src[j], 0)
            if depth == 0:
                break
        src = src[:m.start()] + src[j + 1:]
    return src


def translate(src: str) -> str:
    """The CUDA source as C++ for g++ against ``emu.h``."""
    src = src.replace("#include <cuda_runtime.h>", '#include "emu.h"')
    src = src.replace("#include <cooperative_groups.h>\n", "")
    src = _drop_helpers(src)
    src = re.sub(r"const unsigned s = static_cast<unsigned>\(__cvta_generic_to_shared\(dst\)\);"
                 r"\s*asm volatile\(\"cp\.async\.ca\.shared\.global.*?: \"memory\"\);",
                 "emu::cp_async(dst, src, BYTES);", src, flags=re.S)
    src = re.sub(r'asm volatile\("cp\.async\.commit_group;\\n" ::: "memory"\);',
                 "emu::commit();", src)
    src = re.sub(r'asm volatile\("cp\.async\.wait_all;\\n" ::: "memory"\);',
                 "emu::wait_all();", src)
    src = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(emu::blk->smem.data());", src)
    src = re.sub(r"(\w+(?:<[^<>;]*>)?)\s*<<<([^,]+),\s*([^,]+),\s*([^,]+),\s*([^>]+)>>>\((.*?)\);",
                 lambda m: (f"emu::launch({m.group(2)}, {m.group(3)}, {m.group(4)}, [&]() "
                            f"{{ {m.group(1)}({m.group(6)}); }});"), src, flags=re.S)
    if re.search(r'\basm(?: volatile)?\("[^"]', src) or "<<<" in src:
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
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "emu.h").write_text(EMU_H)
    cpp = so.with_suffix(".cpp")
    cpp.write_text(code)
    tmp = so.with_suffix(f".{hashlib.sha256(str(out_dir).encode()).hexdigest()[:6]}.tmp")
    r = subprocess.run([compiler(), "-std=c++20", "-O1", "-shared", "-fPIC",
                        "-fno-strict-aliasing", "-Wno-unknown-pragmas", "-I", str(out_dir),
                        "-o", str(tmp), str(cpp)], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"g++ failed on the emulated {cu.name}:\n{r.stderr[-8000:]}")
    tmp.replace(so)
    return so
