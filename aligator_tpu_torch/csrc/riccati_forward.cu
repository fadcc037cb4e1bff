// Fused closed-loop forward rollout of the proximal Riccati recursion for
// a batch of problems, float32, on the caller's stream.
//
// Replaces: aligator_tpu/gar/pallas_riccati.py `_forward_kernel`
// (launched by `forward_sweep_batched`). For t = 0..N:
//   u = kff + K x,  v = zff + Z x,  λ = vx + Vxx x (λ₀ = lbd0),
//   x⁺ = yff + A_cl x.
//
// What bounds it on an H100: every gain is read once (~36 KB per knot at
// nx = 56, nu = nc = 22; 0.94 GB at B = 256, N = 100) for 2 FLOP per 4 B,
// so at large batches the function is bound by HBM bandwidth (0.279 ms at
// 3.35 TB/s). Only x⁺ = yff + A_cl x is a chain over t: at small batches a
// problem's steps, one dependent mat-vec of nx terms each, bound it. u, v
// and λ at knot t need x_t alone and feed nothing later.
//
// Two designs, picked by `fused_riccati.forward_plan` (the C entry
// `riccati_forward_plan` answers the same):
//
// A. `riccati_forward_small<NXC>`, one launch a sweep, one block a problem,
//    for every nx in 1..112 but 56. The class NXC in {16, 32, 64, 112} is
//    the least that holds nx: its loop extents cover nx and no more. Warps
//    by role:
//    - the chain: ceil(NXC / 32) warps, one lane a row of A_cl. A lane keeps
//      its row of knot t and its entry of yff in registers, loaded while
//      step t - 1 ends; x_t is read from the ring (float4 broadcasts) and
//      summed in four partial sums. The chain's warps meet once a step:
//      `__syncwarp` for one warp, a named barrier (`bar.sync 1, 32·warps`)
//      for more; no step waits on the whole block.
//    - one producer warp copies the knots' A_cl, yff (and, where two knots
//      of them fit, K, Z and Vxx) into a ring of S knots in shared memory,
//      as deep as fits 227 KB (the quadrotor's whole horizon; 18 knots at
//      the jump's widths), a chunk of m knots at a time (S / 16, 1 to 4:
//      the ring is laid out as arrays of slots, so a chunk is one run in
//      each, as in device memory): a 1-D bulk copy an array
//      (`cp.async.bulk`, one thread, completion counted in bytes on the
//      chunk's mbarrier) where nx % 4 == 0 and every row-wise input is
//      16-byte aligned, else cp.async of 8 or 4 bytes by the warp's lanes,
//      tied to the chunk's mbarrier (`cp.async.mbarrier.arrive.noinc`).
//      Copies loop over runs, rows and columns: no division.
//    - the rows: the other warps take the ring's chunks in turn (chunk c to
//      warp c mod W, each warp its chunks' knots in order, so no barrier is
//      ever two phases behind a waiter). Each waits on the chunk's
//      mbarriers (copies landed; the chain wrote the chunk's x into the
//      ring), computes its knots' u, v and λ from shared memory, four lanes
//      a row, and frees the chunk. They follow the chain a chunk behind,
//      off its critical path, and wait asleep (`__nanosleep` between
//      tries), so they take no issue slots from it.
//    Each chunk has three mbarriers: full (the copies), x (the chain wrote
//    its x) and empty (the chain and the chunk's rows warp are done with
//    it), so the producer refills a chunk only after both have read it.
// B. The pair at nx = 56 compiled in, measured faster there than the
//    small kernel at every batch from 1 to 256 (PERF.md §6):
//    `riccati_forward_chain_kernel<56, 6>` (xs alone, one block per
//    problem, Acl and yff prefetched by cp.async into a ring of 6 knots,
//    four threads a row, one barrier a step; two blocks to an SM), then
//    `riccati_forward_rows_kernel<56>` (u, v and λ of all knots over a
//    (4-knot chunk, problem) grid that fills the card; sixteen lanes a row,
//    evict-first loads).
// No tensor cores: the products are full float32.

#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kBenchNx = 56;      // lqr56 and the talos walk
constexpr int kBenchRing = 6;     // ring depth of the pair's chain
constexpr int kMaxNx = 112;       // the widest class
constexpr int kRowThreads = 256;
constexpr int kLanesPerRow = 16;
constexpr int kGroups = kRowThreads / kLanesPerRow;
constexpr int kUnroll = 4;
constexpr int kKnotsPerBlock = 4;
constexpr int kMaxDevices = 64;
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may take
constexpr int kTwoBlockSmem = 115712;  // each of two blocks on an SM
constexpr int kSmallUnroll = 4;   // rows in flight per lane group of the small kernel
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int r4(int n) { return (n + 3) & ~3; }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// Asynchronous copies, mbarriers and named barriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
template <int BYTES>
__device__ __forceinline__ void async_copy(float* dst, const float* src) {
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "n"(BYTES)
                 : "memory");
}
__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// The chunk's mbarrier counts this thread's earlier cp.async copies as one
// of its expected arrivals, made when they have landed.
__device__ __forceinline__ void async_copy_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// Makes the barriers' initialization visible to the copy engine.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// One arrival that also expects `bytes` of bulk copies on this phase.
__device__ __forceinline__ void mbar_arrive_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(unsigned long long* bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}
// Waits for the completion of the barrier's phase of this parity; a phase
// that never completes (a fault) traps after ~2^26 tries instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  for (unsigned tries = 0; !mbar_try_wait(bar, parity);)
    if (++tries == (1u << 26)) __trap();
}
// The same for a warp off the chain's critical path: between tries it
// sleeps, up to ~0.25 µs, so that a waiting warp takes no issue slots from
// the chain's.
__device__ __forceinline__ void mbar_wait_idle(unsigned long long* bar, unsigned parity) {
  for (unsigned tries = 0, ns = 32; !mbar_try_wait(bar, parity); ns = ns < 256 ? 2 * ns : ns) {
    if (++tries == (1u << 26)) __trap();
    __nanosleep(ns);
  }
}
// A barrier of the first n threads (whole warps) only: id 1, as 0 is
// __syncthreads'.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
// The chain's warps meet once a step: one warp by __syncwarp, more by a
// named barrier; no step waits on the whole block.
template <int CW>
__device__ __forceinline__ void chain_sync() {
  if constexpr (CW == 1)
    __syncwarp();
  else
    named_sync(1, 32 * CW);
}
// A 1-D bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) into shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// A. The small kernel: one launch a sweep, one block a problem
// ---------------------------------------------------------------------------

// Warps of the small kernel: the chain's (one a 32 rows), the producer's
// one, the rows'.
__host__ __device__ constexpr int chain_warps(int nxc) { return cdiv(nxc, 32); }
__host__ __device__ constexpr int row_warps(int nxc) { return nxc >= 64 ? 8 : 4; }
__host__ __device__ constexpr int small_threads(int nxc) {
  return 32 * (chain_warps(nxc) + 1 + row_warps(nxc));
}

struct Fwd {
  const float *Acl, *yff, *x0, *K, *Z, *Vxx, *kff, *zff, *vx, *lbd0;
  float *xs, *us, *vs, *lbds;
  int L, nx, nu, nc;
  int chunk;   // m: the knots that one copy request and one barrier cover
  int chunks;  // C: the chunks of the ring, S = C·m knots
  int staged;  // K, Z and Vxx go through the ring (else the rows read device memory)
  int copy;    // 0: 1-D bulk copies; 4, 2, 1: cp.async of 16, 8 or 4 bytes
  int rows;    // 0: the chain alone (u, v, λ not written; for timing the parts)
};

// The ring of S knots, in floats from its start: an array of S slots each
// for A_cl (nx rows of stride ld), yff, x, then (staged) K, Z and Vxx (rows
// of stride ld), so that a chunk's m knots are one run in each array, as in
// device memory. ld = r4(nx): the rows are dense where nx % 4 == 0, else
// padded with zeros.
struct Layout {
  int ld, xr, y, x, k, z, v, size;
  __host__ __device__ Layout(int nx, int nu, int nc, int S, bool staged) {
    ld = r4(nx);
    xr = r4(nx);
    y = S * nx * ld;
    x = y + S * xr;
    k = x + S * xr;
    z = k + S * nu * ld;
    v = z + S * nc * ld;
    size = staged ? v + S * nx * ld : k;
  }
};
// Floats of the three mbarriers of each of C chunks, before the ring.
__host__ __device__ constexpr int bar_floats(int C) { return r4(6 * C); }

// A warp's cp.async copies of the rows × cols block at src into shared
// memory at dst (row stride ld), W floats each: one flat run where the rows
// are dense, else row by row.
template <int W>
__device__ __forceinline__ void copy_rows(float* dst, int ld, const float* src, int rows,
                                          int cols, int lane) {
  if (ld == cols) {
    for (int i = W * lane; i < rows * cols; i += 32 * W) async_copy<4 * W>(dst + i, src + i);
    return;
  }
  for (int r = 0; r < rows; ++r)
    for (int c = W * lane; c < cols; c += 32 * W)
      async_copy<4 * W>(dst + r * ld + c, src + (size_t)r * cols + c);
}
__device__ __forceinline__ void copy_rows_vec(float* dst, int ld, const float* src, int rows,
                                              int cols, int lane, int vec) {
  if (vec == 4)
    copy_rows<4>(dst, ld, src, rows, cols, lane);
  else if (vec == 2)
    copy_rows<2>(dst, ld, src, rows, cols, lane);
  else
    copy_rows<1>(dst, ld, src, rows, cols, lane);
}

// Four consecutive floats of a row at p, rem of them inside the row, in
// copies of vec floats (nx % vec == 0, p aligned to vec floats); zeros past
// the row. `stream` marks data used once (evict-first loads).
template <bool STREAM>
__device__ __forceinline__ float4 load4(const float* p, int rem, int vec) {
  if (vec == 4)
    return STREAM ? __ldcs(reinterpret_cast<const float4*>(p))
                  : __ldg(reinterpret_cast<const float4*>(p));
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  if (vec == 2) {
    const float2 a = STREAM ? __ldcs(reinterpret_cast<const float2*>(p))
                            : __ldg(reinterpret_cast<const float2*>(p));
    r.x = a.x;
    r.y = a.y;
    if (rem > 2) {
      const float2 c = STREAM ? __ldcs(reinterpret_cast<const float2*>(p + 2))
                              : __ldg(reinterpret_cast<const float2*>(p + 2));
      r.z = c.x;
      r.w = c.y;
    }
  } else {
    r.x = STREAM ? __ldcs(p) : __ldg(p);
    if (rem > 1) r.y = STREAM ? __ldcs(p + 1) : __ldg(p + 1);
    if (rem > 2) r.z = STREAM ? __ldcs(p + 2) : __ldg(p + 2);
    if (rem > 3) r.w = STREAM ? __ldcs(p + 3) : __ldg(p + 3);
  }
  return r;
}

template <int NXC>
__global__ void __launch_bounds__(small_threads(NXC), 1) riccati_forward_small(const Fwd a) {
  constexpr int kCW = chain_warps(NXC), kRW = row_warps(NXC), kQ = NXC / 4;
  const int nx = a.nx, nu = a.nu, nc = a.nc, L = a.L, m = a.chunk, C = a.chunks, S = m * C;
  const int nq = (nx + 3) >> 2;
  const bool bulk = a.copy == 0, staged = a.staged != 0;
  const Layout ly(nx, nu, nc, S, staged);
  const int ld = ly.ld, xr = ly.xr;
  extern __shared__ float4 smem4[];
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem4);
  unsigned long long* xin = full + C;
  unsigned long long* empty = xin + C;
  float* ring = reinterpret_cast<float*>(smem4) + bar_floats(C);
  float *A = ring, *Y = ring + ly.y, *X = ring + ly.x;
  float *Kr = ring + ly.k, *Zr = ring + ly.z, *Vr = ring + ly.v;
  const size_t b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // The copies of chunk q (knots k0 = q·m, ...) into ring chunk c = q mod C:
  // one bulk copy an array by one thread, or cp.async by the producer warp.
  auto issue = [&](int k0, int c) {
    const int n = min(m, L - k0), na = min(n, L - 1 - k0);  // knots, and of them the chain's
    const int s0 = c * m;
    const size_t kt = b * L + k0;
    if (bulk) {
      const unsigned ab = 4u * na * (nx * nx + nx);
      const unsigned rb = staged ? 4u * n * (nu + nc + nx) * nx : 0u;
      mbar_arrive_tx(full + c, ab + rb);
      if (na > 0) {
        bulk_copy(A + s0 * nx * ld, a.Acl + kt * nx * nx, 4u * na * nx * nx, full + c);
        bulk_copy(Y + s0 * xr, a.yff + kt * nx, 4u * na * nx, full + c);
      }
      if (staged) {
        if (nu > 0) bulk_copy(Kr + s0 * nu * ld, a.K + kt * nu * nx, 4u * n * nu * nx, full + c);
        if (nc > 0) bulk_copy(Zr + s0 * nc * ld, a.Z + kt * nc * nx, 4u * n * nc * nx, full + c);
        bulk_copy(Vr + s0 * nx * ld, a.Vxx + kt * nx * nx, 4u * n * nx * nx, full + c);
      }
      return;
    }
    for (int i = 0; i < n; ++i) {
      const size_t ki = kt + i;
      const int si = s0 + i;
      if (i < na) {
        copy_rows_vec(A + si * nx * ld, ld, a.Acl + ki * nx * nx, nx, nx, lane, a.copy);
        copy_rows_vec(Y + si * xr, nx, a.yff + ki * nx, 1, nx, lane, a.copy);
      }
      if (staged) {
        copy_rows_vec(Kr + si * nu * ld, ld, a.K + ki * nu * nx, nu, nx, lane, a.copy);
        copy_rows_vec(Zr + si * nc * ld, ld, a.Z + ki * nc * nx, nc, nx, lane, a.copy);
        copy_rows_vec(Vr + si * nx * ld, ld, a.Vxx + ki * nx * nx, nx, nx, lane, a.copy);
      }
    }
    async_copy_arrive(full + c);
  };
  // the producer's first thread sets up the barriers and, for bulk copies,
  // sends chunk 0 before the block's barrier, so that its copies land while
  // the block starts
  if (threadIdx.x == 32 * kCW) {
    for (int c = 0; c < C; ++c) {
      mbar_init(full + c, bulk ? 1 : 32);
      mbar_init(xin + c, 1);
      mbar_init(empty + c, 2);
    }
    mbar_fence_init();
    if (bulk) issue(0, 0);
  }
  // zero pads: x past nx; the rows' columns past nx (nx % 4 != 0)
  for (int i = threadIdx.x; i < S; i += blockDim.x)
    for (int c = nx; c < xr; ++c) X[i * xr + c] = 0.f;
  if (ld > nx) {
    for (int r = threadIdx.x; r < S * nx; r += blockDim.x)  // A's rows
      for (int c = nx; c < ld; ++c) A[r * ld + c] = 0.f;
    if (staged)  // K's, Z's and Vxx's rows, one run
      for (int r = threadIdx.x; r < S * (nu + nc + nx); r += blockDim.x)
        for (int c = nx; c < ld; ++c) Kr[r * ld + c] = 0.f;
  }
  for (int r = threadIdx.x; r < nx; r += blockDim.x) {
    const float v = a.x0[b * nx + r];
    X[r] = v;
    a.xs[b * L * nx + r] = v;
  }
  __syncthreads();

  if (warp < kCW) {
    // the chain: lane r holds row r of A_cl,t in registers (loaded a step
    // ahead) and reads x_t from the ring; knot t in slot s, chunk c
    // (position j in it), round parity ph
    const int r = threadIdx.x;
    const bool live = r < nx;
    const int steps = L - 1;  // the terminal knot's A_cl and yff are not read
    float4 arow[kQ];
    float y = 0.f;
    if (steps > 0) {
      mbar_wait(full, 0);
#pragma unroll
      for (int q = 0; q < kQ; ++q)
        if (live && q < nq) arow[q] = reinterpret_cast<const float4*>(A + r * ld)[q];
      if (live) y = Y[r];
    }
    if (threadIdx.x == 0 && (m == 1 || L == 1)) mbar_arrive(xin);  // chunk 0's x are in
    int s = 0, j = 0, c = 0;
    unsigned ph = 0;
    for (int t = 0; t < steps; ++t) {
      int sn = s + 1, jn = j + 1, cn = c;
      unsigned phn = ph;
      if (jn == m) {
        jn = 0;
        if (++cn == C) {
          cn = sn = 0;
          phn ^= 1u;
        }
      }
      // x⁺ = yff + A_cl x: x_t in float4 broadcasts, four partial sums
      const float4* xt = reinterpret_cast<const float4*>(X + s * xr);
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int q = 0; q < kQ; ++q)
        if (q < nq) {
          const float4 xv = xt[q];
          if (live) {
            a0 = fmaf(arow[q].x, xv.x, a0);
            a1 = fmaf(arow[q].y, xv.y, a1);
            a2 = fmaf(arow[q].z, xv.z, a2);
            a3 = fmaf(arow[q].w, xv.w, a3);
          }
        }
      const float v = y + ((a0 + a1) + (a2 + a3));
      // a new chunk: its earlier knots released, its copies landed
      if (jn == 0) mbar_wait(full + cn, phn);
      if (live) {
        X[sn * xr + r] = v;
        a.xs[(b * L + t + 1) * nx + r] = v;
        if (t + 1 < steps) {  // A_cl,t+1's row and yff, in flight across the barrier
#pragma unroll
          for (int q = 0; q < kQ; ++q)
            if (q < nq) arow[q] = reinterpret_cast<const float4*>(A + (sn * nx + r) * ld)[q];
          y = Y[sn * xr + r];
        }
      }
      chain_sync<kCW>();
      if (threadIdx.x == 0) {
        if (jn == m - 1 || t + 2 == L) mbar_arrive(xin + cn);  // chunk cn's x are in
        if (j == m - 1) mbar_arrive(empty + c);                 // the chain is done with c
      }
      s = sn;
      j = jn;
      c = cn;
      ph = phn;
    }
  } else if (warp == kCW) {
    // the producer: chunk q into ring chunk q mod C once its earlier knots
    // are released (round parity ph)
    if (bulk && lane != 0) return;
    int k0 = 0, c = 0;
    unsigned ph = 0;
    if (bulk) {  // chunk 0 is out
      k0 = m;
      if (++c == C) {
        c = 0;
        ph = 1u;
      }
    }
    for (; k0 < L; k0 += m) {
      if (k0 >= S) mbar_wait_idle(empty + c, ph ^ 1u);
      issue(k0, c);
      if (++c == C) {
        c = 0;
        ph ^= 1u;
      }
    }
  } else {
    // the rows: chunk c to rows warp c mod kRW, its knots in order, so that
    // a warp waits on a chunk's barrier only after it has consumed the
    // chunk's previous knots (a barrier is never two phases behind its
    // waiter); four lanes a row, each lane the row's float4 chunks sub,
    // sub + 4, ...
    const int rw = warp - kCW - 1, g = lane >> 2, sub = lane & 3;
    unsigned ph = 0;
    for (int base = 0; base < L; base += S, ph ^= 1u) {
      for (int c = rw; c < C && base + c * m < L; c += kRW) {
        mbar_wait_idle(full + c, ph);
        mbar_wait_idle(xin + c, ph);
        for (int s = c * m; s < (c + 1) * m && base + s < L; ++s) {
          const int t = base + s;
          const float4* xt = reinterpret_cast<const float4*>(X + s * xr);
          const size_t kt = b * L + t;
          const float* Ks = staged ? Kr + s * nu * ld : a.K + kt * nu * nx;
          const float* Zs = staged ? Zr + s * nc * ld : a.Z + kt * nc * nx;
          const float* Vs = staged ? Vr + s * nx * ld : a.Vxx + kt * nx * nx;
          const int rl = staged ? ld : nx;
          // λ₀ = lbd0: no product at t = 0
          const int rows = a.rows ? (t == 0 ? nu + nc : nu + nc + nx) : 0;
          for (int i0 = 0; i0 < rows; i0 += 8 * kSmallUnroll) {  // the same trips for all lanes
            const float* row[kSmallUnroll];
            float* out[kSmallUnroll];
            float off[kSmallUnroll], acc[kSmallUnroll];
#pragma unroll
            for (int u = 0; u < kSmallUnroll; ++u) {
              const int i = i0 + g + 8 * u;
              row[u] = nullptr;
              out[u] = nullptr;
              off[u] = acc[u] = 0.f;
              if (i >= rows) continue;
              if (i < nu) {
                row[u] = Ks + i * rl;
                out[u] = a.us + kt * nu + i;
                if (sub == 0) off[u] = __ldcs(a.kff + kt * nu + i);
              } else if (i < nu + nc) {
                row[u] = Zs + (i - nu) * rl;
                out[u] = a.vs + kt * nc + (i - nu);
                if (sub == 0) off[u] = __ldcs(a.zff + kt * nc + (i - nu));
              } else {
                const int jx = i - nu - nc;
                row[u] = Vs + jx * rl;
                out[u] = a.lbds + kt * nx + jx;
                if (sub == 0) off[u] = __ldcs(a.vx + kt * nx + jx);
              }
            }
#pragma unroll
            for (int k = 0; k < cdiv(kQ, 4); ++k) {
              const int q = sub + 4 * k;
              if (q < nq) {
                const float4 xv = xt[q];
#pragma unroll
                for (int u = 0; u < kSmallUnroll; ++u) {
                  if (row[u] == nullptr) continue;
                  const float4 mm = staged ? reinterpret_cast<const float4*>(row[u])[q]
                                           : load4<true>(row[u] + 4 * q, nx - 4 * q,
                                                         a.copy ? a.copy : 4);
                  acc[u] = fmaf(mm.x, xv.x, acc[u]);
                  acc[u] = fmaf(mm.y, xv.y, acc[u]);
                  acc[u] = fmaf(mm.z, xv.z, acc[u]);
                  acc[u] = fmaf(mm.w, xv.w, acc[u]);
                }
              }
            }
#pragma unroll
            for (int u = 0; u < kSmallUnroll; ++u) {
              float v = acc[u];
              v += __shfl_xor_sync(kFull, v, 1);
              v += __shfl_xor_sync(kFull, v, 2);
              if (sub == 0 && out[u] != nullptr) *out[u] = off[u] + v;
            }
          }
          if (t == 0 && a.rows)
            for (int jx = lane; jx < nx; jx += 32) a.lbds[b * L * nx + jx] = a.lbd0[b * nx + jx];
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + c);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// B. The pair at nx = 56
// ---------------------------------------------------------------------------

// Row stride of the pair's ring: a multiple of 4 floats (16-byte copies)
// with an odd number of 16-byte words, so 8 consecutive rows start in 8
// distinct groups of 4 banks.
__host__ __device__ constexpr int ring_ld(int nx) {
  return (r4(nx) / 4) % 2 ? r4(nx) : r4(nx) + 4;
}
// One ring slot: A_cl (nx rows of stride ld), then yff.
__host__ __device__ constexpr int ring_knot(int nx) { return nx * ring_ld(nx) + r4(nx); }
__host__ __device__ constexpr int chain_threads(int NX) { return 4 * NX; }

size_t chain_smem(int nx, int ring) {
  return ((size_t)ring * ring_knot(nx) + 2 * r4(nx)) * sizeof(float);
}

// Copies the rows × cols row-major block at src into shared memory at dst
// (row stride ld), asynchronously, W floats per copy (cols % W == 0).
template <int W>
__device__ __forceinline__ void copy_block(float* dst, int ld, const float* src, int rows,
                                           int cols) {
  const int per_row = cols / W;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row, c = (i - r * per_row) * W;
    async_copy<4 * W>(dst + r * ld + c, src + r * cols + c);
  }
}

// Issues the copies of one knot's A_cl and yff into a ring slot.
__device__ __forceinline__ void issue_knot(float* slot, int ld, const float* A, const float* y,
                                           int nx, int vec) {
  if (vec == 4) {
    copy_block<4>(slot, ld, A, nx, nx);
    copy_block<4>(slot + nx * ld, 0, y, 1, nx);
  } else if (vec == 2) {
    copy_block<2>(slot, ld, A, nx, nx);
    copy_block<2>(slot + nx * ld, 0, y, 1, nx);
  } else {
    copy_block<1>(slot, ld, A, nx, nx);
    copy_block<1>(slot + nx * ld, 0, y, 1, nx);
  }
}

// xs[b, t + 1] = yff[b, t] + Acl[b, t] xs[b, t] for t < L - 1; xs[b, 0] = x0[b].
template <int NX, int RING>
__global__ void __launch_bounds__(chain_threads(NX)) riccati_forward_chain_kernel(
    const float* __restrict__ Acl, const float* __restrict__ yff,
    const float* __restrict__ x0, float* __restrict__ xs, int L, int vec) {
  static_assert(RING >= 2, "the ring needs a slot in flight");
  constexpr int kRows = chain_threads(NX) / 4;  // rows of one pass
  constexpr int kPass = cdiv(NX, kRows);
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  constexpr int nx = NX;
  const int ld = ring_ld(nx), knot = ring_knot(nx), nxr = r4(nx);
  float* xbuf = ring + RING * knot;
  const size_t b = blockIdx.x;
  const float* A = Acl + b * L * nx * nx;
  const float* y = yff + b * L * nx;
  float* xo = xs + b * L * nx;

  for (int i = threadIdx.x; i < nx; i += blockDim.x) {
    const float v = x0[b * nx + i];
    xbuf[i] = v;
    xo[i] = v;
  }
  const int steps = L - 1;  // the terminal knot's A_cl and yff are not read
#pragma unroll
  for (int k = 0; k < RING - 1; ++k) {
    if (k < steps) issue_knot(ring + k * knot, ld, A + (size_t)k * nx * nx, y + (size_t)k * nx, nx, vec);
    async_commit();  // one group per knot, empty past the end
  }
  const int s = threadIdx.x & 3, row0 = threadIdx.x >> 2;
  for (int t = 0; t < steps; ++t) {
    // knot t's group is complete once at most RING - 2 younger ones are
    // pending; the barrier makes every thread's copies and x_t visible and
    // frees the slot that step t - 1 read
    async_wait<RING - 2>();
    __syncthreads();
    const int k = t + RING - 1;
    if (k < steps)
      issue_knot(ring + (k % RING) * knot, ld, A + (size_t)k * nx * nx, y + (size_t)k * nx, nx, vec);
    async_commit();

    const float* Ar = ring + (t % RING) * knot;
    const float* xc = xbuf + (t & 1) * nxr;
    float* xn = xbuf + ((t + 1) & 1) * nxr;
#pragma unroll
    for (int p = 0; p < kPass; ++p) {
      const int r = row0 + p * kRows;
      float a0 = 0.f, a1 = 0.f;
      if (r < nx) {
        const float* Arow = Ar + r * ld;
        constexpr int kQ = cdiv(NX, 8);
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const int j = s + 8 * q;
          if (j < nx) a0 = fmaf(Arow[j], xc[j], a0);
          if (j + 4 < nx) a1 = fmaf(Arow[j + 4], xc[j + 4], a1);
        }
      }
      float acc = a0 + a1;
      acc += __shfl_xor_sync(kFull, acc, 1);
      acc += __shfl_xor_sync(kFull, acc, 2);
      if (s == 0 && r < nx) {
        const float v = Ar[nx * ld + r] + acc;
        xn[r] = v;
        xo[(size_t)(t + 1) * nx + r] = v;
      }
    }
  }
  async_wait<0>();
}

// u, v, λ of knots [t0, t0 + kKnotsPerBlock) of problem blockIdx.y, from xs.
// A block's rows, in order: the K rows of its knots, then the Z rows, then
// the Vxx rows (each block of rows contiguous in memory).
template <int NX>
__global__ void __launch_bounds__(kRowThreads) riccati_forward_rows_kernel(
    const float* __restrict__ K, const float* __restrict__ Z, const float* __restrict__ Vxx,
    const float* __restrict__ kff, const float* __restrict__ zff, const float* __restrict__ vx,
    const float* __restrict__ lbd0, const float* __restrict__ xs, float* __restrict__ us,
    float* __restrict__ vs, float* __restrict__ lbds, int L, int nu, int nc, int vec) {
  constexpr int nx = NX;
  const int b = blockIdx.y, t0 = blockIdx.x * kKnotsPerBlock;
  const int nk = min(kKnotsPerBlock, L - t0);
  const int nrows = nk * (nu + nc + nx);
  const int group = threadIdx.x / kLanesPerRow, lane = threadIdx.x % kLanesPerRow;
  const size_t kt0 = (size_t)b * L + t0;

  // the same trip count for every group: a warp's shuffles need all lanes
  for (int base = 0; base < nrows; base += kGroups * kUnroll) {
    const float* row[kUnroll];
    const float* xr[kUnroll];
    float* out[kUnroll];
    float off[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      int v = base + group + u * kGroups;
      row[u] = nullptr;
      out[u] = nullptr;
      xr[u] = xs;
      off[u] = 0.f;
      if (v >= nrows) continue;
      const float* offp;
      size_t kt;
      if (v < nk * nu) {
        const int t = v / nu, i = v - t * nu;
        kt = kt0 + t;
        row[u] = K + (kt * nu + i) * nx;
        offp = kff + kt * nu + i;
        out[u] = us + kt * nu + i;
      } else if ((v -= nk * nu) < nk * nc) {
        const int t = v / nc, i = v - t * nc;
        kt = kt0 + t;
        row[u] = Z + (kt * nc + i) * nx;
        offp = zff + kt * nc + i;
        out[u] = vs + kt * nc + i;
      } else {
        v -= nk * nc;
        const int t = v / nx, i = v - t * nx;
        kt = kt0 + t;
        out[u] = lbds + kt * nx + i;
        if (t0 + t == 0) {  // λ₀ = lbd0: no product
          offp = lbd0 + (size_t)b * nx + i;
        } else {
          row[u] = Vxx + (kt * nx + i) * nx;
          offp = vx + kt * nx + i;
        }
      }
      xr[u] = xs + kt * nx;
      if (lane == 0) off[u] = __ldcs(offp);
    }
    float acc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc[u] = 0.f;
#pragma unroll
    for (int c = lane; c < cdiv(NX, 4); c += kLanesPerRow) {
      float4 m[kUnroll], x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool live = row[u] != nullptr;
        m[u] = live ? load4<true>(row[u] + 4 * c, nx - 4 * c, vec) : make_float4(0.f, 0.f, 0.f, 0.f);
        x[u] = live ? load4<false>(xr[u] + 4 * c, nx - 4 * c, vec) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        acc[u] = fmaf(m[u].x, x[u].x, acc[u]);
        acc[u] = fmaf(m[u].y, x[u].y, acc[u]);
        acc[u] = fmaf(m[u].z, x[u].z, acc[u]);
        acc[u] = fmaf(m[u].w, x[u].w, acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float a = acc[u];
#pragma unroll
      for (int o = kLanesPerRow / 2; o > 0; o >>= 1) a += __shfl_xor_sync(kFull, a, o);
      if (lane == 0 && out[u] != nullptr) *out[u] = off[u] + a;
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: the plan, shared memory, argument checks, launches
// ---------------------------------------------------------------------------

// Plan codes (fused_riccati.ForwardPlan.code): the pair at nx = 56, or a
// small class NXC (16, 32, 64, 112).
constexpr int kPair = 1;

// The least class that holds nx; -1 outside 1..112.
int class_of(int nx) {
  if (nx < 1 || nx > kMaxNx) return -1;
  return nx <= 16 ? 16 : nx <= 32 ? 32 : nx <= 64 ? 64 : 112;
}
// The batch does not change it: at nx = 56 the pair was measured faster at
// every batch from 1 to 256 (chip_smoke.py's `k2 small:` lines).
int plan_code(int nx, int) { return nx == kBenchNx ? kPair : class_of(nx); }

bool aligned(const void* p, int vec) {
  return reinterpret_cast<std::uintptr_t>(p) % (sizeof(float) * vec) == 0;
}

bool valid_vec(int nx, int vec) { return (vec == 1 || vec == 2 || vec == 4) && nx % vec == 0; }

// The ring of the small kernel: m knots a chunk, C chunks, and whether K, Z
// and Vxx go through it. S = C·m knots, as many as fit the block's shared
// memory (with K, Z and Vxx where two knots of them fit), the whole horizon
// at most; a chunk a sixteenth of the ring, from 1 to 4 knots (so that the
// rows warps share many chunks and the last one's rows end soon); two chunks at least unless one holds
// the horizon. One block to an SM up to `sms`
// problems, else two.
struct Ring {
  int chunk = 0, chunks = 0, staged = 0;
  size_t smem = 0;
};
Ring small_ring(int nx, int nu, int nc, int L, int batch, int sms) {
  const size_t budget = batch > sms ? kTwoBlockSmem : kMaxSmem;
  Ring rg;
  for (int staged = 1; staged >= 0; --staged) {
    const Layout one(nx, nu, nc, 1, staged != 0);
    const size_t per = (size_t)one.size * 4 + 24;  // a knot, and at most three barriers
    const int fit = (int)((budget - 16) / per);
    if (fit < (L < 2 ? L : 2)) continue;
    const int S = fit < L ? fit : L;
    const int m = S / 16 < 1 ? 1 : S / 16 > 4 ? 4 : S / 16;
    int C = cdiv(L, m);
    if (C * m > fit) C = fit / m;
    if (C < 2 && C * m < L) continue;
    rg.chunk = m;
    rg.chunks = C;
    rg.staged = staged;
    rg.smem = ((size_t)bar_floats(C) + (size_t)Layout(nx, nu, nc, C * m, staged != 0).size) * 4;
    return rg;
  }
  return rg;
}

// A copy method the pointers and nx allow: 0 (bulk copies) and 4 need
// 16-byte alignment and nx % 4 == 0, 2 and 1 alignment and nx % 2 or 1.
bool copy_ok(int nx, int copy, std::initializer_list<const void*> ptrs) {
  const int vec = copy == 0 ? 4 : copy;
  if (!valid_vec(nx, vec)) return false;
  for (const void* p : ptrs)
    if (p != nullptr && !aligned(p, vec)) return false;
  return true;
}

const void* small_fn_of(int code) {
  switch (code) {
    case 16: return (const void*)&riccati_forward_small<16>;
    case 32: return (const void*)&riccati_forward_small<32>;
    case 64: return (const void*)&riccati_forward_small<64>;
    default: return (const void*)&riccati_forward_small<112>;
  }
}
int fn_index(int code) {
  switch (code) {
    case kPair: return 0;
    case 16: return 1;
    case 32: return 2;
    case 64: return 3;
    default: return 4;
  }
}
const void* fn_of(int code) {
  return code == kPair ? (const void*)&riccati_forward_chain_kernel<kBenchNx, kBenchRing>
                       : small_fn_of(code);
}

// Raises a kernel's dynamic shared-memory limit on the current device, once
// per device and only when `smem` is more than was set before.
cudaError_t ensure_smem_limit(int code, size_t smem) {
  static size_t smem_limit[5][kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  size_t& lim = smem_limit[fn_index(code)][dev];
  if (smem > lim) {
    err = cudaFuncSetAttribute(fn_of(code), cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    lim = smem;
  }
  return cudaSuccess;
}

int device_sms() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

}  // namespace

extern "C" {

// The plan's code for state width nx and `batch` problems: 1 for the pair
// (nx = 56), else the small class NXC (16, 32, 64, 112); -1 for nx outside
// 1..112.
int riccati_forward_plan(int nx, int batch) { return plan_code(nx, batch); }

// The small kernel's ring at these dims on the current card: 100 × its
// chunks + its knots a chunk, negative when K, Z and Vxx do not go through
// it; 0 if no two knots fit.
int riccati_forward_small_stages(int nx, int nu, int nc, int L, int batch) {
  const Ring rg = small_ring(nx, nu, nc, L, batch, device_sms());
  const int code = 100 * rg.chunks + rg.chunk;
  return rg.staged ? code : -code;
}

// Bytes of dynamic shared memory one block of the plan's kernel takes.
long long riccati_forward_smem_bytes(int nx, int nu, int nc, int L, int batch) {
  const int code = plan_code(nx, batch);
  if (code == kPair) return (long long)chain_smem(nx, kBenchRing);
  return (long long)small_ring(nx, nu, nc, L, batch, device_sms()).smem;
}

// Blocks of the plan's kernel (the pair's chain) that one SM of the current
// device holds at once; a cudaError as a negative number.
int riccati_forward_blocks_per_sm(int nx, int nu, int nc, int L, int batch) {
  const int code = plan_code(nx, batch);
  if (code < 0) return -(int)cudaErrorInvalidValue;
  const size_t smem = (size_t)riccati_forward_smem_bytes(nx, nu, nc, L, batch);
  cudaError_t err = ensure_smem_limit(code, smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fn_of(code), code == kPair ? chain_threads(kBenchNx) : small_threads(code),
      smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

// The small kernel: xs, us, vs, lbds in one launch. `plan` is the code of
// the class (0: the plan's own; kPair is refused here), `copy` the copy
// method (0: 1-D bulk copies; 4, 2, 1: cp.async of 16, 8 or 4 bytes), rows
// 0 for the chain alone. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernel does not take: a class
// that does not hold nx, a copy method the pointers or nx do not allow, or
// no two knots in shared memory.
int riccati_forward_small_f32(const void* Acl, const void* yff, const void* x0, const void* K,
                              const void* Z, const void* Vxx, const void* kff, const void* zff,
                              const void* vx, const void* lbd0, void* xs, void* us, void* vs,
                              void* lbds, int batch, int L, int nx, int nu, int nc, int plan,
                              int copy, int rows, void* stream) {
  const int code = plan ? plan : plan_code(nx, batch);
  const bool holds = code > 1 && code == class_of(nx);
  if (!holds || nu < 0 || nc < 0 || !copy_ok(nx, copy, {Acl, yff, K, Vxx, nc > 0 ? Z : nullptr}))
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || L == 0) return (int)cudaSuccess;
  const Ring rg = small_ring(nx, nu, nc, L, batch, device_sms());
  if (rg.chunks == 0) return (int)cudaErrorInvalidValue;
  const cudaError_t err = ensure_smem_limit(code, rg.smem);
  if (err != cudaSuccess) return (int)err;
  Fwd a{(const float*)Acl, (const float*)yff, (const float*)x0, (const float*)K,
        (const float*)Z, (const float*)Vxx, (const float*)kff, (const float*)zff,
        (const float*)vx, (const float*)lbd0, (float*)xs, (float*)us, (float*)vs,
        (float*)lbds, L, nx, nu, nc, rg.chunk, rg.chunks, rg.staged, copy, rows != 0};
  const auto s = (cudaStream_t)stream;
  switch (code) {
    case 16: riccati_forward_small<16><<<batch, small_threads(16), rg.smem, s>>>(a); break;
    case 32: riccati_forward_small<32><<<batch, small_threads(32), rg.smem, s>>>(a); break;
    case 64: riccati_forward_small<64><<<batch, small_threads(64), rg.smem, s>>>(a); break;
    default: riccati_forward_small<112><<<batch, small_threads(112), rg.smem, s>>>(a);
  }
  return (int)cudaGetLastError();
}

// The pair's chain at nx = 56: xs from x0, Acl and yff; vec the copy width in
// floats. Same return code as above.
int riccati_forward_chain_f32(const void* Acl, const void* yff, const void* x0, void* xs,
                              int batch, int L, int nx, int vec, void* stream) {
  if (nx != kBenchNx || !valid_vec(nx, vec) || !aligned(Acl, vec) || !aligned(yff, vec))
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || L == 0) return (int)cudaSuccess;
  const size_t smem = chain_smem(nx, kBenchRing);
  const cudaError_t err = ensure_smem_limit(kPair, smem);
  if (err != cudaSuccess) return (int)err;
  riccati_forward_chain_kernel<kBenchNx, kBenchRing>
      <<<batch, chain_threads(kBenchNx), smem, (cudaStream_t)stream>>>(
          (const float*)Acl, (const float*)yff, (const float*)x0, (float*)xs, L, vec);
  return (int)cudaGetLastError();
}

// The pair's rows at nx = 56: us, vs, lbds from the gains and xs (after the
// chain on the same stream).
int riccati_forward_rows_f32(const void* K, const void* Z, const void* Vxx, const void* kff,
                             const void* zff, const void* vx, const void* lbd0, const void* xs,
                             void* us, void* vs, void* lbds, int batch, int L, int nx, int nu,
                             int nc, int vec, void* stream) {
  if (nx != kBenchNx || !valid_vec(nx, vec) || !aligned(K, vec) || !aligned(Vxx, vec) ||
      !aligned(xs, vec) || (nc > 0 && !aligned(Z, vec)) || nu < 0 || nc < 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || L == 0) return (int)cudaSuccess;
  const dim3 grid(cdiv(L, kKnotsPerBlock), batch);
  auto in = [](const void* p) { return (const float*)p; };
  auto out = [](void* p) { return (float*)p; };
  riccati_forward_rows_kernel<kBenchNx><<<grid, kRowThreads, 0, (cudaStream_t)stream>>>(
      in(K), in(Z), in(Vxx), in(kff), in(zff), in(vx), in(lbd0), in(xs), out(us), out(vs),
      out(lbds), L, nu, nc, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
