// Fused closed-loop forward rollout of the proximal Riccati recursion for
// a batch of problems, float32, in two kernels launched one after the other
// on the caller's stream.
//
// Replaces: aligator_tpu/gar/pallas_riccati.py `_forward_kernel`
// (launched by `forward_sweep_batched`). For t = 0..N:
//   u = kff + K x,  v = zff + Z x,  λ = vx + Vxx x (λ₀ = lbd0),
//   x⁺ = yff + A_cl x.
//
// What bounds it on an H100: every gain is read once (~36 KB per knot at
// nx = 56, nu = nc = 22; 0.94 GB at B = 256, N = 100) for 2 FLOP per 4 B,
// so the function is bound by HBM bandwidth (0.279 ms at 3.35 TB/s). Only
// x⁺ = yff + A_cl x is a chain over t. u, v and λ at knot t need x_t alone
// and feed nothing later, and no gain depends on x.
//
// Design:
// 1. The chain kernel computes xs alone, one block per problem. A_cl,t and
//    yff_t stream through a ring of RING knots in shared memory, filled by
//    cp.async: the copies of knot t + RING - 1 are issued right after the
//    barrier that opens step t, so RING - 1 knots are in flight while a
//    step computes. Four threads share a row of A_cl: thread s sums columns
//    s, s + 4, ... from the ring and x, two shuffles finish the row. The
//    ring's row stride ld is 4 (mod 8) floats, so the 8 rows × 4 threads of
//    a warp read 32 distinct banks. x is double-buffered: one barrier per
//    step. Shared memory per block: RING·(nx·ld + r4(nx)) + 2·r4(nx)
//    floats. nx = 56: RING = 6, ld = 60, 82,432 B and 224 threads, so two
//    blocks fit on an SM (228 KB) and B = 256 is one wave on 132 SMs.
//    Widths read at launch: RING = 4, 256 threads, nx <= 112 (at most
//    210,560 B).
// 2. The rows kernel computes u, v and λ of every knot after the chain, on
//    the same stream, over a grid of (chunk of kKnotsPerBlock knots,
//    problem) that fills the card at B = 64 as at B = 256. Sixteen lanes
//    share a row of [K; Z; Vxx]: each loads 4 consecutive floats of the row
//    and of x_t (read back from xs, which stays in L2), and every thread
//    has the loads of kUnroll rows in flight before it reduces them. Gains
//    are read with evict-first loads: each byte is used once.
// 3. Copy width. Both kernels copy and load 16 B at a time where nx % 4 == 0
//    and every matrix pointer is 16-byte aligned, else 8 B or 4 B. The
//    caller picks the width from the pointers and nx
//    (`fused_riccati.forward_variant`) and passes it as a run-time argument;
//    the entry points refuse a width the pointers do not allow.
// 4. Two instantiations of each kernel: nx = 56 compiled in (the bench and
//    talos widths; nu and nc only count rows, so they are read at launch in
//    both) and nx read at launch.
// No tensor cores: the products are full float32.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRt = -1;           // template width taken from the launch
constexpr int kBenchNx = 56;      // lqr56 and the talos walk
constexpr int kBenchRing = 6;     // ring depth, nx = 56
constexpr int kRtRing = 4;        // ring depth, widths read at launch
constexpr int kRtMaxNx = 112;     // the ring of 4 knots fits 227 KB
constexpr int kChainThreads = 256;
constexpr int kRowThreads = 256;
constexpr int kLanesPerRow = 16;
constexpr int kGroups = kRowThreads / kLanesPerRow;
constexpr int kUnroll = 4;
constexpr int kKnotsPerBlock = 4;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int r4(int n) { return (n + 3) & ~3; }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
// Row stride of the ring: a multiple of 4 floats (16-byte copies) with an
// odd number of 16-byte words, so 8 consecutive rows start in 8 distinct
// groups of 4 banks.
__host__ __device__ constexpr int ring_ld(int nx) {
  return (r4(nx) / 4) % 2 ? r4(nx) : r4(nx) + 4;
}
// One ring slot: A_cl (nx rows of stride ld), then yff.
__host__ __device__ constexpr int ring_knot(int nx) { return nx * ring_ld(nx) + r4(nx); }
__host__ __device__ constexpr int chain_threads(int NX) { return NX > 0 ? 4 * NX : kChainThreads; }

size_t chain_smem(int nx, int ring) {
  return ((size_t)ring * ring_knot(nx) + 2 * r4(nx)) * sizeof(float);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(BYTES)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies the rows × cols row-major block at src into shared memory at dst
// (row stride ld), asynchronously, W floats per copy (cols % W == 0).
template <int W>
__device__ __forceinline__ void copy_rows(float* dst, int ld, const float* src, int rows,
                                          int cols) {
  const int per_row = cols / W;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row, c = (i - r * per_row) * W;
    cp_async<4 * W>(dst + r * ld + c, src + r * cols + c);
  }
}

// Issues the copies of one knot's A_cl and yff into a ring slot.
__device__ __forceinline__ void issue_knot(float* slot, int ld, const float* A, const float* y,
                                           int nx, int vec) {
  if (vec == 4) {
    copy_rows<4>(slot, ld, A, nx, nx);
    copy_rows<4>(slot + nx * ld, 0, y, 1, nx);
  } else if (vec == 2) {
    copy_rows<2>(slot, ld, A, nx, nx);
    copy_rows<2>(slot + nx * ld, 0, y, 1, nx);
  } else {
    copy_rows<1>(slot, ld, A, nx, nx);
    copy_rows<1>(slot + nx * ld, 0, y, 1, nx);
  }
}

// xs[b, t + 1] = yff[b, t] + Acl[b, t] xs[b, t] for t < L - 1; xs[b, 0] = x0[b].
template <int NX, int RING>
__global__ void __launch_bounds__(chain_threads(NX)) riccati_forward_chain_kernel(
    const float* __restrict__ Acl, const float* __restrict__ yff,
    const float* __restrict__ x0, float* __restrict__ xs, int L, int nx_rt, int vec) {
  static_assert(RING >= 2, "the ring needs a slot in flight");
  constexpr int kRows = chain_threads(NX) / 4;  // rows of one pass
  constexpr int kPass = NX > 0 ? cdiv(NX, kRows) : cdiv(kRtMaxNx, kRows);
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  const int nx = NX > 0 ? NX : nx_rt;
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
    cp_async_commit();  // one group per knot, empty past the end
  }
  const int s = threadIdx.x & 3, row0 = threadIdx.x >> 2;
  for (int t = 0; t < steps; ++t) {
    // knot t's group is complete once at most RING - 2 younger ones are
    // pending; the barrier makes every thread's copies and x_t visible and
    // frees the slot that step t - 1 read
    cp_async_wait<RING - 2>();
    __syncthreads();
    const int k = t + RING - 1;
    if (k < steps)
      issue_knot(ring + (k % RING) * knot, ld, A + (size_t)k * nx * nx, y + (size_t)k * nx, nx, vec);
    cp_async_commit();

    const float* Ar = ring + (t % RING) * knot;
    const float* xc = xbuf + (t & 1) * nxr;
    float* xn = xbuf + ((t + 1) & 1) * nxr;
#pragma unroll
    for (int p = 0; p < kPass; ++p) {
      const int r = row0 + p * kRows;
      float a0 = 0.f, a1 = 0.f;
      if (r < nx) {
        const float* Arow = Ar + r * ld;
        constexpr int kQ = cdiv(NX > 0 ? NX : kRtMaxNx, 8);
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
  cp_async_wait<0>();
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

// u, v, λ of knots [t0, t0 + kKnotsPerBlock) of problem blockIdx.y, from xs.
// A block's rows, in order: the K rows of its knots, then the Z rows, then
// the Vxx rows (each block of rows contiguous in memory).
template <int NX>
__global__ void __launch_bounds__(kRowThreads) riccati_forward_rows_kernel(
    const float* __restrict__ K, const float* __restrict__ Z, const float* __restrict__ Vxx,
    const float* __restrict__ kff, const float* __restrict__ zff, const float* __restrict__ vx,
    const float* __restrict__ lbd0, const float* __restrict__ xs, float* __restrict__ us,
    float* __restrict__ vs, float* __restrict__ lbds, int L, int nx_rt, int nu, int nc, int vec) {
  const int nx = NX > 0 ? NX : nx_rt;
  const int b = blockIdx.y, t0 = blockIdx.x * kKnotsPerBlock;
  const int nk = min(kKnotsPerBlock, L - t0);
  const int nrows = nk * (nu + nc + nx);
  const int group = threadIdx.x / kLanesPerRow, lane = threadIdx.x % kLanesPerRow;
  const int nchunk = cdiv(nx, 4);
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
    for (int c = lane; c < (NX > 0 ? cdiv(NX, 4) : nchunk); c += kLanesPerRow) {
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

// Host side: instantiations, shared-memory limit, argument checks, launches.

bool valid(int nx, int variant, int vec) {
  if (vec != 1 && vec != 2 && vec != 4) return false;
  if (nx % vec != 0) return false;
  return variant == 1 ? nx == kBenchNx : (variant == 0 && nx >= 1 && nx <= kRtMaxNx);
}

bool aligned(const void* p, int vec) {
  return reinterpret_cast<std::uintptr_t>(p) % (sizeof(float) * vec) == 0;
}

const void* chain_fn(int variant) {
  return variant == 1 ? (const void*)&riccati_forward_chain_kernel<kBenchNx, kBenchRing>
                      : (const void*)&riccati_forward_chain_kernel<kRt, kRtRing>;
}

size_t chain_smem_bytes(int nx, int variant) {
  return chain_smem(nx, variant == 1 ? kBenchRing : kRtRing);
}

// Raises an instantiation's dynamic shared-memory limit on the current
// device, once per device and only when `smem` is more than was set before.
cudaError_t ensure_smem_limit(int variant, size_t smem) {
  static size_t smem_limit[2][kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  size_t& lim = smem_limit[variant == 1 ? 1 : 0][dev];
  if (smem > lim) {
    err = cudaFuncSetAttribute(chain_fn(variant), cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    lim = smem;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the chain kernel needs.
long long riccati_forward_chain_smem_bytes(int nx, int variant) {
  return (long long)chain_smem_bytes(nx, variant);
}

// Blocks of the chain kernel that one SM of the current device holds at
// once (cudaOccupancyMaxActiveBlocksPerMultiprocessor); a cudaError as a
// negative number.
int riccati_forward_chain_blocks_per_sm(int nx, int variant) {
  if (!valid(nx, variant, 1)) return -(int)cudaErrorInvalidValue;
  const size_t smem = chain_smem_bytes(nx, variant);
  cudaError_t err = ensure_smem_limit(variant, smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, chain_fn(variant), variant == 1 ? chain_threads(kBenchNx) : kChainThreads, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

// The chain: xs from x0, Acl and yff. variant 1 is the nx = 56
// instantiation, 0 the one that reads nx at launch; vec the copy width in
// floats. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// arguments the kernel does not take.
int riccati_forward_chain_f32(const void* Acl, const void* yff, const void* x0, void* xs,
                              int batch, int L, int nx, int variant, int vec, void* stream) {
  if (!valid(nx, variant, vec) || !aligned(Acl, vec) || !aligned(yff, vec))
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || L == 0) return (int)cudaSuccess;
  const size_t smem = chain_smem_bytes(nx, variant);
  const cudaError_t err = ensure_smem_limit(variant, smem);
  if (err != cudaSuccess) return (int)err;
  const auto s = (cudaStream_t)stream;
  if (variant == 1)
    riccati_forward_chain_kernel<kBenchNx, kBenchRing><<<batch, chain_threads(kBenchNx), smem, s>>>(
        (const float*)Acl, (const float*)yff, (const float*)x0, (float*)xs, L, nx, vec);
  else
    riccati_forward_chain_kernel<kRt, kRtRing><<<batch, kChainThreads, smem, s>>>(
        (const float*)Acl, (const float*)yff, (const float*)x0, (float*)xs, L, nx, vec);
  return (int)cudaGetLastError();
}

// The rows: us, vs, lbds from the gains and xs (after the chain on the
// same stream). Same variant, width and return code as the chain.
int riccati_forward_rows_f32(const void* K, const void* Z, const void* Vxx, const void* kff,
                             const void* zff, const void* vx, const void* lbd0, const void* xs,
                             void* us, void* vs, void* lbds, int batch, int L, int nx, int nu,
                             int nc, int variant, int vec, void* stream) {
  if (!valid(nx, variant, vec) || !aligned(K, vec) || !aligned(Vxx, vec) || !aligned(xs, vec) ||
      (nc > 0 && !aligned(Z, vec)) || nu < 0 || nc < 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || L == 0) return (int)cudaSuccess;
  const dim3 grid(cdiv(L, kKnotsPerBlock), batch);
  const auto s = (cudaStream_t)stream;
  auto in = [](const void* p) { return (const float*)p; };
  auto out = [](void* p) { return (float*)p; };
  if (variant == 1)
    riccati_forward_rows_kernel<kBenchNx><<<grid, kRowThreads, 0, s>>>(
        in(K), in(Z), in(Vxx), in(kff), in(zff), in(vx), in(lbd0), in(xs), out(us), out(vs),
        out(lbds), L, nx, nu, nc, vec);
  else
    riccati_forward_rows_kernel<kRt><<<grid, kRowThreads, 0, s>>>(
        in(K), in(Z), in(Vxx), in(kff), in(zff), in(vx), in(lbd0), in(xs), out(us), out(vs),
        out(lbds), L, nx, nu, nc, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
