// Layout probe: the building blocks of the backward Riccati kernel, each
// repeated `rep` times inside one launch, float32.
//
// Replaces: scripts/probe_mosaic.py, the six Pallas bodies that `_time_one`
// sends through its pl.pallas_call: k_batched_mm (two shapes), k_shared_mm,
// k_transpose, k_bcast_fma, k_slab_reduce and k_lanes_apply. Each kernel
// here computes what its body computes: the construct applied to
// (first operand + i) for i < rep, summed into zeros. The slope of the
// launch time over two repeat counts gives the cost of one construct.
//
// What bounds them on an H100: one launch reads its inputs once (0.1 to
// 1.4 MB, a fraction of a microsecond of HBM time); every further repeat
// works on operands that are already on the SM, so the marginal cost of a
// construct is bounded by arithmetic: the products by the tensor cores'
// TF32 rate taken three times (below), the other bodies by the float32
// pipe's issue rate, one add, multiply or FMA a lane a cycle.
//
// Design. Every operand is loaded once, before the repeat loop, into the
// registers of the thread that uses it; no repeat touches shared or device
// memory. Each repeat computes its whole construct on (operand + i): no
// work is hoisted out of the loop and nothing is folded across repeats.
// Built without fast math, so no sum is reassociated. The tile, strip and
// block sizes below were measured on the H100 against their neighbours
// (probes/layout_variants.py).
//
// * Products (k_batched_mm, k_shared_mm) run on the tensor cores by warp-
//   level mma.sync m16n8k8 in TF32, error-compensated to float32 accuracy
//   (3×TF32): x = hi + lo, both TF32; a·b ≈ hi·hi′ + hi·lo′ + lo·hi′ in
//   three independent accumulators, summed in float32 at the end of each
//   repeat (one pass of TF32 keeps ~3 decimal digits and misses the
//   probe's 1e-5 gate). b is split once a launch, (a + i) in every repeat.
//   A warp owns one 16 × 8 output tile of one problem, or two side by side
//   where the tiles outnumber the card's sub-cores; rows pad to 16, columns
//   to 8, depth to 8 with zeros in b. The warps of all problems spread over
//   the card (P1a 256, P1b 320, P1c 480). An m16n8k8 TF32 product issues
//   every ~6 cycles on a sub-core and takes ~25 to complete
//   (probes/mma_rate.py), so the bodies are bound by the tensor cores of
//   the busiest sub-cores and by each warp's chain of k-steps.
//   k_shared_mm is the same kernel with one b for every row tile.
// * k_transpose: a thread owns kTrEl outputs, read through the index map
//   at the load; each repeat adds (x + i) into each, in one loop.
// * k_bcast_fma: a thread owns one (r, t) and kBcStrip columns c: (a + i)
//   once a repeat, then one FMA per element.
// * k_slab_reduce: kSrLanes lanes of a warp share one output, each summing
//   its rows; a shuffle tree joins the partial sums every repeat, so an
//   output's chain is a few adds long and the grid fills the card.
// * k_lanes_apply: a thread owns one (j, t) and kLaStrip columns c, with
//   B's strip in registers: (L + i)[j, :, t] once a repeat, then R FMAs
//   per output.

#include <cuda_runtime.h>

namespace {

constexpr int kMmWarps = 2;       // warps per block of the product kernel
constexpr int kMmMaxSteps = 8;    // depth of a product: at most 8 steps of 8
constexpr int kTrEl = 2;          // transpose: outputs per thread
constexpr int kTrThreads = 64;    // transpose: threads per block
constexpr int kBcStrip = 12;      // bcast_fma: columns per thread
constexpr int kBcThreads = 128;
constexpr int kSrLanes = 4;       // slab_reduce: lanes per output
constexpr int kSrThreads = 256;
constexpr int kLaStrip = 6;       // lanes_apply: columns per thread
constexpr int kLaThreads = 128;
constexpr int kLanesR = 24;       // R of k_lanes_apply (probe_mosaic.py:106)

// d += a·b on the tensor cores for one 16 × 8 × 8 tile, TF32 inputs and a
// float32 sum. Fragments as the PTX ISA lays out m16n8k8 .tf32, with
// g = lane / 4, q = lane % 4: a = A[g][q], A[g+8][q], A[g][q+4],
// A[g+8][q+4]; b = B[q][g], B[q+4][g]; d = D[g][2q], D[g][2q+1],
// D[g+8][2q], D[g+8][2q+1].
__device__ __forceinline__ void mma_tf32_m16n8k8(float (&d)[4], const float (&a)[4],
                                                 const float (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
        "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])),
        "r"(__float_as_uint(b[0])), "r"(__float_as_uint(b[1])));
}

// x truncated to TF32 (10 mantissa bits): its low 13 bits cleared.
__device__ __forceinline__ float trunc_tf32(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

// x = hi + lo + O(2⁻²⁰·|x|), both TF32: hi = x truncated, lo = x − hi
// (exact) truncated. Rounding the halves to nearest (cvt.rna.tf32.f32)
// halves the error but costs six instructions an element to these two
// (ptxas emulates cvt.rna on sm_90), measured slower on the H100.
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = trunc_tf32(x);
  lo = trunc_tf32(x - hi);
}

// out[p] = Σ_i (a[p] + i) @ b[p] for a (nb, m, k), b (nb, k, n) read at
// b + p·b_stride (0: one b for every problem), k ≤ 8·KS. A warp owns NW
// 16 × 8 tiles side by side, one row tile of problem p, so the split of
// (a + i) serves NW tiles; tiles past the last problem return as a whole
// warp.
template <int KS, int NW>
__global__ void __launch_bounds__(kMmWarps * 32) mm_tf32x3_kernel(
    const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out,
    int nb, int m, int k, int n, long long b_stride, int rep) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int mt = (m + 15) / 16, ng = (n + 8 * NW - 1) / (8 * NW);
  const int warp = blockIdx.x * kMmWarps + threadIdx.x / 32;
  if (warp >= nb * mt * ng) return;
  const int p = warp / (mt * ng), r0 = (warp % (mt * ng)) / ng * 16;
  const int c0 = warp % ng * 8 * NW;
  const float* ap = a + (size_t)p * m * k;
  const float* bp = b + p * b_stride;
  float af[KS][4], bh[NW][KS][2], bl[NW][KS][2];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + 8 * (e & 1), kk = 8 * s + q + 4 * (e >> 1);
      af[s][e] = (r < m && kk < k) ? ap[(size_t)r * k + kk] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < NW; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kk = 8 * s + q + 4 * e, c = c0 + 8 * j + g;
        split_tf32((kk < k && c < n) ? bp[(size_t)kk * n + c] : 0.f, bh[j][s][e], bl[j][s][e]);
      }
    }
  }
  // Two repeats a turn of the loop for one tile a warp: its three chains of
  // KS products are short, and the next repeat's split fills their latency;
  // one for two tiles, whose six chains keep the tensor core busy
  // (unrolled, measured slower).
  constexpr int kUnroll = NW == 1 ? 2 : 1;
  float acc[NW][4] = {};
#pragma unroll kUnroll
  for (int i = 0; i < rep; ++i) {
    const float off = (float)i;
    float hh[NW][4] = {}, hl[NW][4] = {}, lh[NW][4] = {};
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      float ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(af[s][e] + off, ah[e], al[e]);
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        mma_tf32_m16n8k8(hh[j], ah, bh[j][s]);
        mma_tf32_m16n8k8(hl[j], ah, bl[j][s]);
        mma_tf32_m16n8k8(lh[j], al, bh[j][s]);
      }
    }
#pragma unroll
    for (int j = 0; j < NW; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += hh[j][e] + (hl[j][e] + lh[j][e]);
    }
  }
  float* op = out + (size_t)p * m * n;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + 8 * (e >> 1), c = c0 + 8 * j + 2 * q + (e & 1);
      if (r < m && c < n) op[(size_t)r * n + c] = acc[j][e];
    }
  }
}

// out[r, c, t] = Σ_i (x[t, r, c] + i): x (tb, R, C) to out (R, C, tb).
// Thread j's outputs are j + e·stride in out's order (e < kTrEl), read
// through the transpose's index map once.
__global__ void __launch_bounds__(kTrThreads) transpose_kernel(
    const float* __restrict__ x, float* __restrict__ out, int tb, int nr, int nc, int rep) {
  const int total = tb * nr * nc, stride = gridDim.x * blockDim.x;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  float v[kTrEl], acc[kTrEl];
#pragma unroll
  for (int e = 0; e < kTrEl; ++e) {
    const int o = j + e * stride, t = o % tb, rc = o / tb;
    v[e] = o < total ? x[((size_t)t * nr + rc / nc) * nc + rc % nc] : 0.f;
    acc[e] = 0.f;
  }
  for (int i = 0; i < rep; ++i) {
    const float off = (float)i;
#pragma unroll
    for (int e = 0; e < kTrEl; ++e) acc[e] += v[e] + off;
  }
#pragma unroll
  for (int e = 0; e < kTrEl; ++e) {
    const int o = j + e * stride;
    if (o < total) out[o] = acc[e];
  }
}

// out[r, c, t] = Σ_i (a[r, t] + i) · b[r, c, t]: a (R, tb), b (R, C, tb).
// Thread: t fastest, then its strip of kBcStrip columns, then r.
__global__ void __launch_bounds__(kBcThreads) bcast_fma_kernel(
    const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out,
    int nr, int nc, int tb, int rep) {
  const int strips = (nc + kBcStrip - 1) / kBcStrip;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= nr * strips * tb) return;
  const int t = j % tb, c0 = (j / tb) % strips * kBcStrip, r = j / (tb * strips);
  const float av = a[(size_t)r * tb + t];
  float bv[kBcStrip], acc[kBcStrip];
#pragma unroll
  for (int e = 0; e < kBcStrip; ++e) {
    bv[e] = c0 + e < nc ? b[((size_t)r * nc + c0 + e) * tb + t] : 0.f;
    acc[e] = 0.f;
  }
  for (int i = 0; i < rep; ++i) {
    const float ai = av + (float)i;
#pragma unroll
    for (int e = 0; e < kBcStrip; ++e) acc[e] = fmaf(ai, bv[e], acc[e]);
  }
#pragma unroll
  for (int e = 0; e < kBcStrip; ++e) {
    if (c0 + e < nc) out[((size_t)r * nc + c0 + e) * tb + t] = acc[e];
  }
}

// out[c, t] = Σ_i Σ_r (b[r, c, t] + i): b (R, C, tb) to out (C, tb),
// R ≤ kSrLanes·RL. Lane p·(32/kSrLanes) + o of a warp holds rows
// r ≡ p (mod kSrLanes) of the warp's output o; every lane takes part in
// the shuffles, those past the last output with zeros.
template <int RL>
__global__ void __launch_bounds__(kSrThreads) slab_reduce_kernel(
    const float* __restrict__ b, float* __restrict__ out, int nr, int nc, int tb, int rep) {
  constexpr int kOuts = 32 / kSrLanes;  // outputs per warp
  const int plane = nc * tb, lane = threadIdx.x & 31, p = lane / kOuts;
  const int o = (blockIdx.x * blockDim.x + threadIdx.x) / 32 * kOuts + lane % kOuts;
  const int rows = p < nr ? (nr - 1 - p) / kSrLanes + 1 : 0;  // this lane's rows
  float v[RL];
#pragma unroll
  for (int e = 0; e < RL; ++e) {
    v[e] = (o < plane && e < rows) ? b[(size_t)(p + e * kSrLanes) * plane + o] : 0.f;
  }
  float acc = 0.f;
  for (int i = 0; i < rep; ++i) {
    const float off = (float)i;
    float s = rows > 0 ? v[0] + off : 0.f;
#pragma unroll
    for (int e = 1; e < RL; ++e) {
      if (e < rows) s += v[e] + off;
    }
#pragma unroll
    for (int w = kOuts; w < 32; w *= 2) s += __shfl_xor_sync(0xffffffffu, s, w);
    acc += s;
  }
  if (p == 0 && o < plane) out[o] = acc;
}

// out[j, c, t] = Σ_i Σ_k (L[j, k, t] + i) · B[k, c, t]: L (24, 24, tb),
// B (24, C, tb). Thread: t fastest, then its strip of kLaStrip columns,
// then j; L's row and B's strip stay in registers across the repeats.
__global__ void __launch_bounds__(kLaThreads) lanes_apply_kernel(
    const float* __restrict__ L, const float* __restrict__ B, float* __restrict__ out,
    int nc, int tb, int rep) {
  const int strips = (nc + kLaStrip - 1) / kLaStrip;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= kLanesR * strips * tb) return;
  const int t = idx % tb, c0 = (idx / tb) % strips * kLaStrip, j = idx / (tb * strips);
  float l[kLanesR], bb[kLanesR][kLaStrip], acc[kLaStrip];
#pragma unroll
  for (int kk = 0; kk < kLanesR; ++kk) {
    l[kk] = L[((size_t)j * kLanesR + kk) * tb + t];
#pragma unroll
    for (int e = 0; e < kLaStrip; ++e) {
      bb[kk][e] = c0 + e < nc ? B[((size_t)kk * nc + c0 + e) * tb + t] : 0.f;
    }
  }
#pragma unroll
  for (int e = 0; e < kLaStrip; ++e) acc[e] = 0.f;
  for (int i = 0; i < rep; ++i) {
    const float off = (float)i;
    float li[kLanesR], d[kLaStrip];
#pragma unroll
    for (int kk = 0; kk < kLanesR; ++kk) li[kk] = l[kk] + off;
#pragma unroll
    for (int e = 0; e < kLaStrip; ++e) {
      d[e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kLanesR; ++kk) d[e] = fmaf(li[kk], bb[kk][e], d[e]);
      acc[e] += d[e];
    }
  }
#pragma unroll
  for (int e = 0; e < kLaStrip; ++e) {
    if (c0 + e < nc) out[((size_t)j * nc + c0 + e) * tb + t] = acc[e];
  }
}

unsigned blocks_for(size_t total, int threads) {
  return (unsigned)((total + threads - 1) / threads);
}

template <int NW>
int launch_mm(const float* a, const float* b, float* out, int nb, int m, int k, int n,
              long long b_stride, int rep, cudaStream_t stream) {
  const size_t warps = (size_t)nb * ((m + 15) / 16) * ((n + 8 * NW - 1) / (8 * NW));
  const unsigned grid = blocks_for(warps, kMmWarps);
  const int nt = kMmWarps * 32;
  switch ((k + 7) / 8) {
    case 1: mm_tf32x3_kernel<1, NW><<<grid, nt, 0, stream>>>(a, b, out, nb, m, k, n, b_stride, rep); break;
    case 2: mm_tf32x3_kernel<2, NW><<<grid, nt, 0, stream>>>(a, b, out, nb, m, k, n, b_stride, rep); break;
    case 3: mm_tf32x3_kernel<3, NW><<<grid, nt, 0, stream>>>(a, b, out, nb, m, k, n, b_stride, rep); break;
    case 4: mm_tf32x3_kernel<4, NW><<<grid, nt, 0, stream>>>(a, b, out, nb, m, k, n, b_stride, rep); break;
    case 5: mm_tf32x3_kernel<5, NW><<<grid, nt, 0, stream>>>(a, b, out, nb, m, k, n, b_stride, rep); break;
    case 6: mm_tf32x3_kernel<6, NW><<<grid, nt, 0, stream>>>(a, b, out, nb, m, k, n, b_stride, rep); break;
    case 7: mm_tf32x3_kernel<7, NW><<<grid, nt, 0, stream>>>(a, b, out, nb, m, k, n, b_stride, rep); break;
    default: mm_tf32x3_kernel<8, NW><<<grid, nt, 0, stream>>>(a, b, out, nb, m, k, n, b_stride, rep); break;
  }
  return (int)cudaGetLastError();
}

// One 16 × 8 tile a warp while that leaves every sub-core (four an SM) at
// most one warp; past that two tiles a warp, so that (a + i)'s split serves
// both and the products keep more of each sub-core's tensor core busy.
int launch_products(const float* a, const float* b, float* out, int nb, int m, int k, int n,
                    long long b_stride, int rep, cudaStream_t stream) {
  if (k < 1 || k > 8 * kMmMaxSteps) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t tiles = (size_t)nb * ((m + 15) / 16) * ((n + 7) / 8);
  return tiles <= 4 * (size_t)sms
             ? launch_mm<1>(a, b, out, nb, m, k, n, b_stride, rep, stream)
             : launch_mm<2>(a, b, out, nb, m, k, n, b_stride, rep, stream);
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError();
// pointers are contiguous float32 device arrays, the output last.
extern "C" {

int probe_batched_mm_f32(const void* a, const void* b, void* out, int nb,
                         int m, int k, int n, int rep, void* stream) {
  return launch_products((const float*)a, (const float*)b, (float*)out, nb, m, k, n,
                         (long long)k * n, rep, (cudaStream_t)stream);
}

int probe_shared_mm_f32(const void* a, const void* b, void* out, int m,
                        int k, int n, int rep, void* stream) {
  return launch_products((const float*)a, (const float*)b, (float*)out, 1, m, k, n, 0, rep,
                         (cudaStream_t)stream);
}

int probe_transpose_f32(const void* x, void* out, int tb, int nr, int nc,
                        int rep, void* stream) {
  const unsigned grid = blocks_for(blocks_for((size_t)tb * nr * nc, kTrEl), kTrThreads);
  transpose_kernel<<<grid, kTrThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, tb, nr, nc, rep);
  return (int)cudaGetLastError();
}

int probe_bcast_fma_f32(const void* a, const void* b, void* out, int nr,
                        int nc, int tb, int rep, void* stream) {
  const unsigned grid =
      blocks_for((size_t)nr * ((nc + kBcStrip - 1) / kBcStrip) * tb, kBcThreads);
  bcast_fma_kernel<<<grid, kBcThreads, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)out, nr, nc, tb, rep);
  return (int)cudaGetLastError();
}

int probe_slab_reduce_f32(const void* b, void* out, int nr, int nc, int tb,
                          int rep, void* stream) {
  const unsigned grid = blocks_for((size_t)nc * tb * kSrLanes, kSrThreads);
  const int rl = (nr + kSrLanes - 1) / kSrLanes;  // rows per lane
  const float* bp = (const float*)b;
  float* op = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (rl <= 2) {
    slab_reduce_kernel<2><<<grid, kSrThreads, 0, st>>>(bp, op, nr, nc, tb, rep);
  } else if (rl <= 4) {
    slab_reduce_kernel<4><<<grid, kSrThreads, 0, st>>>(bp, op, nr, nc, tb, rep);
  } else if (rl <= 6) {
    slab_reduce_kernel<6><<<grid, kSrThreads, 0, st>>>(bp, op, nr, nc, tb, rep);
  } else if (rl <= 12) {
    slab_reduce_kernel<12><<<grid, kSrThreads, 0, st>>>(bp, op, nr, nc, tb, rep);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int probe_lanes_apply_f32(const void* L, const void* B, void* out, int nc,
                          int tb, int rep, void* stream) {
  const unsigned grid =
      blocks_for((size_t)kLanesR * ((nc + kLaStrip - 1) / kLaStrip) * tb, kLaThreads);
  lanes_apply_kernel<<<grid, kLaThreads, 0, (cudaStream_t)stream>>>(
      (const float*)L, (const float*)B, (float*)out, nc, tb, rep);
  return (int)cudaGetLastError();
}

}  // extern "C"
