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
// construct is bounded by the float32 FMA rate (no tensor cores).
//
// Design: the TPU body keeps whole operands in one VMEM block; here a
// (24, 57, 128) operand (700 KB) is more than one block's shared memory, so
// the grid splits the work over output rows, columns or lanes, and each
// thread loads its operands once (into registers or shared memory) before
// the repeat loop. The products are plain FMA loops over shared-memory
// tiles, one output element (or a column of four) per thread. Built
// without fast math, so the sums over the repeats are not reassociated.
// A transpose is an index map paid once at the load; its repeats are adds.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMmRows = 8;        // output rows per block of batched_mm
constexpr int kSmRows = 16;       // output rows per block of shared_mm
constexpr int kSmMicro = 4;       // rows of one shared_mm thread's column
constexpr int kSmThreads = 128;
constexpr int kTile = 32;         // transpose tile (kTile × kTile)
constexpr int kLanesR = 24;       // R of k_lanes_apply (probe_mosaic.py:106)
constexpr size_t kStaticSmemMax = 48 * 1024;

// out[b] = Σ_i (a[b] + i) @ bm[b] for a (nb, m, k), bm (nb, k, n).
// Grid (nb, ceil(m / kMmRows)); a block stages its rows of a and all of
// bm[b] in shared memory; one output element per thread.
__global__ void __launch_bounds__(kThreads) batched_mm_kernel(
    const float* __restrict__ a, const float* __restrict__ bm,
    float* __restrict__ out, int m, int k, int n, int rep) {
  extern __shared__ float smem[];
  const int r0 = blockIdx.y * kMmRows;
  const int rows = min(kMmRows, m - r0);
  float* sa = smem;                 // rows × k
  float* sb = smem + kMmRows * k;   // k × n
  const float* ab = a + ((size_t)blockIdx.x * m + r0) * k;
  const float* bb = bm + (size_t)blockIdx.x * k * n;
  for (int idx = threadIdx.x; idx < rows * k; idx += blockDim.x) sa[idx] = ab[idx];
  for (int idx = threadIdx.x; idx < k * n; idx += blockDim.x) sb[idx] = bb[idx];
  __syncthreads();
  float* ob = out + ((size_t)blockIdx.x * m + r0) * n;
  for (int idx = threadIdx.x; idx < rows * n; idx += blockDim.x) {
    const int r = idx / n, c = idx % n;
    float acc = 0.f;
    for (int i = 0; i < rep; ++i) {
      const float off = (float)i;
      float d = 0.f;
      for (int kk = 0; kk < k; ++kk) d = fmaf(sa[r * k + kk] + off, sb[kk * n + c], d);
      acc += d;
    }
    ob[idx] = acc;
  }
}

// out = Σ_i (a + i) @ bm for a (m, k) and one shared bm (k, n).
// Grid ceil(m / kSmRows); a block stages its rows of a and bm in shared
// memory; each thread computes a column of kSmMicro rows, so each element
// of bm it reads serves four products.
__global__ void __launch_bounds__(kSmThreads) shared_mm_kernel(
    const float* __restrict__ a, const float* __restrict__ bm,
    float* __restrict__ out, int m, int k, int n, int rep) {
  extern __shared__ float smem[];
  const int r0 = blockIdx.x * kSmRows;
  const int rows = min(kSmRows, m - r0);
  float* sa = smem;                 // kSmRows × k (rows past m are zero)
  float* sb = smem + kSmRows * k;   // k × n
  for (int idx = threadIdx.x; idx < kSmRows * k; idx += blockDim.x) {
    sa[idx] = (idx / k < rows) ? a[(size_t)r0 * k + idx] : 0.f;
  }
  for (int idx = threadIdx.x; idx < k * n; idx += blockDim.x) sb[idx] = bm[idx];
  __syncthreads();
  for (int task = threadIdx.x; task < (kSmRows / kSmMicro) * n; task += blockDim.x) {
    const int g = task / n, c = task % n;
    const float* arow = sa + g * kSmMicro * k;
    float acc[kSmMicro] = {};
    for (int i = 0; i < rep; ++i) {
      const float off = (float)i;
      float d[kSmMicro] = {};
      for (int kk = 0; kk < k; ++kk) {
        const float bv = sb[kk * n + c];
#pragma unroll
        for (int j = 0; j < kSmMicro; ++j) d[j] = fmaf(arow[j * k + kk] + off, bv, d[j]);
      }
#pragma unroll
      for (int j = 0; j < kSmMicro; ++j) acc[j] += d[j];
    }
#pragma unroll
    for (int j = 0; j < kSmMicro; ++j) {
      const int r = g * kSmMicro + j;
      if (r < rows) out[(size_t)(r0 + r) * n + c] = acc[j];
    }
  }
}

// out[r, c, t] = Σ_i (x[t, r, c] + i): x (tb, R, C) to out (R, C, tb).
// Grid (ceil(C / kTile), ceil(tb / kTile), R), block (kTile, 8): a tile
// is read along c and written along t through shared memory.
__global__ void transpose_kernel(const float* __restrict__ x,
                                 float* __restrict__ out, int tb, int nr,
                                 int nc, int rep) {
  __shared__ float tile[kTile][kTile + 1];
  const int r = blockIdx.z, c0 = blockIdx.x * kTile, t0 = blockIdx.y * kTile;
  for (int j = threadIdx.y; j < kTile; j += blockDim.y) {
    const int t = t0 + j, c = c0 + threadIdx.x;
    if (t < tb && c < nc) tile[j][threadIdx.x] = x[((size_t)t * nr + r) * nc + c];
  }
  __syncthreads();
  for (int j = threadIdx.y; j < kTile; j += blockDim.y) {
    const int c = c0 + j, t = t0 + threadIdx.x;
    if (t < tb && c < nc) {
      const float v = tile[threadIdx.x][j];
      float acc = 0.f;
      for (int i = 0; i < rep; ++i) acc += v + (float)i;
      out[((size_t)r * nc + c) * tb + t] = acc;
    }
  }
}

// out[r, c, t] = Σ_i (a[r, t] + i) · b[r, c, t]: a (R, tb), b (R, C, tb).
// One element per thread, lanes t fastest.
__global__ void __launch_bounds__(kThreads) bcast_fma_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    float* __restrict__ out, int nr, int nc, int tb, int rep) {
  const size_t total = (size_t)nr * nc * tb;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int t = (int)(idx % tb), r = (int)(idx / ((size_t)nc * tb));
  const float av = a[(size_t)r * tb + t], bv = b[idx];
  float acc = 0.f;
  for (int i = 0; i < rep; ++i) acc += (av + (float)i) * bv;
  out[idx] = acc;
}

// out[c, t] = Σ_i Σ_r (b[r, c, t] + i): b (R, C, tb) to out (C, tb).
// One (c, t) per thread; its R inputs are staged in shared memory once.
__global__ void __launch_bounds__(kThreads) slab_reduce_kernel(
    const float* __restrict__ b, float* __restrict__ out, int nr, int nc,
    int tb, int rep) {
  extern __shared__ float col[];  // nr × blockDim.x, a column per thread
  const size_t plane = (size_t)nc * tb;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= plane) return;
  for (int r = 0; r < nr; ++r) col[r * blockDim.x + threadIdx.x] = b[r * plane + idx];
  float acc = 0.f;
  for (int i = 0; i < rep; ++i) {
    const float off = (float)i;
    float s = 0.f;
    for (int r = 0; r < nr; ++r) s += col[r * blockDim.x + threadIdx.x] + off;
    acc += s;
  }
  out[idx] = acc;
}

// out[j, c, t] = Σ_i Σ_k (L[j, k, t] + i) · B[k, c, t]: L (24, 24, tb),
// B (24, C, tb), lanes t fastest. The 24 + 24 operands of one output stay
// in registers across the repeats.
__global__ void __launch_bounds__(kThreads) lanes_apply_kernel(
    const float* __restrict__ L, const float* __restrict__ B,
    float* __restrict__ out, int nc, int tb, int rep) {
  const size_t total = (size_t)kLanesR * nc * tb;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int t = (int)(idx % tb);
  const int c = (int)((idx / tb) % nc);
  const int j = (int)(idx / ((size_t)nc * tb));
  float l[kLanesR], bb[kLanesR];
#pragma unroll
  for (int kk = 0; kk < kLanesR; ++kk) {
    l[kk] = L[((size_t)j * kLanesR + kk) * tb + t];
    bb[kk] = B[((size_t)kk * nc + c) * tb + t];
  }
  float acc = 0.f;
  for (int i = 0; i < rep; ++i) {
    const float off = (float)i;
    float d = 0.f;
#pragma unroll
    for (int kk = 0; kk < kLanesR; ++kk) d = fmaf(l[kk] + off, bb[kk], d);
    acc += d;
  }
  out[idx] = acc;
}

unsigned blocks_for(size_t total, int threads) {
  return (unsigned)((total + threads - 1) / threads);
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError();
// pointers are contiguous float32 device arrays, the output last.
extern "C" {

int probe_batched_mm_f32(const void* a, const void* b, void* out, int nb,
                         int m, int k, int n, int rep, void* stream) {
  const size_t smem = (size_t)(kMmRows * k + k * n) * sizeof(float);
  if (smem > kStaticSmemMax) return (int)cudaErrorInvalidValue;
  const dim3 grid(nb, (m + kMmRows - 1) / kMmRows);
  batched_mm_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)out, m, k, n, rep);
  return (int)cudaGetLastError();
}

int probe_shared_mm_f32(const void* a, const void* b, void* out, int m,
                        int k, int n, int rep, void* stream) {
  const size_t smem = (size_t)(kSmRows * k + k * n) * sizeof(float);
  if (smem > kStaticSmemMax) return (int)cudaErrorInvalidValue;
  shared_mm_kernel<<<(m + kSmRows - 1) / kSmRows, kSmThreads, smem,
                     (cudaStream_t)stream>>>((const float*)a, (const float*)b,
                                             (float*)out, m, k, n, rep);
  return (int)cudaGetLastError();
}

int probe_transpose_f32(const void* x, void* out, int tb, int nr, int nc,
                        int rep, void* stream) {
  const dim3 grid((nc + kTile - 1) / kTile, (tb + kTile - 1) / kTile, nr);
  transpose_kernel<<<grid, dim3(kTile, 8), 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, tb, nr, nc, rep);
  return (int)cudaGetLastError();
}

int probe_bcast_fma_f32(const void* a, const void* b, void* out, int nr,
                        int nc, int tb, int rep, void* stream) {
  bcast_fma_kernel<<<blocks_for((size_t)nr * nc * tb, kThreads), kThreads, 0,
                     (cudaStream_t)stream>>>((const float*)a, (const float*)b,
                                             (float*)out, nr, nc, tb, rep);
  return (int)cudaGetLastError();
}

int probe_slab_reduce_f32(const void* b, void* out, int nr, int nc, int tb,
                          int rep, void* stream) {
  const size_t smem = (size_t)nr * kThreads * sizeof(float);
  if (smem > kStaticSmemMax) return (int)cudaErrorInvalidValue;
  slab_reduce_kernel<<<blocks_for((size_t)nc * tb, kThreads), kThreads, smem,
                       (cudaStream_t)stream>>>((const float*)b, (float*)out,
                                               nr, nc, tb, rep);
  return (int)cudaGetLastError();
}

int probe_lanes_apply_f32(const void* L, const void* B, void* out, int nc,
                          int tb, int rep, void* stream) {
  lanes_apply_kernel<<<blocks_for((size_t)kLanesR * nc * tb, kThreads),
                       kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)L, (const float*)B, (float*)out, nc, tb, rep);
  return (int)cudaGetLastError();
}

}  // extern "C"
