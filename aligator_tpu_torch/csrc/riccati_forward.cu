// Fused closed-loop forward rollout of the proximal Riccati recursion for
// a batch of problems, float32, one thread block per problem.
//
// Replaces: aligator_tpu/gar/pallas_riccati.py `_forward_kernel`
// (launched by `forward_sweep_batched`). For t = 0..N:
//   u = kff + K x,  v = zff + Z x,  λ = vx + Vxx x (λ₀ = lbd0),
//   x⁺ = yff + A_cl x.
//
// What bounds it on an H100: it reads every gain once (~36 KB per knot at
// nx = 56, nu = nc = 22) and does 2 FLOP per byte read, so it is bound by
// HBM bandwidth (3.35 TB/s). The chain over t is sequential per problem.
//
// Design: the state x lives in shared memory; each of the 8 warps takes
// whole rows of [K; Z; Vxx; A_cl], its 32 lanes read a row's consecutive
// floats (coalesced) and reduce with shuffles. One barrier per step.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ float row_dot(const float* __restrict__ row, const float* x, int n) {
  float acc = 0.f;
  for (int j = threadIdx.x % 32; j < n; j += 32) acc += row[j] * x[j];
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  return acc;  // valid in lane 0
}

__global__ void __launch_bounds__(kThreads) riccati_forward_kernel(
    const float* __restrict__ K, const float* __restrict__ Z,
    const float* __restrict__ Acl, const float* __restrict__ Vxx,
    const float* __restrict__ kff, const float* __restrict__ zff,
    const float* __restrict__ yff, const float* __restrict__ vx,
    const float* __restrict__ x0, const float* __restrict__ lbd0,
    float* __restrict__ xs, float* __restrict__ us, float* __restrict__ vs,
    float* __restrict__ lbds, int L, int nx, int nu, int nc) {
  extern __shared__ float smem[];
  float* x = smem;        // current state
  float* xn = smem + nx;  // next state
  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < nx; i += blockDim.x) x[i] = x0[(size_t)b * nx + i];
  __syncthreads();

  for (int t = 0; t < L; ++t) {
    const size_t kt = (size_t)b * L + t;
    for (int i = threadIdx.x; i < nx; i += blockDim.x) {
      xs[kt * nx + i] = x[i];
      if (t == 0) lbds[kt * nx + i] = lbd0[(size_t)b * nx + i];
    }
    // rows: [0, nu) controls, [nu, nu+nc) multipliers, then nx costate
    // rows (t > 0) and nx next-state rows (t < N)
    const int n_rows = nu + nc + 2 * nx;
    for (int row = warp; row < n_rows; row += kWarps) {
      if (row < nu) {
        const float s = row_dot(K + (kt * nu + row) * nx, x, nx);
        if (lane == 0) us[kt * nu + row] = kff[kt * nu + row] + s;
      } else if (row < nu + nc) {
        const int i = row - nu;
        const float s = row_dot(Z + (kt * nc + i) * nx, x, nx);
        if (lane == 0) vs[kt * nc + i] = zff[kt * nc + i] + s;
      } else if (row < nu + nc + nx) {
        if (t == 0) continue;
        const int i = row - nu - nc;
        const float s = row_dot(Vxx + (kt * nx + i) * nx, x, nx);
        if (lane == 0) lbds[kt * nx + i] = vx[kt * nx + i] + s;
      } else {
        if (t == L - 1) continue;
        const int i = row - nu - nc - nx;
        const float s = row_dot(Acl + (kt * nx + i) * nx, x, nx);
        if (lane == 0) xn[i] = yff[kt * nx + i] + s;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nx; i += blockDim.x) x[i] = xn[i];
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Launches one block per problem on `stream`; returns cudaGetLastError().
int riccati_forward_f32(const void* K, const void* Z, const void* Acl,
                        const void* Vxx, const void* kff, const void* zff,
                        const void* yff, const void* vx, const void* x0,
                        const void* lbd0, void* xs, void* us, void* vs,
                        void* lbds, int batch, int L, int nx, int nu, int nc,
                        void* stream) {
  const size_t smem = 2 * (size_t)nx * sizeof(float);
  riccati_forward_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)K, (const float*)Z, (const float*)Acl, (const float*)Vxx,
      (const float*)kff, (const float*)zff, (const float*)yff,
      (const float*)vx, (const float*)x0, (const float*)lbd0, (float*)xs,
      (float*)us, (float*)vs, (float*)lbds, L, nx, nu, nc);
  return (int)cudaGetLastError();
}

}  // extern "C"
