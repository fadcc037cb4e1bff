// Fused backward proximal Riccati sweep for a batch of constrained LQ
// problems, float32, one thread block per problem.
//
// Replaces: aligator_tpu/gar/pallas_riccati.py `_backward_kernel`
// (launched by `backward_sweep_batched`). Same function as
// aligator_tpu/gar/riccati.py `_stage_solve` / `_terminal_solve` over
// t = N..0 with nth = 0.
//
// What bounds it on an H100: at the bench widths (nx = 56, nu = nc = 22)
// a knot reads ~44 KB and writes ~36 KB and costs ~1.2 MFLOP, so the
// whole sweep is near the balance point of HBM (3.35 TB/s) and the
// float32 FMA rate (67 TFLOP/s). The time loop is sequential per problem,
// so the batch is the only parallel axis.
//
// Design: the grid's sequential TPU axis becomes a loop inside the block;
// the cost-to-go (V, v) stays in shared memory across steps, each knot is
// staged in shared memory, and every product, both Cholesky factors and
// the triangular solves run out of shared memory with a block-wide
// barrier between phases. No lane packing, batch cap or zero-row padding:
// nc = 0 is handled by skipping the Schur block. This is the simple,
// correct first version; tensor-core (`wgmma`) tiles, TMA staging and one
// warp per problem are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Dims {
  int nx, nu, nc, m;  // m = nx + 1 right-hand-side columns ([gain | ff])
};

// Shared-memory carve-up (floats), in the order of Layout::make.
struct Layout {
  float *V, *v, *Qh, *Sh, *Rh, *qh, *rh, *A, *Bm, *f, *C, *D, *d;
  float *AtV, *BtV, *vplus, *LR, *RiDt, *LS;
  float *b1, *b2, *k, *z, *t1, *t2;

  __host__ __device__ static size_t floats(const Dims& s) {
    const size_t nx = s.nx, nu = s.nu, nc = s.nc, m = s.m;
    return nx * nx * 4 + nx * 4            // V, Qh, A, AtV; v, qh, f, vplus
           + nx * nu * 3 + nu * nu * 2     // Sh, Bm, BtV; Rh, LR
           + nc * nx + nc * nu + nu * nc   // C, D, RiDt
           + nc * nc + nu + nc             // LS, rh, d
           + 3 * (nu + nc) * m;            // b, k/z, t
  }

  __device__ static Layout make(float* p, const Dims& s) {
    const int nx = s.nx, nu = s.nu, nc = s.nc, m = s.m;
    Layout l;
    l.V = p; p += nx * nx;
    l.Qh = p; p += nx * nx;
    l.A = p; p += nx * nx;
    l.AtV = p; p += nx * nx;
    l.v = p; p += nx;
    l.qh = p; p += nx;
    l.f = p; p += nx;
    l.vplus = p; p += nx;
    l.Sh = p; p += nx * nu;
    l.Bm = p; p += nx * nu;
    l.BtV = p; p += nu * nx;
    l.Rh = p; p += nu * nu;
    l.LR = p; p += nu * nu;
    l.C = p; p += nc * nx;
    l.D = p; p += nc * nu;
    l.RiDt = p; p += nu * nc;
    l.LS = p; p += nc * nc;
    l.rh = p; p += nu;
    l.d = p; p += nc;
    l.b1 = p; p += nu * m;
    l.b2 = p; p += nc * m;
    l.k = p; p += nu * m;
    l.z = p; p += nc * m;
    l.t1 = p; p += nu * m;
    l.t2 = p; p += nc * m;
    return l;
  }
};

__device__ void load(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

__device__ void zero(float* dst, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = 0.f;
}

// In-place symmetrization of an n×n matrix: each unordered pair is owned
// by one thread.
__device__ void symmetrize(float* M, int n) {
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    const int i = idx / n, j = idx % n;
    if (i < j) {
      const float s = 0.5f * (M[i * n + j] + M[j * n + i]);
      M[i * n + j] = s;
      M[j * n + i] = s;
    }
  }
}

// Lower Cholesky factor L of the SPD matrix M (n×n), right-looking. A
// non-positive pivot gives NaN, which propagates to the solution (the
// solver's signal to raise its regularization).
__device__ void cholesky(const float* M, float* L, int n) {
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    const int i = idx / n, j = idx % n;
    L[idx] = (j <= i) ? M[idx] : 0.f;
  }
  __syncthreads();
  for (int j = 0; j < n; ++j) {
    if (threadIdx.x == 0) L[j * n + j] = sqrtf(L[j * n + j]);
    __syncthreads();
    const float djj = L[j * n + j];
    for (int i = j + 1 + threadIdx.x; i < n; i += blockDim.x) L[i * n + j] /= djj;
    __syncthreads();
    const int w = n - j - 1;  // trailing block rows/cols j+1..n-1
    for (int idx = threadIdx.x; idx < w * w; idx += blockDim.x) {
      const int i = j + 1 + idx / w, kk = j + 1 + idx % w;
      if (kk <= i) L[i * n + kk] -= L[i * n + j] * L[kk * n + j];
    }
    __syncthreads();
  }
}

// X ← (L Lᵀ)⁻¹ X for X (n × ncol, row stride ncol), one thread per column.
__device__ void chol_solve(const float* L, float* X, int n, int ncol) {
  for (int c = threadIdx.x; c < ncol; c += blockDim.x) {
    for (int i = 0; i < n; ++i) {
      float s = X[i * ncol + c];
      for (int kk = 0; kk < i; ++kk) s -= L[i * n + kk] * X[kk * ncol + c];
      X[i * ncol + c] = s / L[i * n + i];
    }
    for (int i = n - 1; i >= 0; --i) {
      float s = X[i * ncol + c];
      for (int kk = i + 1; kk < n; ++kk) s -= L[kk * n + i] * X[kk * ncol + c];
      X[i * ncol + c] = s / L[i * n + i];
    }
  }
}

// In place: (X1, X2) ← [[R̂, Dᵀ], [D, -µI]]⁻¹ (X1, X2) by the fixed-pivot
// Schur elimination z = S⁻¹(D R̂⁻¹ X1 − X2), k = R̂⁻¹X1 − R̂⁻¹Dᵀ z.
__device__ void kkt_solve(const Layout& l, const Dims& s, float* X1, float* X2) {
  const int nu = s.nu, nc = s.nc, m = s.m;
  chol_solve(l.LR, X1, nu, m);
  if (nc == 0) return;
  __syncthreads();
  for (int idx = threadIdx.x; idx < nc * m; idx += blockDim.x) {
    const int i = idx / m, c = idx % m;
    float acc = -X2[idx];
    for (int kk = 0; kk < nu; ++kk) acc += l.D[i * nu + kk] * X1[kk * m + c];
    X2[idx] = acc;
  }
  __syncthreads();
  chol_solve(l.LS, X2, nc, m);
  __syncthreads();
  for (int idx = threadIdx.x; idx < nu * m; idx += blockDim.x) {
    const int i = idx / m, c = idx % m;
    float acc = X1[idx];
    for (int j = 0; j < nc; ++j) acc -= l.RiDt[i * nc + j] * X2[j * m + c];
    X1[idx] = acc;
  }
}

__global__ void __launch_bounds__(kThreads) riccati_backward_kernel(
    const float* __restrict__ Q, const float* __restrict__ S,
    const float* __restrict__ R, const float* __restrict__ q,
    const float* __restrict__ r, const float* __restrict__ A,
    const float* __restrict__ Bm, const float* __restrict__ f,
    const float* __restrict__ C, const float* __restrict__ D,
    const float* __restrict__ d, const float* __restrict__ mu_all,
    float* __restrict__ K_o, float* __restrict__ Z_o,
    float* __restrict__ kff_o, float* __restrict__ zff_o,
    float* __restrict__ yff_o, float* __restrict__ Acl_o,
    float* __restrict__ Vxx_o, float* __restrict__ vx_o, int L, Dims s,
    int refine_steps) {
  extern __shared__ float smem[];
  const Layout l = Layout::make(smem, s);
  const int nx = s.nx, nu = s.nu, nc = s.nc, m = s.m;
  const int b = blockIdx.x;
  const float mu = mu_all[b];

  zero(l.V, nx * nx);
  zero(l.v, nx);

  for (int t = L - 1; t >= 0; --t) {
    const size_t kt = (size_t)b * L + t;
    const bool term = (t == L - 1);
    load(l.Qh, Q + kt * nx * nx, nx * nx);
    load(l.Sh, S + kt * nx * nu, nx * nu);
    load(l.Rh, R + kt * nu * nu, nu * nu);
    load(l.qh, q + kt * nx, nx);
    load(l.rh, r + kt * nu, nu);
    load(l.C, C + kt * nc * nx, nc * nx);
    load(l.D, D + kt * nc * nu, nc * nu);
    load(l.d, d + kt * nc, nc);
    // terminal knot: A = B = f = 0 by select, never read, so garbage in
    // the unused terminal blocks cannot leak into V
    if (term) {
      zero(l.A, nx * nx);
      zero(l.Bm, nx * nu);
      zero(l.f, nx);
    } else {
      load(l.A, A + kt * nx * nx, nx * nx);
      load(l.Bm, Bm + kt * nx * nu, nx * nu);
      load(l.f, f + kt * nx, nx);
    }
    __syncthreads();

    // v⁺ = v + V f;  AᵀV;  BᵀV
    for (int i = threadIdx.x; i < nx; i += blockDim.x) {
      float acc = l.v[i];
      for (int j = 0; j < nx; ++j) acc += l.V[i * nx + j] * l.f[j];
      l.vplus[i] = acc;
    }
    for (int idx = threadIdx.x; idx < nx * nx; idx += blockDim.x) {
      const int i = idx / nx, j = idx % nx;
      float acc = 0.f;
      for (int kk = 0; kk < nx; ++kk) acc += l.A[kk * nx + i] * l.V[kk * nx + j];
      l.AtV[idx] = acc;
    }
    for (int idx = threadIdx.x; idx < nu * nx; idx += blockDim.x) {
      const int i = idx / nx, j = idx % nx;
      float acc = 0.f;
      for (int kk = 0; kk < nx; ++kk) acc += l.Bm[kk * nu + i] * l.V[kk * nx + j];
      l.BtV[idx] = acc;
    }
    __syncthreads();

    // Q̂ = Q + AᵀVA, Ŝ = S + AᵀVB, R̂ = R + BᵀVB, q̂ = q + Aᵀv⁺, r̂ = r + Bᵀv⁺
    for (int idx = threadIdx.x; idx < nx * nx; idx += blockDim.x) {
      const int i = idx / nx, j = idx % nx;
      float acc = 0.f;
      for (int kk = 0; kk < nx; ++kk) acc += l.AtV[i * nx + kk] * l.A[kk * nx + j];
      l.Qh[idx] += acc;
    }
    for (int idx = threadIdx.x; idx < nx * nu; idx += blockDim.x) {
      const int i = idx / nu, j = idx % nu;
      float acc = 0.f;
      for (int kk = 0; kk < nx; ++kk) acc += l.AtV[i * nx + kk] * l.Bm[kk * nu + j];
      l.Sh[idx] += acc;
    }
    for (int idx = threadIdx.x; idx < nu * nu; idx += blockDim.x) {
      const int i = idx / nu, j = idx % nu;
      float acc = 0.f;
      for (int kk = 0; kk < nx; ++kk) acc += l.BtV[i * nx + kk] * l.Bm[kk * nu + j];
      l.Rh[idx] += acc;
    }
    for (int i = threadIdx.x; i < nx; i += blockDim.x) {
      float acc = 0.f;
      for (int kk = 0; kk < nx; ++kk) acc += l.A[kk * nx + i] * l.vplus[kk];
      l.qh[i] += acc;
    }
    for (int i = threadIdx.x; i < nu; i += blockDim.x) {
      float acc = 0.f;
      for (int kk = 0; kk < nx; ++kk) acc += l.Bm[kk * nu + i] * l.vplus[kk];
      l.rh[i] += acc;
    }
    __syncthreads();
    symmetrize(l.Rh, nu);
    __syncthreads();

    // factor: L_R = chol(R̂); R̂⁻¹Dᵀ; L_S = chol(sym(µI + D R̂⁻¹Dᵀ))
    cholesky(l.Rh, l.LR, nu);
    if (nc > 0) {
      for (int idx = threadIdx.x; idx < nu * nc; idx += blockDim.x) {
        const int i = idx / nc, j = idx % nc;
        l.RiDt[idx] = l.D[j * nu + i];
      }
      __syncthreads();
      chol_solve(l.LR, l.RiDt, nu, nc);
      __syncthreads();
      for (int idx = threadIdx.x; idx < nc * nc; idx += blockDim.x) {
        const int i = idx / nc, j = idx % nc;
        float acc = (i == j) ? mu : 0.f;
        for (int kk = 0; kk < nu; ++kk) acc += l.D[i * nu + kk] * l.RiDt[kk * nc + j];
        l.t2[idx] = acc;  // scratch for S before its factor
      }
      __syncthreads();
      symmetrize(l.t2, nc);
      __syncthreads();
      cholesky(l.t2, l.LS, nc);
    }

    // right-hand side −[Ŝᵀ r̂; C d], columns [gain block | feed-forward]
    for (int idx = threadIdx.x; idx < nu * m; idx += blockDim.x) {
      const int i = idx / m, c = idx % m;
      const float val = (c < nx) ? -l.Sh[c * nu + i] : -l.rh[i];
      l.b1[idx] = val;
      l.k[idx] = val;
    }
    for (int idx = threadIdx.x; idx < nc * m; idx += blockDim.x) {
      const int i = idx / m, c = idx % m;
      const float val = (c < nx) ? -l.C[i * nx + c] : -l.d[i];
      l.b2[idx] = val;
      l.z[idx] = val;
    }
    __syncthreads();
    kkt_solve(l, s, l.k, l.z);
    __syncthreads();

    for (int it = 0; it < refine_steps; ++it) {
      // residual (t1, t2) = (b1, b2) − KKT·(k, z)
      for (int idx = threadIdx.x; idx < nu * m; idx += blockDim.x) {
        const int i = idx / m, c = idx % m;
        float acc = l.b1[idx];
        for (int kk = 0; kk < nu; ++kk) acc -= l.Rh[i * nu + kk] * l.k[kk * m + c];
        for (int j = 0; j < nc; ++j) acc -= l.D[j * nu + i] * l.z[j * m + c];
        l.t1[idx] = acc;
      }
      for (int idx = threadIdx.x; idx < nc * m; idx += blockDim.x) {
        const int i = idx / m, c = idx % m;
        float acc = l.b2[idx] + mu * l.z[idx];
        for (int kk = 0; kk < nu; ++kk) acc -= l.D[i * nu + kk] * l.k[kk * m + c];
        l.t2[idx] = acc;
      }
      __syncthreads();
      kkt_solve(l, s, l.t1, l.t2);
      __syncthreads();
      for (int idx = threadIdx.x; idx < nu * m; idx += blockDim.x) l.k[idx] += l.t1[idx];
      for (int idx = threadIdx.x; idx < nc * m; idx += blockDim.x) l.z[idx] += l.t2[idx];
      __syncthreads();
    }

    // gains out; A_cl = A + B K and yff = f + B kff (zero at t = N)
    float* K_t = K_o + kt * nu * nx;
    float* Z_t = Z_o + kt * nc * nx;
    for (int idx = threadIdx.x; idx < nu * nx; idx += blockDim.x) {
      K_t[idx] = l.k[(idx / nx) * m + idx % nx];
    }
    for (int idx = threadIdx.x; idx < nc * nx; idx += blockDim.x) {
      Z_t[idx] = l.z[(idx / nx) * m + idx % nx];
    }
    for (int i = threadIdx.x; i < nu; i += blockDim.x) kff_o[kt * nu + i] = l.k[i * m + nx];
    for (int i = threadIdx.x; i < nc; i += blockDim.x) zff_o[kt * nc + i] = l.z[i * m + nx];
    float* Acl_t = Acl_o + kt * nx * nx;
    for (int idx = threadIdx.x; idx < nx * m; idx += blockDim.x) {
      const int i = idx / m, c = idx % m;
      float acc = 0.f;
      if (!term) {
        acc = (c < nx) ? l.A[i * nx + c] : l.f[i];
        for (int kk = 0; kk < nu; ++kk) acc += l.Bm[i * nu + kk] * l.k[kk * m + c];
      }
      if (c < nx) {
        Acl_t[i * nx + c] = acc;
      } else {
        yff_o[kt * nx + i] = acc;
      }
    }

    // [Vxx | vx] = [Q̂ | q̂] + Ŝ [K | kff] + Cᵀ [Z | zff]; V is free now
    for (int idx = threadIdx.x; idx < nx * m; idx += blockDim.x) {
      const int i = idx / m, c = idx % m;
      float acc = (c < nx) ? l.Qh[i * nx + c] : l.qh[i];
      for (int kk = 0; kk < nu; ++kk) acc += l.Sh[i * nu + kk] * l.k[kk * m + c];
      for (int j = 0; j < nc; ++j) acc += l.C[j * nx + i] * l.z[j * m + c];
      if (c < nx) {
        l.V[i * nx + c] = acc;
      } else {
        l.v[i] = acc;
      }
    }
    __syncthreads();
    symmetrize(l.V, nx);
    __syncthreads();
    float* V_t = Vxx_o + kt * nx * nx;
    for (int idx = threadIdx.x; idx < nx * nx; idx += blockDim.x) V_t[idx] = l.V[idx];
    for (int i = threadIdx.x; i < nx; i += blockDim.x) vx_o[kt * nx + i] = l.v[i];
    __syncthreads();
  }
}

constexpr int kMaxDevices = 64;

// Raises the kernel's dynamic shared-memory limit on the current device,
// once per device and only when `smem` is more than was set before.
cudaError_t ensure_smem_limit(size_t smem) {
  static size_t smem_limit[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > smem_limit[dev]) {
    err = cudaFuncSetAttribute(riccati_backward_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    smem_limit[dev] = smem;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs at these dims.
long long riccati_backward_smem_bytes(int nx, int nu, int nc) {
  const Dims s{nx, nu, nc, nx + 1};
  return (long long)(Layout::floats(s) * sizeof(float));
}

// Blocks of the kernel that one SM of the current device holds at once at
// these dims (kThreads threads and the shared memory above per block), as
// cudaOccupancyMaxActiveBlocksPerMultiprocessor gives it; a cudaError as
// a negative number.
int riccati_backward_blocks_per_sm(int nx, int nu, int nc) {
  const Dims s{nx, nu, nc, nx + 1};
  const size_t smem = Layout::floats(s) * sizeof(float);
  cudaError_t err = ensure_smem_limit(smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, riccati_backward_kernel, kThreads, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

// Launches one block per problem on `stream`; returns cudaGetLastError().
int riccati_backward_f32(const void* Q, const void* S, const void* R,
                         const void* q, const void* r, const void* A,
                         const void* Bm, const void* f, const void* C,
                         const void* D, const void* d, const void* mu,
                         void* K, void* Z, void* kff, void* zff, void* yff,
                         void* Acl, void* Vxx, void* vx, int batch, int L,
                         int nx, int nu, int nc, int refine_steps,
                         void* stream) {
  const Dims s{nx, nu, nc, nx + 1};
  const size_t smem = Layout::floats(s) * sizeof(float);
  const cudaError_t err = ensure_smem_limit(smem);
  if (err != cudaSuccess) return (int)err;
  riccati_backward_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)Q, (const float*)S, (const float*)R, (const float*)q,
      (const float*)r, (const float*)A, (const float*)Bm, (const float*)f,
      (const float*)C, (const float*)D, (const float*)d, (const float*)mu,
      (float*)K, (float*)Z, (float*)kff, (float*)zff, (float*)yff,
      (float*)Acl, (float*)Vxx, (float*)vx, L, s, refine_steps);
  return (int)cudaGetLastError();
}

}  // extern "C"
