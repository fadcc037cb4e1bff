// Fused backward proximal Riccati sweep for a batch of constrained LQ
// problems, float32, one thread block per problem, the time loop inside
// the block.
//
// Replaces: aligator_tpu/gar/pallas_riccati.py `_backward_kernel` (launched
// by `backward_sweep_batched`). Same function as aligator_tpu/gar/riccati.py
// `_stage_solve` / `_terminal_solve` over t = N..0 with nth = 0; the KKT
// solve is the reference kernel's explicit-inverse form (`_kkt_solve_T`).
//
// What bounds it on an H100. At the bench widths (nx = 56, nu = nc = 22) a
// knot reads ~24 KB and writes ~26 KB and needs ~2.1 MFLOP (chip_smoke.py
// `backward_cost`), so the function's bound is the float32 FMA rate
// (0.816 ms at B = 256, N = 100). The kernel is latency-bound instead: the
// knots of one problem form a dependent chain, so a block's time is one
// knot's latency times N + 1, and the batch (64 to 256 problems) puts one
// or two blocks on an SM. A knot is 12 barrier-separated phases on 8 warps
// and two 22-step elimination chains on one warp. The loop body's code is
// larger than the instruction cache, so code size moves the time as much
// as arithmetic does: unrolled loops and duplicated epilogues cost more
// than they save.
//
// Where the previous version (one thread per right-hand-side column,
// barriers between all phases, products from shared memory) spent a knot,
// measured with clock64() stamps on an H100 at B = 256, N = 100 (176 us
// per knot): loads 11.6 %, hats 17.9 %, the two Cholesky factors 11.5 %,
// the five triangular solves 41.8 %, the refinement residual 4.1 %, the
// outputs 13.2 %. This version: ~43 us per knot, 4.4 ms per sweep; its
// split is printed by `python -m aligator_tpu_torch.probes.k1_phases`.
//
// Design, against each cause of that latency:
// 1. The dependent chain. The KKT system [[R̂, Dᵀ], [D, -µI]] is solved
//    through its explicit inverse T = [[R̂⁻¹ - U·(R̂⁻¹Dᵀ)ᵀ, U], [Uᵀ, -S⁻¹]],
//    S = µI + D·R̂⁻¹Dᵀ, U = R̂⁻¹Dᵀ·S⁻¹, formed once per knot. Only the
//    inverses of R̂ and S stay sequential: each is one Gauss-Jordan chain
//    (the factor and its inverse in one elimination, no pivoting, as R̂ and
//    S are positive definite) on one warp, a row per lane in registers, the
//    pivot row passed by __shfl_sync, no block barrier. The solve and its
//    refinement step are then parallel products: sol = T·rhs, then
//    sol += T·(rhs - KKT·sol).
// 2. Products. Every product is register-tiled: a thread accumulates a 4×4
//    tile from 16-byte shared-memory loads of k-major operands (0.125 load
//    instructions per FMA instead of 2), loading the next k while it uses
//    this one. The hat products are the reference kernel's two fused
//    passes, Wᵀ = [V | v]ᵀ·[A | f | B] and H = W·[A | f | B]. The thread
//    that accumulates a tile of Q̂ (on or below the diagonal) or q̂ keeps it
//    in registers through the KKT solve and writes the same tile of Vxx,
//    mirrored, and vx: Q̂ never goes through shared memory. Widths are
//    template arguments: one instantiation for the bench widths and one
//    that reads them at run time.
// 3. Loads. A knot's A, B, f, C, D, d do not depend on the carry (V, v):
//    the next knot's are copied with cp.async (16-byte copies where the
//    alignment allows) into a second buffer while the current knot
//    computes. Q, S, R, q, r go from device memory straight into the
//    registers of the threads that add them to the hats, issued at the top
//    of the knot and consumed after the first product.
// 4. Residency. 256 threads and 113,440 B of dynamic shared memory at the
//    bench widths, registers capped at 128 per thread by the launch
//    bounds, so two blocks fit on an SM (228 KB of shared memory, 64 K
//    registers): B = 256 is one wave on 132 SMs. Shared memory is the
//    limit that binds; the hat buffer Wᵀ shares its space with the
//    solution, the residual and the factorization scratch, which are never
//    live at the same time.
// No tensor cores: the port keeps full float32 products (TF32 would lose
// the digits the recursion needs at µ ≤ 1e-6). nc = 0 skips the Schur
// block. The terminal knot's A, B, f are never read: its buffer is zero.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRt = -1;        // template width taken from the launch
constexpr int kChainMax = 32;  // a factor has one row per lane: nu, nc <= 32
constexpr int kSlack = 8;      // floats after each buffer: a tile may read past a row
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int r4(int n) { return (n + 3) & ~3; }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// Widths: a template argument >= 0 fixes one at compile time, kRt reads it
// from the launch. Every leading dimension but ldS is a multiple of 4
// floats, for 16-byte loads.
template <int NX, int NU, int NC>
struct Dims {
  int rx, ru, rc;
  __host__ __device__ int nx() const { return NX >= 0 ? NX : rx; }
  __host__ __device__ int nu() const { return NU >= 0 ? NU : ru; }
  __host__ __device__ int nc() const { return NC >= 0 ? NC : rc; }
  __host__ __device__ int m() const { return nx() + 1; }       // columns [gain | ff]
  __host__ __device__ int nk() const { return nu() + nc(); }   // KKT rows [u | multiplier]
  __host__ __device__ int cB() const { return r4(nx() + 1); }  // first B column of [A | f | B]
  __host__ __device__ int ldV() const { return r4(m()); }
  __host__ __device__ int ldM() const { return r4(cB() + nu()); }
  __host__ __device__ int ldD() const { return r4(nu()); }
  __host__ __device__ int ldT() const { return r4(nk()); }
  __host__ __device__ int nf() const { return imax(nu(), nc()); }
  __host__ __device__ int ldS() const { return nf() | 1; }  // odd: rows in distinct banks
  // 4 × 4 tiles of H = W·[A | f | B], in three kinds, one after the other:
  // Q̂|q̂ (rows and columns of A: the tiles on and below the diagonal, as Q̂
  // and Vxx are symmetric; then the tiles of column nx, q̂, above it), one
  // per thread; Ŝ (rows of A, columns of B); R̂|r̂ (rows of B, columns f, B).
  __host__ __device__ int nt() const { return cdiv(nx(), 4); }      // row tiles of A
  __host__ __device__ int tq() const { return nx() / 4; }           // tile column of q̂
  __host__ __device__ int nlow() const { return nt() * (nt() + 1) / 2; }
  __host__ __device__ int nq() const { return nlow() + tq(); }
  __host__ __device__ int ncs() const { return (ldM() - cB()) / 4; }
  __host__ __device__ int ns() const { return nt() * ncs(); }
  __host__ __device__ int cF4() const { return nx() & ~3; }
  __host__ __device__ int ncr() const { return (ldM() - cF4()) / 4; }
  __host__ __device__ int n2() const { return nq() + ns() + cdiv(nu(), 4) * ncr(); }
};

// Shared-memory carve-up (floats). [V | v] is nx × ldV; each knot buffer
// (two of them) holds [A | f | 0 | B] (nx × ldM), [C | d] (nc × ldV) and
// D (nc × ldD); rhs = -[Ŝᵀ | r̂; C | d] (nk × ldV); the KKT matrix and
// Tᵀ (nk × ldT); `work` holds Wᵀ ((nx+1) × ldM), or sol and res, or the
// five factorization matrices (nf × ldS each).
template <class D>
struct Smem {
  float *V, *M[2], *Cd[2], *Dm[2], *rhs, *K, *T, *work;

  __host__ __device__ static size_t work_floats(const D& s) {
    const size_t wt = (size_t)s.m() * s.ldM();
    const size_t solres = 2 * ((size_t)s.nk() * s.ldV() + kSlack);
    const size_t fac = 5 * (size_t)s.nf() * s.ldS();
    return wt > solres ? (wt > fac ? wt : fac) : (solres > fac ? solres : fac);
  }

  __host__ __device__ static size_t floats(const D& s) {
    const size_t nx = s.nx(), nc = s.nc(), nk = s.nk();
    return nx * s.ldV() + 2 * (nx * s.ldM() + nc * s.ldV() + nc * s.ldD()) +
           nk * s.ldV() + 2 * nk * s.ldT() + work_floats(s) + 11 * kSlack;
  }

  __device__ static Smem make(float* p, const D& s) {
    const int nx = s.nx(), nc = s.nc(), nk = s.nk();
    Smem l;
    auto take = [&p](size_t n) { float* q = p; p += n + kSlack; return q; };
    l.V = take((size_t)nx * s.ldV());
    for (int i = 0; i < 2; ++i) {
      l.M[i] = take((size_t)nx * s.ldM());
      l.Cd[i] = take((size_t)nc * s.ldV());
      l.Dm[i] = take((size_t)nc * s.ldD());
    }
    l.rhs = take((size_t)nk * s.ldV());
    l.K = take((size_t)nk * s.ldT());
    l.T = take((size_t)nk * s.ldT());
    l.work = take(work_floats(s));
    return l;
  }
};

struct Knots {
  const float *Q, *S, *R, *q, *r, *A, *B, *f, *C, *D, *d;
};

template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(BYTES)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copies the rows × cols row-major block at src into shared memory at dst
// (row stride ld, 16-byte aligned), asynchronously, in copies of W floats.
template <int W>
__device__ __forceinline__ void copy_block(float* dst, int ld, const float* src, int rows,
                                           int cols) {
  const int per_row = cols / W;
#pragma unroll 1
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * W;
    cp_async<4 * W>(dst + r * ld + c, src + r * cols + c);
  }
}

// The widest copies that the row width and the source's alignment allow.
__device__ __forceinline__ void copy_rows(float* dst, int ld, const float* src, int rows,
                                          int cols) {
  const auto p = reinterpret_cast<unsigned long long>(src);
  if (cols % 4 == 0 && p % 16 == 0) copy_block<4>(dst, ld, src, rows, cols);
  else if (cols % 2 == 0 && p % 8 == 0) copy_block<2>(dst, ld, src, rows, cols);
  else copy_block<1>(dst, ld, src, rows, cols);
}

// Copies knot kt's [A | f | B] (unless `terminal`), [C | d] and D into one
// knot buffer, asynchronously.
template <class D>
__device__ __forceinline__ void issue_knot(const Knots& g, size_t kt, bool terminal, float* M,
                                           float* Cd, float* Dm, const D& s) {
  const int nx = s.nx(), nu = s.nu(), nc = s.nc();
  const int ldM = s.ldM(), ldV = s.ldV(), ldD = s.ldD(), cB = s.cB();
  if (!terminal) {
    copy_rows(M, ldM, g.A + kt * nx * nx, nx, nx);
    copy_rows(M + cB, ldM, g.B + kt * nx * nu, nx, nu);
    for (int i = threadIdx.x; i < nx; i += kThreads) cp_async<4>(M + i * ldM + nx, g.f + kt * nx + i);
  }
  copy_rows(Cd, ldV, g.C + kt * nc * nx, nc, nx);
  for (int i = threadIdx.x; i < nc; i += kThreads) cp_async<4>(Cd + i * ldV + nx, g.d + kt * nc + i);
  copy_rows(Dm, ldD, g.D + kt * nc * nu, nc, nu);
}

template <int N>
__device__ __forceinline__ void load_row(float (&v)[N], const float* p) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + i);
    v[i] = q.x;
    v[i + 1] = q.y;
    v[i + 2] = q.z;
    v[i + 3] = q.w;
  }
}

// acc[i][j] ±= Σ_{k<K} X[k·ldx + i] · Y[k·ldy + j]: both operands k-major,
// 16-byte aligned, a register tile of TM × TN outputs.
// The next k's operands are loaded while this k's are used.
template <int TM, int TN, bool NEG>
__device__ __forceinline__ void mm_kk(float (&acc)[TM][TN], const float* X, int ldx,
                                      const float* Y, int ldy, int K) {
  float x[TM], y[TN];
  load_row(x, X);
  load_row(y, Y);
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    float xn[TM], yn[TN];
    if (k + 1 < K) {
      load_row(xn, X + (k + 1) * ldx);
      load_row(yn, Y + (k + 1) * ldy);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(NEG ? -x[i] : x[i], y[j], acc[i][j]);
#pragma unroll
    for (int i = 0; i < TM; ++i) x[i] = xn[i];
#pragma unroll
    for (int j = 0; j < TN; ++j) y[j] = yn[j];
  }
}

// acc[i][j] += Σ_{k<K} X[i·ldx + k] · Y[k·ldy + j] for the first `rows` rows
// of X (row-major X, k-major Y).
template <int TM, int TN>
__device__ __forceinline__ void mm_ik(float (&acc)[TM][TN], const float* X, int ldx, int rows,
                                      const float* Y, int ldy, int K) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float x[TM], y[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) x[i] = i < rows ? X[i * ldx + k] : 0.f;
    load_row(y, Y + k * ldy);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// X = A⁻¹ for the symmetric positive definite n × n matrix A (row stride
// lda) on the calling warp, by Gauss-Jordan elimination without pivoting.
// A is read as (A + Aᵀ)/2, which is written back over A. Lane i keeps row
// i of [A | E] in registers (E = I at the start); step j takes the pivot
// and row j from lane j by shuffle, and every other lane subtracts its
// multiple of that row. A ends diagonal, diag(d)·A⁻¹ = E, and lane i
// writes row i of A⁻¹ = E_i / d_i to X (row stride ldx). One chain of n
// steps, no block barrier. The pivot's reciprocal is a fast one refined by
// a Newton step, which keeps the IEEE division's slow-path branch out of
// the chain. A non-positive pivot makes every entry NaN, the solver's
// signal to raise its regularization, as a Cholesky factor of an
// indefinite matrix would. Not inlined: one copy of the unrolled chain
// serves both calls, which keeps the loop body's code smaller.
template <int NMAX>
__device__ __noinline__ void warp_spd_inverse(float* A, int lda, float* X, int ldx, int n) {
  const int i = threadIdx.x & 31;
  float a[NMAX], e[NMAX];
#pragma unroll
  for (int k = 0; k < NMAX; ++k) {
    a[k] = (i < n && k < n) ? 0.5f * (A[i * lda + k] + A[k * lda + i]) : 0.f;
    e[k] = k == i ? 1.f : 0.f;
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < NMAX; ++k)
    if (i < n && k < n) A[i * lda + k] = a[k];
  bool pd = true;
  float rd = 0.f;  // 1 / d_i
#pragma unroll
  for (int j = 0; j < NMAX; ++j) {
    if (j >= n) break;
    const float p = __shfl_sync(kFull, a[j], j);
    pd = pd && p > 0.f;
    float rp = __fdividef(1.f, p);
    rp = fmaf(rp, fmaf(-p, rp, 1.f), rp);
    if (i == j) rd = rp;
    const float f = i != j ? a[j] * rp : 0.f;
    float r[NMAX];
#pragma unroll
    for (int k = 0; k < NMAX; ++k)
      if (k < n) r[k] = __shfl_sync(kFull, k > j ? a[k] : e[k], j);
#pragma unroll
    for (int k = 0; k < NMAX; ++k) {
      if (k >= n) continue;
      if (k > j) a[k] = fmaf(-f, r[k], a[k]);
      else e[k] = fmaf(-f, r[k], e[k]);
    }
  }
  const float sc = pd ? rd : __int_as_float(0x7fc00000);
#pragma unroll
  for (int k = 0; k < NMAX; ++k)
    if (i < n && k < n) X[i * ldx + k] = e[k] * sc;
}

template <int NX, int NU, int NC>
__global__ void __launch_bounds__(kThreads, 2) riccati_backward_kernel(
    Knots g, const float* __restrict__ mu_all, float* __restrict__ K_o,
    float* __restrict__ Z_o, float* __restrict__ kff_o, float* __restrict__ zff_o,
    float* __restrict__ yff_o, float* __restrict__ Acl_o, float* __restrict__ Vxx_o,
    float* __restrict__ vx_o, int L, Dims<NX, NU, NC> s, int refine_steps) {
  using D = Dims<NX, NU, NC>;
  constexpr int TQ = 4;
  constexpr int kChain = (NU >= 0 && NC >= 0) ? imax(imax(NU, NC), 1) : kChainMax;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Smem<D> l = Smem<D>::make(smem, s);
  const int nx = s.nx(), nu = s.nu(), nc = s.nc(), m = s.m(), nk = s.nk();
  const int ldV = s.ldV(), ldM = s.ldM(), ldD = s.ldD(), ldT = s.ldT(), ldS = s.ldS();
  const int cB = s.cB(), nq = s.nq(), nlow = s.nlow(), tq = s.tq(), ncs = s.ncs();
  const int ncr = s.ncr(), cF4 = s.cF4(), n2 = s.n2(), ns = s.ns();
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const float mu = mu_all[b];
  const int kbuf = (int)(l.M[1] - l.M[0]);  // from one knot buffer to the other

  // V = v = 0 and every pad zero; the terminal knot's [A | f | B] stays zero
  const int total = (int)Smem<D>::floats(s);
  for (int i = tid; i < total; i += kThreads) smem[i] = 0.f;
  __syncthreads();
  {
    const int o = ((L - 1) & 1) * kbuf;
    issue_knot(g, (size_t)b * L + L - 1, true, l.M[0] + o, l.Cd[0] + o, l.Dm[0] + o, s);
    cp_async_commit();
  }

  float* Wt = l.work;                       // Wᵀ, (nx+1) × ldM
  float* sol = l.work;                      // nk × ldV
  float* res = l.work + nk * ldV + kSlack;  // nk × ldV
  const int fs = s.nf() * ldS;              // factorization scratch slots
  float* Rinv = l.work;
  float* RiDt = l.work + fs;
  float* Ssym = l.work + 2 * fs;
  float* Sinv = l.work + 3 * fs;
  float* U = l.work + 4 * fs;

  for (int t = L - 1; t >= 0; --t) {
    const size_t kt = (size_t)b * L + t;
    // this knot's buffer has arrived; after the barrier nobody reads the
    // other one (the previous knot's), so the next knot goes there
    cp_async_wait_all();
    __syncthreads();
    if (t > 0) {
      const int o = ((t - 1) & 1) * kbuf;
      issue_knot(g, kt - 1, false, l.M[0] + o, l.Cd[0] + o, l.Dm[0] + o, s);
      cp_async_commit();
    }
    const int o = (t & 1) * kbuf;
    const float* Mc = l.M[0] + o;
    const float* Cd = l.Cd[0] + o;
    const float* Dm = l.Dm[0] + o;

    // The hat tiles (TQ × 4 of H = W·[A | f | B]), in three kinds: Q̂|q̂
    // (w < nq, rows of A, columns [A | f]), Ŝ (rows of A, columns of B),
    // R̂|r̂ (rows of B, columns [f | B]). h holds the tile's [Q S; · R] and
    // [q; r] entries, read from device memory.
    auto item = [&](int w, int& a0, int& c0) {
      if (w < nlow) {  // w = ti·(ti+1)/2 + tj, tj <= ti
        int ti = (int)((sqrtf(8.f * w + 1.f) - 1.f) * 0.5f);
        if ((ti + 1) * (ti + 2) / 2 <= w) ++ti;
        if (ti * (ti + 1) / 2 > w) --ti;
        a0 = 4 * ti;
        c0 = 4 * (w - ti * (ti + 1) / 2);
      } else if (w < nq) {
        a0 = 4 * (w - nlow);
        c0 = 4 * tq;
      } else if (w < nq + ns) {
        a0 = 4 * ((w - nq) / ncs);
        c0 = cB + 4 * ((w - nq) % ncs);
      } else {
        a0 = cB + 4 * ((w - nq - ns) / ncr);
        c0 = cF4 + 4 * ((w - nq - ns) % ncr);
      }
    };
    auto load_h = [&](int w, float (&h)[TQ][4]) {
      int a0, c0;
      item(w, a0, c0);
      const int kind = w < nq ? 0 : (w < nq + ns ? 1 : 2);
#pragma unroll
      for (int ii = 0; ii < TQ; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int a = a0 + ii, c = c0 + jj;
          const bool arow = a < nx, brow = a >= cB && a < cB + nu;
          const bool bcol = c >= cB && c < cB + nu;
          const float* src = nullptr;
          if (kind == 0 && arow && c < nx) src = g.Q + (kt * nx + a) * nx + c;
          if (kind == 0 && arow && c == nx) src = g.q + kt * nx + a;
          if (kind == 1 && arow && bcol) src = g.S + (kt * nx + a) * nu + c - cB;
          if (kind == 2 && brow && bcol) src = g.R + (kt * nu + a - cB) * nu + c - cB;
          if (kind == 2 && brow && c == nx) src = g.r + kt * nu + a - cB;
          h[ii][jj] = src ? __ldg(src) : 0.f;
        }
    };
    float h0[TQ][4];
    if (tid < n2) load_h(tid, h0);  // consumed after P1: its latency hides behind it

    // P1: Wᵀ = [V | v]ᵀ [A | f | B]  ((nx+1) × ldM)
    {
      const int nct = ldM / 4, n1 = cdiv(m, 4) * nct;
      for (int w = tid; w < n1; w += kThreads) {
        const int c0 = 4 * (w / nct), a0 = 4 * (w % nct);
        float acc[4][4] = {};
        mm_kk<4, 4, false>(acc, l.V + c0, ldV, Mc + a0, ldM, nx);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
          if (c0 + ii < m)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) Wt[(c0 + ii) * ldM + a0 + jj] = acc[ii][jj];
      }
    }
    __syncthreads();

    // P2: H = W·[A | f | B] + [Q S; · R], with q̂ = q + Aᵀv + AᵀVf and
    // r̂ = r + Bᵀv + BᵀVf. Q̂|q̂ stays in the registers of thread tid < nq;
    // -Ŝᵀ and -r̂ go to rhs, R̂ to the KKT matrix.
    float qh[TQ][4];  // Q̂|q̂ on threads tid < nq, then [Vxx | vx]
    for (int w = tid; w < n2; w += kThreads) {
      float acc[TQ][4];
      if (w == tid) {
#pragma unroll
        for (int ii = 0; ii < TQ; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = h0[ii][jj];
      } else {
        load_h(w, acc);
      }
      int a0, c0;
      item(w, a0, c0);
      mm_kk<TQ, 4, false>(acc, Wt + a0, ldM, Mc + c0, ldM, nx);
      const int kind = w < nq ? 0 : (w < nq + ns ? 1 : 2);
      const int orhs = (int)(l.rhs - smem), oK = (int)(l.K - smem);
#pragma unroll
      for (int ii = 0; ii < TQ; ++ii) {
        const int a = a0 + ii;
        const float mtv = Wt[nx * ldM + a];  // (Mᵀv)(a)
        const bool arow = a < nx, brow = a >= cB && a < cB + nu;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int c = c0 + jj;
          const bool bcol = c >= cB && c < cB + nu;
          const float v = acc[ii][jj] + (c == nx ? mtv : 0.f);  // q̂, r̂ take Mᵀv
          if (kind == 0) acc[ii][jj] = v;
          int off = -1;
          float out = -v;
          if (kind == 1 && arow && bcol) off = orhs + (c - cB) * ldV + a;  // -Ŝᵀ
          if (kind == 2 && brow && c == nx) off = orhs + (a - cB) * ldV + nx;  // -r̂
          if (kind == 2 && brow && bcol) {
            off = oK + (a - cB) * ldT + c - cB;  // R̂
            out = v;
          }
          if (off >= 0) smem[off] = out;
        }
      }
      if (w < nq) {
#pragma unroll
        for (int ii = 0; ii < TQ; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) qh[ii][jj] = acc[ii][jj];
      }
    }
    for (int i = tid; i < nc * m; i += kThreads) {
      const int j = i / m, c = i % m;
      l.rhs[(nu + j) * ldV + c] = -Cd[j * ldV + c];
    }
    for (int i = tid; i < nc * nu; i += kThreads) {
      const int j = i / nu, k = i % nu;
      const float dv = Dm[j * ldD + k];
      l.K[(nu + j) * ldT + k] = dv;
      l.K[k * ldT + nu + j] = dv;
    }
    for (int i = tid; i < nc * nc; i += kThreads) {
      const int j = i / nc, k = i % nc;
      l.K[(nu + j) * ldT + nu + k] = j == k ? -mu : 0.f;
    }
    __syncthreads();

    // T = KKT⁻¹, stored transposed: l.T[c·ldT + r] = T(r, c). Warp 0
    // symmetrizes R̂ in the KKT matrix and inverts it.
    if (tid < 32) warp_spd_inverse<kChain>(l.K, ldT, Rinv, ldS, nu);
    __syncthreads();
    if (nc > 0) {
      for (int i = tid; i < nu * nc; i += kThreads) {
        const int r = i / nc, c = i % nc;
        float acc = 0.f;
#pragma unroll 2
        for (int k = 0; k < nu; ++k) acc = fmaf(Rinv[r * ldS + k], Dm[c * ldD + k], acc);
        RiDt[r * ldS + c] = acc;  // R̂⁻¹Dᵀ
      }
      __syncthreads();
      for (int i = tid; i < nc * nc; i += kThreads) {
        const int r = i / nc, c = i % nc;
        float sij = 0.f, sji = 0.f;
#pragma unroll 2
        for (int k = 0; k < nu; ++k) {
          sij = fmaf(Dm[r * ldD + k], RiDt[k * ldS + c], sij);
          sji = fmaf(Dm[c * ldD + k], RiDt[k * ldS + r], sji);
        }
        const float dmu = r == c ? mu : 0.f;
        Ssym[r * ldS + c] = 0.5f * ((dmu + sij) + (dmu + sji));  // sym(µI + D R̂⁻¹Dᵀ)
      }
      __syncthreads();
      if (tid < 32) warp_spd_inverse<kChain>(Ssym, ldS, Sinv, ldS, nc);
      __syncthreads();
      for (int i = tid; i < nu * nc + nc * nc; i += kThreads) {
        if (i < nu * nc) {
          const int r = i / nc, c = i % nc;
          float acc = 0.f;
#pragma unroll 2
          for (int k = 0; k < nc; ++k) acc = fmaf(RiDt[r * ldS + k], Sinv[k * ldS + c], acc);
          U[r * ldS + c] = acc;
          l.T[(nu + c) * ldT + r] = acc;  // T(r, nu+c) = U
          l.T[r * ldT + nu + c] = acc;    // T(nu+c, r) = Uᵀ
        } else {
          const int r = (i - nu * nc) / nc, c = (i - nu * nc) % nc;
          l.T[(nu + c) * ldT + nu + r] = -Sinv[r * ldS + c];
        }
      }
      __syncthreads();
    }
    for (int i = tid; i < nu * nu; i += kThreads) {
      const int r = i / nu, c = i % nu;
      float acc = 0.f;
#pragma unroll 2
      for (int k = 0; k < nc; ++k) acc = fmaf(U[r * ldS + k], RiDt[c * ldS + k], acc);
      l.T[c * ldT + r] = Rinv[r * ldS + c] - acc;  // T11 = R̂⁻¹ - U·(R̂⁻¹Dᵀ)ᵀ
    }
    __syncthreads();

    // sol = T·rhs, then refine_steps rounds of sol += T·(rhs - KKT·sol);
    // the last round writes the gains
    const int nct = cdiv(m, 4), na = cdiv(nk, 4) * nct;
    float* K_t = K_o + kt * nu * nx;
    float* Z_t = Z_o + kt * nc * nx;
    for (int it = 0; it <= refine_steps; ++it) {
      if (it > 0) {
        for (int w = tid; w < na; w += kThreads) {
          const int i0 = 4 * (w / nct), j0 = 4 * (w % nct);
          float acc[4][4] = {};
          mm_kk<4, 4, false>(acc, l.K + i0, ldT, sol + j0, ldV, nk);
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const int r = i0 + ii, c = j0 + jj;
              if (r < nk && c < m) res[r * ldV + c] = l.rhs[r * ldV + c] - acc[ii][jj];
            }
        }
        __syncthreads();
      }
      const float* x = it > 0 ? res : l.rhs;
      const bool last = it == refine_steps;
      for (int w = tid; w < na; w += kThreads) {
        const int i0 = 4 * (w / nct), j0 = 4 * (w % nct);
        float acc[4][4] = {};
        mm_kk<4, 4, false>(acc, l.T + i0, ldT, x + j0, ldV, nk);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int r = i0 + ii, c = j0 + jj;
            if (r >= nk || c >= m) continue;
            const float v = it > 0 ? sol[r * ldV + c] + acc[ii][jj] : acc[ii][jj];
            sol[r * ldV + c] = v;
            if (!last) continue;
            float* dst = r < nu ? (c < nx ? K_t + r * nx + c : kff_o + kt * nu + r)
                                : (c < nx ? Z_t + (r - nu) * nx + c : zff_o + kt * nc + r - nu);
            *dst = v;
          }
      }
      __syncthreads();
    }

    // [Vxx | vx] = [Q̂ | q̂] + [Ŝ | Cᵀ]·sol = [Q̂ | q̂] - rhsᵀ·sol on the threads
    // holding Q̂, which write each entry on and below the diagonal to both
    // halves of V (the symmetric part, as the reference takes it, up to
    // rounding); [Acl | yff] = [A | f] + B·[K | kff] on the others (zero at
    // the terminal knot, whose buffer is zero). V is free after P1, and the
    // next knot's barrier orders these writes before its reads.
    if (tid < nq) {
      int a0, c0;
      item(tid, a0, c0);
      mm_kk<TQ, 4, true>(qh, l.rhs + a0, ldV, sol + c0, ldV, nk);
      float* V_t = Vxx_o + kt * nx * nx;
#pragma unroll
      for (int ii = 0; ii < TQ; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int r = a0 + ii, c = c0 + jj;
          const float v = qh[ii][jj];
          if (r >= nx) continue;
          if (c == nx) {
            l.V[r * ldV + nx] = v;
            vx_o[kt * nx + r] = v;
          } else if (c < nx && (c0 < a0 || (c0 == a0 && c <= r))) {
            l.V[r * ldV + c] = v;
            l.V[c * ldV + r] = v;
            V_t[r * nx + c] = v;
            V_t[c * nx + r] = v;
          }
        }
    }
    {
      const int nat = cdiv(nx, 4) * nct;
      float* Acl_t = Acl_o + kt * nx * nx;
      int w = tid - nq;
      if (w < 0) w += kThreads;
      for (; w < nat; w += kThreads) {
        const int i0 = 4 * (w / nct), j0 = 4 * (w % nct);
        float acc[4][4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            acc[ii][jj] = (i0 + ii < nx && j0 + jj < m) ? Mc[(i0 + ii) * ldM + j0 + jj] : 0.f;
        mm_ik<4, 4>(acc, Mc + i0 * ldM + cB, ldM, nx - i0, sol + j0, ldV, nu);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int r = i0 + ii, c = j0 + jj;
            if (r < nx && c < nx) Acl_t[r * nx + c] = acc[ii][jj];
            else if (r < nx && c == nx) yff_o[kt * nx + r] = acc[ii][jj];
          }
      }
    }
  }
}

// Host side: which instantiation serves which widths, the shared-memory
// limit, the launch.

using RtDims = Dims<kRt, kRt, kRt>;
using BenchDims = Dims<56, 22, 22>;  // lqr56, the bench's Talos-reduced widths
constexpr int kMaxDevices = 64;

bool is_bench(int nx, int nu, int nc) { return nx == 56 && nu == 22 && nc == 22; }

const void* pick(int nx, int nu, int nc) {
  return is_bench(nx, nu, nc) ? (const void*)&riccati_backward_kernel<56, 22, 22>
                              : (const void*)&riccati_backward_kernel<kRt, kRt, kRt>;
}

size_t smem_bytes(int nx, int nu, int nc) {
  return Smem<RtDims>::floats(RtDims{nx, nu, nc}) * sizeof(float);
}

// Raises an instantiation's dynamic shared-memory limit on the current
// device, once per device and only when `smem` is more than was set before.
cudaError_t ensure_smem_limit(const void* fn, bool bench, size_t smem) {
  static size_t smem_limit[2][kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  size_t& lim = smem_limit[bench ? 1 : 0][dev];
  if (smem > lim) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    lim = smem;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs at these dims.
long long riccati_backward_smem_bytes(int nx, int nu, int nc) {
  return (long long)smem_bytes(nx, nu, nc);
}

// Which instantiation serves these dims: 1 the bench widths (nx = 56,
// nu = nc = 22, fixed at compile time), 0 the one that reads its widths at
// run time; -1 if nu or nc exceeds 32 (a factor's rows are a warp's
// lanes), -2 if the Q̂ tiles (4 × 4 each) outnumber the block's threads.
int riccati_backward_variant(int nx, int nu, int nc) {
  if (nu > kChainMax || nc > kChainMax) return -1;
  if (RtDims{nx, nu, nc}.nq() > kThreads) return -2;
  return is_bench(nx, nu, nc) ? 1 : 0;
}

// Blocks of the kernel that one SM of the current device holds at once at
// these dims (kThreads threads and the shared memory above per block), as
// cudaOccupancyMaxActiveBlocksPerMultiprocessor gives it; a cudaError as
// a negative number.
int riccati_backward_blocks_per_sm(int nx, int nu, int nc) {
  const void* fn = pick(nx, nu, nc);
  const size_t smem = smem_bytes(nx, nu, nc);
  cudaError_t err = ensure_smem_limit(fn, is_bench(nx, nu, nc), smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

// Launches one block per problem on `stream`; returns cudaGetLastError().
// The caller checks riccati_backward_variant() >= 0 first.
int riccati_backward_f32(const void* Q, const void* S, const void* R, const void* q,
                         const void* r, const void* A, const void* Bm, const void* f,
                         const void* C, const void* D, const void* d, const void* mu, void* K,
                         void* Z, void* kff, void* zff, void* yff, void* Acl, void* Vxx,
                         void* vx, int batch, int L, int nx, int nu, int nc, int refine_steps,
                         void* stream) {
  const size_t smem = smem_bytes(nx, nu, nc);
  const bool bench = is_bench(nx, nu, nc);
  const cudaError_t err = ensure_smem_limit(pick(nx, nu, nc), bench, smem);
  if (err != cudaSuccess) return (int)err;
  const Knots g{(const float*)Q, (const float*)S, (const float*)R, (const float*)q,
                (const float*)r, (const float*)A, (const float*)Bm, (const float*)f,
                (const float*)C, (const float*)D, (const float*)d};
  auto out = [](void* p) { return (float*)p; };
  if (bench) {
    riccati_backward_kernel<56, 22, 22><<<batch, kThreads, smem, (cudaStream_t)stream>>>(
        g, (const float*)mu, out(K), out(Z), out(kff), out(zff), out(yff), out(Acl),
        out(Vxx), out(vx), L, BenchDims{nx, nu, nc}, refine_steps);
  } else {
    riccati_backward_kernel<kRt, kRt, kRt><<<batch, kThreads, smem, (cudaStream_t)stream>>>(
        g, (const float*)mu, out(K), out(Z), out(kff), out(zff), out(yff), out(Acl),
        out(Vxx), out(vx), L, RtDims{nx, nu, nc}, refine_steps);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
