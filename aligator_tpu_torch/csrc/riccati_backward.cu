// Fused backward proximal Riccati sweep for a batch of constrained LQ
// problems, float32, one thread block per problem (or, at the compiled
// widths and small batches, one thread-block cluster), the time loop inside
// the block.
//
// Replaces: aligator_tpu/gar/pallas_riccati.py `_backward_kernel` (launched
// by `backward_sweep_batched`). Same function as aligator_tpu/gar/riccati.py
// `_stage_solve` / `_terminal_solve` over t = N..0 with nth = 0; the KKT
// solve is the reference kernel's explicit-inverse form (`_kkt_solve_T`).
//
// Three kernels. `riccati_backward_kernel<NX, NU, NC>` has its widths compiled
// in and serves the bench widths (nx = 56, nu = nc = 22) and the talos
// walk's (nx = 56, nu = 22, nc = 0), one block per problem;
// `riccati_backward_cluster<NX, NU, NC>` serves the same widths with one
// cluster of 2, 4 or 8 blocks per problem where the batch would leave most
// SMs idle (its design is set out above it; `cluster_of` below and
// fused_riccati.backward_plan choose the size); `riccati_backward_small<NT, NCH>`
// reads its widths at launch and serves every other width (nu, nc <= 32,
// nx <= 84) in one of twelve classes: NT ∈ {32, 64, 128, 256} threads, the
// fewest that give each 4 × 4 tile of a knot's largest pass its own thread,
// and a Gauss-Jordan chain of NCH ∈ {8, 16, 32} rows, the shortest that
// holds max(nu, nc). `variant_of` below (and fused_riccati.backward_plan)
// picks one; e.g. the quadrotor (12, 4, 6) takes <32, 8>, the solo jump
// (36, 12, 0) <128, 16>.
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
// than they save. At small widths the bound is bytes (a few KB per knot)
// and the arithmetic is under a microsecond per knot on one SM; what is
// left is latency: ~8 (nc = 0) to 12 dependent phases, two chains of
// nu and nc pivots, and the fetch of the loop body's code.
//
// Where the previous version (one thread per right-hand-side column,
// barriers between all phases, products from shared memory) spent a knot,
// measured with clock64() stamps on an H100 at B = 256, N = 100 (176 us
// per knot): loads 11.6 %, hats 17.9 %, the two Cholesky factors 11.5 %,
// the five triangular solves 41.8 %, the refinement residual 4.1 %, the
// outputs 13.2 %. This version: ~43 us per knot, 4.4 ms per sweep; its
// split is printed by `python -m aligator_tpu_torch.probes.k1_phases`.
// The compiled widths' kernel took every other width too, with its widths
// read at launch, until the small-width kernel: ~40 us per knot at the
// quadrotor's and the jump's widths alike (79,000 cycles), 43 % of it in
// the two chains (`warp_spd_inverse<32>`: 32 unrolled steps whatever n,
// 2,728 B of spill), 25 % in the hat passes and 15 % in the last solve
// phase, all of it far above the phases' arithmetic. The small-width
// kernel: ~13-14.5 us per knot there (27,300-29,000 cycles; the chains
// 11-17 % of it). What is left is each thread's serial latency through a
// phase, a few hundred dependent instructions at ~5-10 cycles each (the
// solve passes' shared-memory read-modify-writes, one entry after
// another, cost 5 % of a knot until they moved as whole rows of 4): two or
// four warps per problem instead of one take 3 % off the quadrotor's knot
// (`probes.k1_phases --min-threads`), so the class keeps the fewest.
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
//    sol += T·(rhs - KKT·sol). The small-width kernel's chain keeps its
//    row in one array of NCH registers (no spill) and rolls its pivot loop
//    (code of ~2·NCH instructions a step, not NCH² unrolled), and at nc = 0
//    writes R̂⁻¹ straight into T, one phase fewer.
// 2. Products. Every product is register-tiled: a thread accumulates a 4×4
//    tile from 16-byte shared-memory loads of k-major operands (0.125 load
//    instructions per FMA instead of 2), loading the next k while it uses
//    this one. The hat products are the reference kernel's two fused
//    passes, Wᵀ = [V | v]ᵀ·[A | f | B] and H = W·[A | f | B]. The thread
//    that accumulates a tile of Q̂ (on or below the diagonal) or q̂ keeps it
//    in registers through the KKT solve and writes the same tile of Vxx,
//    mirrored, and vx: Q̂ never goes through shared memory. The small-width
//    kernel forms Wᵀ over the rows of A only, with v added to its column
//    nx, and takes the hat tiles that hold column nx as [A | f | B]ᵀ·Wᵀ,
//    which gives q̂ and r̂ their Mᵀv: a pass of cdiv(nx, 4) row tiles, so
//    the jump's largest pass is 117 tiles and fits four warps.
// 3. Loads. A knot's A, B, f, C, D, d do not depend on the carry (V, v):
//    the next knot's are copied with cp.async (16-byte copies where the
//    alignment allows) into a second buffer while the current knot
//    computes. Q, S, R, q, r go from device memory straight into the
//    registers of the threads that add them to the hats, issued at the top
//    of the knot and consumed after the first product (the small-width
//    kernel reads them through a per-tile descriptor set up before the
//    time loop: a bit test and a load each).
// 4. Fixed costs per knot (small widths). Every tile's coordinates are
//    computed once per block, before the time loop, into registers; the
//    element loops divide by multiplying with a reciprocal set up there;
//    no sqrtf, / or % runs in a knot. The tile codes are hidden from
//    loop-invariant code motion (`opaque`), so that the compiler recomputes
//    a tile's few addresses in the knot instead of holding every one of
//    them across the loop (that took more than 255 registers and spilled).
//    One warp synchronizes with __syncwarp; a block of NT threads with
//    __syncthreads, where every thread has work in the tile passes by the
//    choice of NT (all of a block's threads work, so a named barrier over
//    fewer would be the same barrier).
// 5. Residency. 256 threads and 113,440 B of dynamic shared memory at the
//    bench widths, registers capped at 128 per thread by the launch
//    bounds, so two blocks fit on an SM (228 KB of shared memory, 64 K
//    registers): B = 256 is one wave on 132 SMs. Shared memory is the
//    limit that binds; the hat buffer Wᵀ shares its space with the
//    solution, the residual and the factorization scratch, which are never
//    live at the same time. The small-width kernel keeps that carve-up (so
//    it takes every width the compiled-widths kernel took at widths read at
//    launch) and its classes put 32 to 128 threads on a problem below 256,
//    158-195 registers each and no spill: 12 blocks of the quadrotor's and
//    3 of the jump's on an SM (2 of the widths read at launch before).
// No tensor cores: the port keeps full float32 products (TF32 would lose
// the digits the recursion needs at µ ≤ 1e-6), and at these widths no
// product fills `wgmma`'s 64-row tile. nc = 0 skips the Schur block. The
// terminal knot's A, B, f are never read: its buffer is zero.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

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
          // whole rows of 4: the pad columns past m stay zero (rhs's are)
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
            const int r = i0 + ii;
            if (r >= nk) break;
            const float4 b = *reinterpret_cast<const float4*>(l.rhs + r * ldV + j0);
            *reinterpret_cast<float4*>(res + r * ldV + j0) =
                make_float4(b.x - acc[ii][0], b.y - acc[ii][1], b.z - acc[ii][2],
                            b.w - acc[ii][3]);
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

// ---------------------------------------------------------------------------
// The small-width kernel: widths read at launch, NT threads per block and
// a chain of NCH rows fixed at compile time by its class.

using RtDims = Dims<kRt, kRt, kRt>;

// X = A⁻¹ for the symmetric positive definite n × n matrix A (n <= NMAX,
// row stride lda) on the calling warp, by the same Gauss-Jordan
// elimination as warp_spd_inverse, with one register array per lane and a
// rolled pivot loop, so that its code and its registers stay small at any
// n. Lane i keeps row i of [A | E] in w[], rotated so that the current
// pivot column is always w[0]: at step j every lane computes its multiple
// f of the pivot row (taken from lane j by shuffle) and shifts w[k+1] -
// f·row_j[k+1] into w[k]; the identity column j of E enters at the end,
// as -f (1 on lane j). The zero columns past n stay zero. After n steps
// w[NMAX-n+k] = E(i, k) and A⁻¹(i, k) = E(i, k) / d_i, written to
// X[i·xr + k·xc] (xr = ldx, xc = 1 for rows; xr = 1, xc = ldx for the
// transpose). The arithmetic is warp_spd_inverse's, operation for
// operation: same multiples, same fmaf, same Newton-refined reciprocal and
// the same NaN signal at a non-positive pivot. Inlined: a call would save
// the caller's live registers (the Q̂ tile, the next knot's hat terms) to
// the stack around it; the rolled loop keeps each copy small.
template <int NMAX>
__device__ __forceinline__ void warp_spd_inverse_rolled(float* A, int lda, float* X, int xr, int xc,
                                                     int n) {
  const int i = threadIdx.x & 31;
  float w[NMAX];
#pragma unroll
  for (int k = 0; k < NMAX; ++k)
    w[k] = (i < n && k < n) ? 0.5f * (A[i * lda + k] + A[k * lda + i]) : 0.f;
  __syncwarp();
#pragma unroll
  for (int k = 0; k < NMAX; ++k)
    if (i < n && k < n) A[i * lda + k] = w[k];
  bool pd = true;
  float rd = 0.f;  // 1 / d_i
#pragma unroll 1
  for (int j = 0; j < n; ++j) {
    const float p = __shfl_sync(kFull, w[0], j);
    pd = pd && p > 0.f;
    float rp = __fdividef(1.f, p);
    rp = fmaf(rp, fmaf(-p, rp, 1.f), rp);
    if (i == j) rd = rp;
    const float f = i != j ? w[0] * rp : 0.f;
#pragma unroll
    for (int k = 1; k < NMAX; ++k) w[k - 1] = fmaf(-f, __shfl_sync(kFull, w[k], j), w[k]);
    w[NMAX - 1] = i != j ? -f : 1.f;
  }
  const float sc = pd ? rd : __int_as_float(0x7fc00000);
#pragma unroll
  for (int s = 0; s < NMAX; ++s) {
    const int k = s - (NMAX - n);
    if (i < n && k >= 0) X[i * xr + k * xc] = w[s] * sc;
  }
}

// i / d for 0 <= i < 2^16 and 0 < d < 2^16 as one multiply-high by
// ceil(2^32 / d), exact there (i·d < 2^32); set up before the time loop.
struct Div {
  unsigned mul;
  int d;
  __device__ explicit Div(int d_) : mul(d_ > 1 ? 0xffffffffu / (unsigned)d_ + 1u : 0u), d(d_) {}
  __device__ __forceinline__ int q(int i) const {
    return d > 1 ? (int)__umulhi((unsigned)i, mul) : i;
  }
};

// A tile's coordinates, packed: first row, first column, kind (of the hat
// tiles: 0 Q̂|q̂, 1 Ŝ, 2 R̂|r̂) and whether the tile holds column nx.
__device__ __forceinline__ int tile_code(int a0, int c0, int kind = 0, bool swap = false) {
  return a0 | c0 << 8 | kind << 16 | (int)swap << 18;
}
__device__ __forceinline__ int tile_a0(int code) { return code & 0xff; }
__device__ __forceinline__ int tile_c0(int code) { return (code >> 8) & 0xff; }
__device__ __forceinline__ int tile_kind(int code) { return (code >> 16) & 3; }
__device__ __forceinline__ bool tile_swap(int code) { return (code >> 18) & 1; }

// The copy width in floats of a knot array's rows: 16, 8 or 4 bytes, the
// widest that its row width and base address allow (every knot's rows then
// share that alignment).
__device__ __forceinline__ int copy_width(const float* base, int cols) {
  const auto p = reinterpret_cast<unsigned long long>(base);
  return cols % 4 == 0 && p % 16 == 0 ? 4 : (cols % 2 == 0 && p % 8 == 0 ? 2 : 1);
}

template <int NT, int W>
__device__ __forceinline__ void copy_block_rows(float* dst, int ld, const float* src, int rows,
                                                const Div& per_row) {
  const int n = per_row.d;
#pragma unroll 1
  for (int i = threadIdx.x; i < rows * n; i += NT) {
    const int r = per_row.q(i), c = (i - r * n) * W;
    cp_async<4 * W>(dst + r * ld + c, src + r * n * W + c);
  }
}

// Copies the rows × cols block at src (row-major) into shared memory at dst
// (row stride ld), asynchronously; `per_row` divides by cols / width.
template <int NT>
__device__ __forceinline__ void copy_knot_rows(float* dst, int ld, const float* src, int rows,
                                               int w, const Div& per_row) {
  if (w == 4) copy_block_rows<NT, 4>(dst, ld, src, rows, per_row);
  else if (w == 2) copy_block_rows<NT, 2>(dst, ld, src, rows, per_row);
  else copy_block_rows<NT, 1>(dst, ld, src, rows, per_row);
}

// The row copies of A, B, C and D: their widths, and division by their
// copies per row, set up before the time loop.
struct KnotCopies {
  int w;  // the four copy widths, a byte each
  Div A, B, C, D;
  __device__ static Div per_row(const float* base, int cols) {
    return Div(imax(cols / copy_width(base, cols), 1));
  }
  __device__ KnotCopies(const Knots& g, const RtDims& s)
      : w(copy_width(g.A, s.nx()) | copy_width(g.B, s.nu()) << 8 | copy_width(g.C, s.nx()) << 16 |
          copy_width(g.D, s.nu()) << 24),
        A(per_row(g.A, s.nx())), B(per_row(g.B, s.nu())), C(per_row(g.C, s.nx())),
        D(per_row(g.D, s.nu())) {}
  __device__ int width(int k) const { return (w >> (8 * k)) & 0xff; }
};

// issue_knot with NT threads and the copies set up before the time loop.
template <int NT>
__device__ __forceinline__ void issue_knot_rows(const Knots& g, size_t kt, bool terminal,
                                                float* M, float* Cd, float* Dm, const RtDims& s,
                                                const KnotCopies& kc) {
  const int nx = s.nx(), nu = s.nu(), nc = s.nc();
  const int ldM = s.ldM(), ldV = s.ldV(), ldD = s.ldD(), cB = s.cB();
  if (!terminal) {
    copy_knot_rows<NT>(M, ldM, g.A + kt * nx * nx, nx, kc.width(0), kc.A);
    copy_knot_rows<NT>(M + cB, ldM, g.B + kt * nx * nu, nx, kc.width(1), kc.B);
    for (int i = threadIdx.x; i < nx; i += NT) cp_async<4>(M + i * ldM + nx, g.f + kt * nx + i);
  }
  copy_knot_rows<NT>(Cd, ldV, g.C + kt * nc * nx, nc, kc.width(2), kc.C);
  for (int i = threadIdx.x; i < nc; i += NT) cp_async<4>(Cd + i * ldV + nx, g.d + kt * nc + i);
  copy_knot_rows<NT>(Dm, ldD, g.D + kt * nc * nu, nc, kc.width(3), kc.D);
}

// x, hidden from the compiler's loop-invariant code motion: what is
// computed from it stays inside the time loop. Hoisting every tile's
// addresses out of the loop needed more than 255 registers and spilled.
__device__ __forceinline__ int opaque(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

// a[i] for a run-time i < MT, from registers (a[i] itself would put the
// array in local memory).
template <int MT>
__device__ __forceinline__ int at(const int (&a)[MT], int i) {
  int v = a[0];
#pragma unroll
  for (int k = 1; k < MT; ++k) v = i == k ? a[k] : v;
  return v;
}

// The block's barrier: one warp synchronizes as a warp.
template <int NT>
__device__ __forceinline__ void bar_sync() {
  if constexpr (NT == 32) __syncwarp();
  else __syncthreads();
}

// Where the [Q S; · R] and [q; r] terms of a hat tile (a0, c0, kind) come
// from: the matrix of its kind (Q, S or R) and the offset of the tile's
// first entry in one knot's block of it, the masks of the tile's rows and
// columns inside that block (the masks of the tile's outputs too), the tile
// column that is column nx (q or r; -1 for none) and the vector's offset.
// Set up once per tile, before the time loop: in the knot a term is a bit
// test and a load.
struct HatTerms {
  int bits;  // rows | cols << 4 | (jv + 1) << 8 | kind << 12
  int off, voff;
  __device__ HatTerms(int a0, int c0, int kind, const RtDims& s) {
    const int nx = s.nx(), nu = s.nu(), cB = s.cB();
    const int r0 = kind == 2 ? cB : 0, nr = kind == 2 ? nu : nx;  // rows of the block in H
    const int k0 = kind == 0 ? 0 : cB, nk = kind == 0 ? nx : nu;  // its columns in H
    int rows = 0, cols = 0;
    for (int i = 0; i < 4; ++i) {
      if (a0 + i >= r0 && a0 + i < r0 + nr) rows |= 1 << i;
      if (c0 + i >= k0 && c0 + i < k0 + nk) cols |= 1 << i;
    }
    const int jv = kind != 1 && c0 <= nx && nx < c0 + 4 ? nx - c0 : -1;
    bits = rows | cols << 4 | (jv + 1) << 8 | kind << 12;
    off = (a0 - r0) * (kind == 0 ? nx : nu) + c0 - k0;
    voff = a0 - r0;
  }
  __device__ bool row(int i) const { return (bits >> i) & 1; }
  __device__ bool col(int j) const { return (bits >> (4 + j)) & 1; }
  __device__ int jv() const { return ((bits >> 8) & 15) - 1; }
  __device__ int kind() const { return bits >> 12; }
};

// h = the hat tile's [Q S; · R] and [q; r] terms at knot kt (zero outside
// its block), from device memory.
__device__ __forceinline__ void load_hat_terms(const Knots& g, size_t kt, const HatTerms& ht,
                                               const RtDims& s, float (&h)[4][4]) {
  const int nx = s.nx(), nu = s.nu(), kind = ht.kind(), jv = ht.jv();
  const int ld = kind == 0 ? nx : nu;
  const float* M = (kind == 0 ? g.Q + kt * nx * nx
                              : (kind == 1 ? g.S + kt * nx * nu : g.R + kt * nu * nu)) + ht.off;
  const float* v = (kind == 0 ? g.q + kt * nx : g.r + kt * nu) + ht.voff;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      h[ii][jj] = ht.row(ii) && ht.col(jj) ? __ldg(M + ii * ld + jj)
                                            : (ht.row(ii) && jj == jv ? __ldg(v + ii) : 0.f);
}

// The tile passes of a knot and each thread's tiles in them (at most MT
// per pass), fixed before the time loop.
template <int MT>
struct TileTable {
  int p1[MT], p2[MT], sol[MT], acl[MT];  // codes
  int n1, n2, nsol, nacl;                // this thread's count in each pass
};

// The tile counts of a knot's passes: Wᵀ over the rows of A, the hats
// H = W·[A | f | B], the KKT solve, [Acl | yff]. A class gives each tile of
// the largest of the first three its own thread.
__host__ __device__ inline int tiles_w(const RtDims& s) { return cdiv(s.nx(), 4) * (s.ldM() / 4); }
__host__ __device__ inline int tiles_sol(const RtDims& s) {
  return cdiv(s.nk(), 4) * cdiv(s.m(), 4);
}
__host__ __device__ inline int tiles_acl(const RtDims& s) {
  return cdiv(s.nx(), 4) * cdiv(s.m(), 4);
}
__host__ __device__ inline int knot_tiles(const RtDims& s) {
  return imax(imax(tiles_w(s), s.n2()), tiles_sol(s));
}

template <int NT, int MT>
__device__ TileTable<MT> tile_table(const RtDims& s) {
  const int tid = threadIdx.x, nx = s.nx(), cB = s.cB(), nlow = s.nlow(), nq = s.nq();
  const int ns = s.ns(), ncs = s.ncs(), ncr = s.ncr(), tq = s.tq(), cF4 = s.cF4();
  const int nct1 = s.ldM() / 4, nctm = cdiv(s.m(), 4);
  const int n1 = tiles_w(s), n2 = s.n2(), na = tiles_sol(s), nat = tiles_acl(s);
  TileTable<MT> tt;
  tt.n1 = tt.n2 = tt.nsol = tt.nacl = 0;
  int wacl = tid - nq;  // [Acl | yff] starts past the threads that hold Q̂
  if (wacl < 0) wacl += NT;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int w = tid + i * NT;
    tt.p1[i] = tt.p2[i] = tt.sol[i] = tt.acl[i] = 0;
    if (w < n1) {  // Wᵀ tile: rows c0 (of Wᵀ), columns a0
      tt.p1[i] = tile_code(4 * (w % nct1), 4 * (w / nct1));
      tt.n1 = i + 1;
    }
    if (w < n2) {
      int a0, c0, kind;
      if (w < nlow) {  // w = ti·(ti+1)/2 + tj, tj <= ti
        int ti = (int)((sqrtf(8.f * w + 1.f) - 1.f) * 0.5f);
        if ((ti + 1) * (ti + 2) / 2 <= w) ++ti;
        if (ti * (ti + 1) / 2 > w) --ti;
        a0 = 4 * ti, c0 = 4 * (w - ti * (ti + 1) / 2), kind = 0;
      } else if (w < nq) {
        a0 = 4 * (w - nlow), c0 = 4 * tq, kind = 0;
      } else if (w < nq + ns) {
        a0 = 4 * ((w - nq) / ncs), c0 = cB + 4 * ((w - nq) % ncs), kind = 1;
      } else {
        a0 = cB + 4 * ((w - nq - ns) / ncr), c0 = cF4 + 4 * ((w - nq - ns) % ncr), kind = 2;
      }
      tt.p2[i] = tile_code(a0, c0, kind, kind != 1 && c0 <= nx && nx < c0 + 4);
      tt.n2 = i + 1;
    }
    if (w < na) {
      tt.sol[i] = tile_code(4 * (w / nctm), 4 * (w % nctm));
      tt.nsol = i + 1;
    }
    const int wa = wacl + i * NT;
    if (wa < nat) {
      tt.acl[i] = tile_code(4 * (wa / nctm), 4 * (wa % nctm));
      tt.nacl = i + 1;
    }
  }
  return tt;
}

// One block per problem; NT threads, launch bounds that leave each thread
// up to 255 registers (no spill): 8 blocks of 32 threads on an SM, 1 of 256.
template <int NT, int NCH>
__global__ void __launch_bounds__(NT, 256 / NT) riccati_backward_small(
    Knots g, const float* __restrict__ mu_all, float* __restrict__ K_o,
    float* __restrict__ Z_o, float* __restrict__ kff_o, float* __restrict__ zff_o,
    float* __restrict__ yff_o, float* __restrict__ Acl_o, float* __restrict__ Vxx_o,
    float* __restrict__ vx_o, int L, RtDims s, int refine_steps) {
  constexpr int MT = NT == 256 ? 3 : 1;  // a pass's tiles per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Smem<RtDims> l = Smem<RtDims>::make(smem, s);
  const int nx = s.nx(), nu = s.nu(), nc = s.nc(), m = s.m(), nk = s.nk();
  const int ldV = s.ldV(), ldM = s.ldM(), ldD = s.ldD(), ldT = s.ldT(), ldS = s.ldS();
  const int cB = s.cB(), nq = s.nq();
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const float mu = mu_all[b];
  const int kbuf = (int)(l.M[1] - l.M[0]);  // from one knot buffer to the other
  const TileTable<MT> tt = tile_table<NT, MT>(s);
  const HatTerms ht0(tile_a0(tt.p2[0]), tile_c0(tt.p2[0]), tile_kind(tt.p2[0]), s);
  const Div dm(m), dnu(nu), dnc(imax(nc, 1));
  const KnotCopies kc(g, s);

  // V = v = 0, every pad zero, the KKT matrix's -µI block (never
  // overwritten); the terminal knot's [A | f | B] stays zero
  const int total = (int)Smem<RtDims>::floats(s);
  for (int i = tid; i < total; i += NT) smem[i] = 0.f;
  bar_sync<NT>();
  for (int j = tid; j < nc; j += NT) l.K[(nu + j) * ldT + nu + j] = -mu;
  {
    const int o = ((L - 1) & 1) * kbuf;
    issue_knot_rows<NT>(g, (size_t)b * L + L - 1, true, l.M[0] + o, l.Cd[0] + o,
                        l.Dm[0] + o, s, kc);
    cp_async_commit();
  }

  float* Wt = l.work;                       // Wᵀ, nx × ldM
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
    bar_sync<NT>();
    if (t > 0) {
      const int o = ((t - 1) & 1) * kbuf;
      issue_knot_rows<NT>(g, kt - 1, false, l.M[0] + o, l.Cd[0] + o, l.Dm[0] + o, s, kc);
      cp_async_commit();
    }
    const int o = (t & 1) * kbuf;
    const float* Mc = l.M[0] + o;
    const float* Cd = l.Cd[0] + o;
    const float* Dm = l.Dm[0] + o;
    // the hat terms of this thread's first hat tile, consumed after P1
    float h0[4][4];
    HatTerms ht = ht0;
    ht.bits = opaque(ht.bits);
    if (tt.n2 > 0) load_hat_terms(g, kt, ht, s, h0);

    // P1: Wᵀ = V·[A | f | B] over the rows of A (V is symmetric), with v
    // added to column nx: Wᵀ(:, nx) = V·f + v, so that the hat tiles that
    // hold column nx take Mᵀv with it. [C | d] and D go to the KKT
    // right-hand side and matrix meanwhile.
#pragma unroll 1
    for (int i = 0; i < tt.n1; ++i) {
      const int code = opaque(at(tt.p1, i));
      const int a0 = tile_a0(code), c0 = tile_c0(code);
      float acc[4][4] = {};
      mm_kk<4, 4, false>(acc, l.V + c0, ldV, Mc + a0, ldM, nx);
      const int jf = nx - a0;  // column nx in this tile, if 0 <= jf < 4
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        if (c0 + ii >= nx) break;
        const float v = l.V[(c0 + ii) * ldV + nx];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (jj == jf) acc[ii][jj] += v;
        *reinterpret_cast<float4*>(Wt + (c0 + ii) * ldM + a0) =
            make_float4(acc[ii][0], acc[ii][1], acc[ii][2], acc[ii][3]);
      }
    }
    for (int i = tid; i < nc * m; i += NT) {
      const int j = dm.q(i), c = i - j * m;
      l.rhs[(nu + j) * ldV + c] = -Cd[j * ldV + c];
    }
    for (int i = tid; i < nc * nu; i += NT) {
      const int j = dnu.q(i), k = i - j * nu;
      const float dv = Dm[j * ldD + k];
      l.K[(nu + j) * ldT + k] = dv;
      l.K[k * ldT + nu + j] = dv;
    }
    bar_sync<NT>();

    // P2: H = W·[A | f | B] + [Q S; · R], with q̂ = q + Aᵀ(Vf + v) and
    // r̂ = r + Bᵀ(Vf + v). A tile that holds column nx takes the product
    // the other way round, [A | f | B]ᵀ·Wᵀ (the same H, as MᵀVM is
    // symmetric, and Mᵀ(Vf + v) in column nx). Q̂|q̂ stays in the registers
    // of thread tid < nq; -Ŝᵀ and -r̂ go to rhs, R̂ to the KKT matrix.
    float qh[4][4];  // Q̂|q̂ on threads tid < nq, then [Vxx | vx]
#pragma unroll 1
    for (int i = 0; i < tt.n2; ++i) {
      const int code = opaque(at(tt.p2, i));
      const int a0 = tile_a0(code), c0 = tile_c0(code), kind = tile_kind(code);
      if (i > 0) ht = HatTerms(a0, c0, kind, s);
      float acc[4][4];
      if (i == 0) {
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = h0[ii][jj];
      } else {
        load_hat_terms(g, kt, ht, s, acc);
      }
      const bool swap = tile_swap(code);
      mm_kk<4, 4, false>(acc, swap ? Mc + a0 : Wt + a0, ldM, swap ? Wt + c0 : Mc + c0, ldM,
                         nx);
      // -Ŝᵀ to rhs (kind 1); R̂ to the KKT matrix and -r̂ to rhs (kind 2):
      // the entries inside the tile's block, as its terms' masks say
      if (kind == 1) {
        float* d = l.rhs + (c0 - cB) * ldV + a0;
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            if (ht.row(ii) && ht.col(jj)) d[jj * ldV + ii] = -acc[ii][jj];
      } else if (kind == 2) {
        float* d = l.K + (a0 - cB) * ldT + c0 - cB;
        float* e = l.rhs + (a0 - cB) * ldV + nx;
        const int jv = ht.jv();
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            if (ht.row(ii) && ht.col(jj)) d[ii * ldT + jj] = acc[ii][jj];
            if (ht.row(ii) && jj == jv) e[ii * ldV] = -acc[ii][jj];
          }
      }
      if (i == 0 && kind == 0) {
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) qh[ii][jj] = acc[ii][jj];
      }
    }
    bar_sync<NT>();

    // T = KKT⁻¹, stored transposed: l.T[c·ldT + r] = T(r, c). Warp 0
    // symmetrizes R̂ in the KKT matrix and inverts it; with no constraint
    // rows T = R̂⁻¹ and the chain writes it there directly.
    if (tid < 32) {
      if (nc > 0) warp_spd_inverse_rolled<NCH>(l.K, ldT, Rinv, ldS, 1, nu);
      else warp_spd_inverse_rolled<NCH>(l.K, ldT, l.T, 1, ldT, nu);
    }
    bar_sync<NT>();
    if (nc > 0) {
      for (int i = tid; i < nu * nc; i += NT) {
        const int r = dnc.q(i), c = i - r * nc;
        float acc = 0.f;
#pragma unroll 2
        for (int k = 0; k < nu; ++k) acc = fmaf(Rinv[r * ldS + k], Dm[c * ldD + k], acc);
        RiDt[r * ldS + c] = acc;  // R̂⁻¹Dᵀ
      }
      bar_sync<NT>();
      for (int i = tid; i < nc * nc; i += NT) {
        const int r = dnc.q(i), c = i - r * nc;
        float sij = 0.f, sji = 0.f;
#pragma unroll 2
        for (int k = 0; k < nu; ++k) {
          sij = fmaf(Dm[r * ldD + k], RiDt[k * ldS + c], sij);
          sji = fmaf(Dm[c * ldD + k], RiDt[k * ldS + r], sji);
        }
        const float dmu = r == c ? mu : 0.f;
        Ssym[r * ldS + c] = 0.5f * ((dmu + sij) + (dmu + sji));  // sym(µI + D R̂⁻¹Dᵀ)
      }
      bar_sync<NT>();
      if (tid < 32) warp_spd_inverse_rolled<NCH>(Ssym, ldS, Sinv, ldS, 1, nc);
      bar_sync<NT>();
      for (int i = tid; i < nu * nc + nc * nc; i += NT) {
        if (i < nu * nc) {
          const int r = dnc.q(i), c = i - r * nc;
          float acc = 0.f;
#pragma unroll 2
          for (int k = 0; k < nc; ++k) acc = fmaf(RiDt[r * ldS + k], Sinv[k * ldS + c], acc);
          U[r * ldS + c] = acc;
          l.T[(nu + c) * ldT + r] = acc;  // T(r, nu+c) = U
          l.T[r * ldT + nu + c] = acc;    // T(nu+c, r) = Uᵀ
        } else {
          const int r = dnc.q(i - nu * nc), c = i - nu * nc - r * nc;
          l.T[(nu + c) * ldT + nu + r] = -Sinv[r * ldS + c];
        }
      }
      bar_sync<NT>();
      for (int i = tid; i < nu * nu; i += NT) {
        const int r = dnu.q(i), c = i - r * nu;
        float acc = 0.f;
#pragma unroll 2
        for (int k = 0; k < nc; ++k) acc = fmaf(U[r * ldS + k], RiDt[c * ldS + k], acc);
        l.T[c * ldT + r] = Rinv[r * ldS + c] - acc;  // T11 = R̂⁻¹ - U·(R̂⁻¹Dᵀ)ᵀ
      }
      bar_sync<NT>();
    }

    // sol = T·rhs, then refine_steps rounds of sol += T·(rhs - KKT·sol);
    // the last round writes the gains
    float* K_t = K_o + kt * nu * nx;
    float* Z_t = Z_o + kt * nc * nx;
    for (int it = 0; it <= refine_steps; ++it) {
      if (it > 0) {
#pragma unroll 1
        for (int i = 0; i < tt.nsol; ++i) {
          const int code = opaque(at(tt.sol, i));
          const int i0 = tile_a0(code), j0 = tile_c0(code);
          float acc[4][4] = {};
          mm_kk<4, 4, false>(acc, l.K + i0, ldT, sol + j0, ldV, nk);
          // whole rows of 4: the pad columns past m stay zero (rhs's are)
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
            const int r = i0 + ii;
            if (r >= nk) break;
            const float4 b = *reinterpret_cast<const float4*>(l.rhs + r * ldV + j0);
            *reinterpret_cast<float4*>(res + r * ldV + j0) =
                make_float4(b.x - acc[ii][0], b.y - acc[ii][1], b.z - acc[ii][2],
                            b.w - acc[ii][3]);
          }
        }
        bar_sync<NT>();
      }
      const float* x = it > 0 ? res : l.rhs;
      const bool last = it == refine_steps;
#pragma unroll 1
      for (int i = 0; i < tt.nsol; ++i) {
        const int code = opaque(at(tt.sol, i));
        const int i0 = tile_a0(code), j0 = tile_c0(code);
        float acc[4][4] = {};
        mm_kk<4, 4, false>(acc, l.T + i0, ldT, x + j0, ldV, nk);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int r = i0 + ii;
          if (r >= nk) break;
          // a whole row of 4 of sol, read and written as one: the pad
          // columns past m stay zero (those of rhs and res are)
          float4* sp = reinterpret_cast<float4*>(sol + r * ldV + j0);
          float v[4] = {acc[ii][0], acc[ii][1], acc[ii][2], acc[ii][3]};
          if (it > 0) {
            const float4 o = *sp;
            v[0] = o.x + v[0], v[1] = o.y + v[1], v[2] = o.z + v[2], v[3] = o.w + v[3];
          }
          *sp = make_float4(v[0], v[1], v[2], v[3]);
          if (!last) continue;
          // the gains' row r: K or Z, and kff or zff in column nx
          float* row = r < nu ? K_t + r * nx : Z_t + (r - nu) * nx;
          float* ff = r < nu ? kff_o + kt * nu + r : zff_o + kt * nc + r - nu;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int c = j0 + jj;
            if (c < nx) row[c] = v[jj];
            else if (c == nx) *ff = v[jj];
          }
        }
      }
      bar_sync<NT>();
    }

    // [Vxx | vx] = [Q̂ | q̂] - rhsᵀ·sol on the threads holding Q̂, which
    // write each entry on and below the diagonal to both halves of V;
    // [Acl | yff] = [A | f] + B·[K | kff] on the others (zero at the
    // terminal knot). V is free after P1, and the next knot's barrier
    // orders these writes before its reads.
    if (tid < nq) {
      const int code = opaque(tt.p2[0]);
      const int a0 = tile_a0(code), c0 = tile_c0(code);
      mm_kk<4, 4, true>(qh, l.rhs + a0, ldV, sol + c0, ldV, nk);
      float* V_t = Vxx_o + kt * nx * nx;
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
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
    float* Acl_t = Acl_o + kt * nx * nx;
#pragma unroll 1
    for (int i = 0; i < tt.nacl; ++i) {
      const int code = opaque(at(tt.acl, i));
      const int i0 = tile_a0(code), j0 = tile_c0(code);
      // [A | f] by whole rows of 4 (its columns past m, up to cB, are zero)
      float acc[4][4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float4 a = i0 + ii < nx ? *reinterpret_cast<const float4*>(Mc + (i0 + ii) * ldM + j0)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
        acc[ii][0] = a.x, acc[ii][1] = a.y, acc[ii][2] = a.z, acc[ii][3] = a.w;
      }
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

// ---------------------------------------------------------------------------
// The compiled widths' cluster variant: one problem per thread-block cluster
// of cs blocks (cs in 2, 4, 8; blockIdx.x = problem · cs + rank), for
// batches that leave most SMs idle with a block per problem.
//
// What bounds it. A barrier of the cluster costs ~900 cycles (its release
// fence: the `.relaxed` arrive alone costs ~90) and each 16 bytes a thread
// moves through distributed shared memory several hundred, where a product
// pass of the knot takes 3,000-12,000 cycles on one SM: a design that
// exchanged each pass's tiles (six barriers and ~70 KB a knot) ran slower
// than one block at every cs. So the work is split by column strips of 4,
// strip q belonging to rank q % cs, such that a pass reads what the same
// rank wrote in the pass before: the Wᵀ strips and the rows of H (Q̂|q̂ and
// Ŝ) of the rank's A strips; the solve, residual and refinement of its
// strips of the solution's columns (the rhs strips its Ŝ tiles wrote);
// [Vxx | vx] of its A strips' lower Q̂ tiles and [Acl | yff] of its
// solution strips. Every rank forms the B strips of Wᵀ and the R̂|r̂ tiles
// itself (a tenth of the hats' work), so that the chains need nothing from
// the others. Two exchanges a knot remain, each a cluster barrier and then
// loads from the other blocks' shared memory (`gather`, ~16 KB in all):
// rhs's rows of -Ŝᵀ, which only [Vxx | vx] reads (the barrier arrives
// after the hats and waits after the solve: its latency hides behind the
// chains), and V before the next knot. The Gauss-Jordan chains (rolled)
// and the small factorization products (two items a thread side by side)
// run in every block on its own copy (the same inputs and instructions,
// the same bits). Vxx takes its product the other way round, Q̂ - (rhsᵀ·sol)ᵀ (the
// solution strip is the rank's own, rhs whole after the exchange);
// rhsᵀ·sol is symmetric up to rounding, so the outputs agree with one
// block per problem to rounding, and for a given cs bit for bit whatever
// the batch (every cs >= 2 forms each entry alike: the same bits at every
// size). At cs >= 2 every pass has at most 256 tiles a rank: one tile a
// thread, set up before the time loop.

// This thread's tile in each pass (a tile code, -1 for none) and the
// rank's Q̂ tiles, held by its threads tid < nq.
struct ClusterTiles {
  int p1, p2, sol, acl, nq;
};

template <class D>
__device__ ClusterTiles cluster_tiles(const D& s, int rank, int cs) {
  const int tid = threadIdx.x, nt = s.nt(), tq = s.tq(), cB = s.cB(), cF4 = s.cF4();
  const int sB = cB / 4, sE = sB + cdiv(s.nu(), 4);  // the B strips of [A | f | 0 | B]
  const int nrt = cdiv(s.m(), 4), nkt = cdiv(s.nk(), 4), ncs = s.ncs(), ncr = s.ncr();
  ClusterTiles ct{-1, -1, -1, -1, 0};
  // Wᵀ: every row tile of the rank's A strips and of every B strip (a0 the
  // strip)
  int u = tid;
  for (int q = rank; q < nt && ct.p1 < 0; q += cs) {
    if (u < nrt) ct.p1 = tile_code(4 * q, 4 * u);
    else u -= nrt;
  }
  for (int q = sB; q < sE && ct.p1 < 0; ++q) {
    if (u < nrt) ct.p1 = tile_code(4 * q, 4 * u);
    else u -= nrt;
  }
  // the hats: the Q̂ tiles on and below the diagonal and the q̂ tile of its A
  // strips first, then their Ŝ tiles, then the R̂|r̂ tiles of every B strip
  u = tid;
  for (int q = rank; q < nt; q += cs) {
    const int n = q + 2;
    if (ct.p2 < 0 && u < n) ct.p2 = tile_code(4 * q, u <= q ? 4 * u : 4 * tq, 0);
    else if (ct.p2 < 0) u -= n;
    ct.nq += n;
  }
  for (int q = rank; q < nt && ct.p2 < 0; q += cs) {
    if (u < ncs) ct.p2 = tile_code(4 * q, cB + 4 * u, 1);
    else u -= ncs;
  }
  for (int q = sB; q < sE && ct.p2 < 0; ++q) {
    if (u < ncr) ct.p2 = tile_code(4 * q, cF4 + 4 * u, 2);
    else u -= ncr;
  }
  // the solve passes and [Acl | yff]: the rank's strips of the solution's
  // columns [gain | ff] (a0 the row, c0 the strip); Acl past the Q̂ threads
  u = tid;
  for (int q = rank; q < nrt && ct.sol < 0; q += cs) {
    if (u < nkt) ct.sol = tile_code(4 * u, 4 * q);
    else u -= nkt;
  }
  u = tid - ct.nq;
  for (int q = rank; q < nrt && u >= 0 && ct.acl < 0; q += cs) {
    if (u < nt) ct.acl = tile_code(4 * u, 4 * q);
    else u -= nt;
  }
  return ct;
}

// After an exchange's cluster barrier: copies into this block's shared
// memory the granules (4 floats, 16-byte aligned) that other blocks wrote.
// `granule(i, owner)` gives the address of granule i < n, the same in every
// block, and sets the rank that wrote it. Four loads from the other blocks'
// shared memory are in flight before their stores.
template <class F>
__device__ __forceinline__ void gather(int n, int rank, F granule) {
#pragma unroll 1
  for (int i0 = threadIdx.x; i0 < n; i0 += 4 * kThreads) {
    float* dst[4];
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kThreads;
      int owner = rank;
      dst[u] = i < n ? granule(i, owner) : nullptr;
      if (owner == rank) dst[u] = nullptr;
      if (dst[u])
        v[u] = *reinterpret_cast<const float4*>(cg::cluster_group::map_shared_rank(dst[u], owner));
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (dst[u]) *reinterpret_cast<float4*>(dst[u]) = v[u];
  }
}

// item(i1, i2, two) for every i < n over the block's threads, two items a
// thread: i1 and i2 = i1 + 256 (i2 = i1 and two = false past n).
template <class F>
__device__ __forceinline__ void pairs(int n, F item) {
  for (int i = threadIdx.x; i < n; i += 2 * kThreads) {
    const int i2 = i + kThreads;
    item(i, i2 < n ? i2 : i, i2 < n);
  }
}

// a1 += Σ_k x1[k]·y1[k·sy] and a2 += Σ_k x2[k]·y2[k·sy] for k < n, each in
// the order of k (fmaf), the two chains side by side.
__device__ __forceinline__ void dot2(const float* x1, const float* y1, const float* x2,
                                     const float* y2, int sy, int n, float& a1, float& a2) {
#pragma unroll 2
  for (int k = 0; k < n; ++k) {
    a1 = fmaf(x1[k], y1[k * sy], a1);
    a2 = fmaf(x2[k], y2[k * sy], a2);
  }
}

// One block to an SM (at least kClusterSmemMin of shared memory each), so
// up to 255 registers a thread.
template <int NX, int NU, int NC>
__global__ void __launch_bounds__(kThreads, 1) riccati_backward_cluster(
    Knots g, const float* __restrict__ mu_all, float* __restrict__ K_o,
    float* __restrict__ Z_o, float* __restrict__ kff_o, float* __restrict__ zff_o,
    float* __restrict__ yff_o, float* __restrict__ Acl_o, float* __restrict__ Vxx_o,
    float* __restrict__ vx_o, int L, Dims<NX, NU, NC> s, int refine_steps, int cs) {
  static_assert(NX > 0 && NX % 4 == 0 && NU > 0 && NC >= 0,
                "the cluster variant takes compiled widths with nx a multiple of 4");
  using D = Dims<NX, NU, NC>;
  using Sm = Smem<D>;
  constexpr int kChainRolled = r4(imax(imax(NU, NC), 1));  // its rows: a multiple of 4
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Sm l = Sm::make(smem, s);
  const int nx = s.nx(), nu = s.nu(), nc = s.nc(), m = s.m(), nk = s.nk();
  const int ldV = s.ldV(), ldM = s.ldM(), ldD = s.ldD(), ldT = s.ldT(), ldS = s.ldS();
  const int cB = s.cB(), nt = s.nt(), tq = s.tq(), nrt = cdiv(m, 4);
  const int tid = threadIdx.x, rank = (int)cg::cluster_group::block_rank();
  const int b = (int)blockIdx.x / cs;
  const float mu = mu_all[b];
  const int kbuf = (int)(l.M[1] - l.M[0]);  // from one knot buffer to the other
  const ClusterTiles ct = cluster_tiles(s, rank, cs);

  // V = v = 0 and every pad zero; the terminal knot's [A | f | B] stays zero
  const int total = (int)Sm::floats(s);
  for (int i = tid; i < total; i += kThreads) smem[i] = 0.f;
  __syncthreads();
  {
    const int o = ((L - 1) & 1) * kbuf;
    issue_knot(g, (size_t)b * L + L - 1, true, l.M[0] + o, l.Cd[0] + o, l.Dm[0] + o, s);
    cp_async_commit();
  }

  float* Wt = l.work;                      // Wᵀ, (nx+1) × ldM
  float* sol = l.work;                     // nk × ldV
  float* res = l.work + nk * ldV + kSlack;  // nk × ldV
  const int fs = s.nf() * ldS;             // factorization scratch slots
  float* Rinv = l.work;
  float* RiDt = l.work + fs;
  float* Ssym = l.work + 2 * fs;
  float* Sinv = l.work + 3 * fs;
  float* U = l.work + 4 * fs;
  cg::cluster_group::barrier_arrive();  // the first knot's wait

  // the exchanges' granules: V (row r, strip q), from the rank of the lower
  // Q̂ tile that holds it (its own or its mirror's); rhs's rows of -Ŝᵀ
  // (strip q, from its A strip's rank)
  auto v_granule = [&](int i, int& owner) -> float* {
    const int r = i / nrt, q = i - r * nrt;
    owner = (q == tq ? r / 4 : imax(r / 4, q)) % cs;
    return l.V + r * ldV + 4 * q;
  };
  auto rhs_granule = [&](int i, int& owner) -> float* {
    const int k = i / nt, q = i - k * nt;
    owner = q % cs;
    return l.rhs + k * ldV + 4 * q;
  };

  for (int t = L - 1; t >= 0; --t) {
    const size_t kt = (size_t)b * L + t;
    const int o = (t & 1) * kbuf;
    const float* Mc = l.M[0] + o;
    const float* Cd = l.Cd[0] + o;
    const float* Dm = l.Dm[0] + o;

    // A hat tile's [Q S; · R] and [q; r] entries, from device memory.
    auto load_h = [&](int code, float (&h)[4][4]) {
      const int a0 = tile_a0(code), c0 = tile_c0(code), kind = tile_kind(code);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
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

    // this knot's buffer has arrived; after the block's barrier nobody reads
    // the other one (the previous knot's), so the next knot goes there.
    // Before the wait of the cluster barrier that the last knot arrived at
    // (its V written): the copies, this knot's KKT rows from [C | d] and D
    // (this block's memory only) and its hat terms; then the others' V.
    cp_async_wait_all();
    __syncthreads();
    if (t > 0) {
      const int on = ((t - 1) & 1) * kbuf;
      issue_knot(g, kt - 1, false, l.M[0] + on, l.Cd[0] + on, l.Dm[0] + on, s);
      cp_async_commit();
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
    float h0[4][4];
    if (ct.p2 >= 0) load_h(ct.p2, h0);  // consumed after Wᵀ: its latency hides behind it
    cg::cluster_group::barrier_wait();
    if (t < L - 1) gather(nx * nrt, rank, v_granule);
    __syncthreads();

    // Wᵀ = [V | v]ᵀ [A | f | B], the rank's strips
    if (ct.p1 >= 0) {
      const int a0 = tile_a0(ct.p1), c0 = tile_c0(ct.p1);
      float acc[4][4] = {};
      mm_kk<4, 4, false>(acc, l.V + c0, ldV, Mc + a0, ldM, nx);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
        if (c0 + ii < m)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) Wt[(c0 + ii) * ldM + a0 + jj] = acc[ii][jj];
    }
    __syncthreads();

    // H = W·[A | f | B] + [Q S; · R] on the rank's rows and every B row,
    // with q̂ = q + Aᵀv + AᵀVf and r̂ = r + Bᵀv + BᵀVf; Q̂|q̂ stays in
    // registers, -Ŝᵀ and -r̂ go to rhs, R̂ to the KKT matrix; then the
    // arrival of rhs's exchange
    float qh[4][4];
    if (ct.p2 >= 0) {
      const int a0 = tile_a0(ct.p2), c0 = tile_c0(ct.p2), kind = tile_kind(ct.p2);
      float acc[4][4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = h0[ii][jj];
      mm_kk<4, 4, false>(acc, Wt + a0, ldM, Mc + c0, ldM, nx);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int a = a0 + ii;
        const float mtv = Wt[nx * ldM + a];  // (Mᵀv)(a)
        const bool arow = a < nx, brow = a >= cB && a < cB + nu;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int c = c0 + jj;
          const bool bcol = c >= cB && c < cB + nu;
          const float v = acc[ii][jj] + (c == nx ? mtv : 0.f);  // q̂, r̂ take Mᵀv
          qh[ii][jj] = v;
          if (kind == 1 && arow && bcol) l.rhs[(c - cB) * ldV + a] = -v;  // -Ŝᵀ
          if (kind == 2 && brow && c == nx) l.rhs[(a - cB) * ldV + nx] = -v;  // -r̂
          if (kind == 2 && brow && bcol) l.K[(a - cB) * ldT + c - cB] = v;  // R̂
        }
      }
    }
    __syncthreads();
    cg::cluster_group::barrier_arrive();

    // T = KKT⁻¹, stored transposed: l.T[c·ldT + r] = T(r, c). Warp 0
    // symmetrizes R̂ in the KKT matrix and inverts it, by the rolled chain
    // (the same arithmetic as warp_spd_inverse in a few dozen instructions:
    // the loop body is larger than the instruction cache, and the unrolled
    // chain took 8,300-10,400 cycles here against 5,650-5,900 in the kernel
    // without a cluster); the small products two items a thread, R̂⁻¹Dᵀ with
    // its rows across the threads (no bank conflicts)
    if (tid < 32) warp_spd_inverse_rolled<kChainRolled>(l.K, ldT, Rinv, ldS, 1, nu);
    __syncthreads();
    if (nc > 0) {
      pairs(nu * nc, [&](int i1, int i2, bool two) {
        const int r1 = i1 % nu, c1 = i1 / nu, r2 = i2 % nu, c2 = i2 / nu;
        float a1 = 0.f, a2 = 0.f;
        dot2(Rinv + r1 * ldS, Dm + c1 * ldD, Rinv + r2 * ldS, Dm + c2 * ldD, 1, nu, a1, a2);
        RiDt[r1 * ldS + c1] = a1;  // R̂⁻¹Dᵀ
        if (two) RiDt[r2 * ldS + c2] = a2;
      });
      __syncthreads();
      pairs(nc * nc, [&](int i1, int i2, bool two) {
        const int r1 = i1 / nc, c1 = i1 % nc, r2 = i2 / nc, c2 = i2 % nc;
        float s1 = 0.f, s2 = 0.f, t1 = 0.f, t2 = 0.f;
        dot2(Dm + r1 * ldD, RiDt + c1, Dm + r2 * ldD, RiDt + c2, ldS, nu, s1, s2);
        dot2(Dm + c1 * ldD, RiDt + r1, Dm + c2 * ldD, RiDt + r2, ldS, nu, t1, t2);
        const float d1 = r1 == c1 ? mu : 0.f, d2 = r2 == c2 ? mu : 0.f;
        Ssym[r1 * ldS + c1] = 0.5f * ((d1 + s1) + (d1 + t1));  // sym(µI + D R̂⁻¹Dᵀ)
        if (two) Ssym[r2 * ldS + c2] = 0.5f * ((d2 + s2) + (d2 + t2));
      });
      __syncthreads();
      if (tid < 32) warp_spd_inverse_rolled<kChainRolled>(Ssym, ldS, Sinv, ldS, 1, nc);
      __syncthreads();
      pairs(nu * nc, [&](int i1, int i2, bool two) {
        const int r1 = i1 / nc, c1 = i1 % nc, r2 = i2 / nc, c2 = i2 % nc;
        float a1 = 0.f, a2 = 0.f;
        dot2(RiDt + r1 * ldS, Sinv + c1, RiDt + r2 * ldS, Sinv + c2, ldS, nc, a1, a2);
        U[r1 * ldS + c1] = a1;
        l.T[(nu + c1) * ldT + r1] = a1;  // T(r, nu+c) = U
        l.T[r1 * ldT + nu + c1] = a1;    // T(nu+c, r) = Uᵀ
        if (two) {
          U[r2 * ldS + c2] = a2;
          l.T[(nu + c2) * ldT + r2] = a2;
          l.T[r2 * ldT + nu + c2] = a2;
        }
      });
      for (int i = tid; i < nc * nc; i += kThreads) {
        const int r = i / nc, c = i % nc;
        l.T[(nu + c) * ldT + nu + r] = -Sinv[r * ldS + c];
      }
      __syncthreads();
    }
    pairs(nu * nu, [&](int i1, int i2, bool two) {
      const int r1 = i1 / nu, c1 = i1 % nu, r2 = i2 / nu, c2 = i2 % nu;
      float a1 = 0.f, a2 = 0.f;
      dot2(U + r1 * ldS, RiDt + c1 * ldS, U + r2 * ldS, RiDt + c2 * ldS, 1, nc, a1, a2);
      l.T[c1 * ldT + r1] = Rinv[r1 * ldS + c1] - a1;  // T11 = R̂⁻¹ - U·(R̂⁻¹Dᵀ)ᵀ
      if (two) l.T[c2 * ldT + r2] = Rinv[r2 * ldS + c2] - a2;
    });
    __syncthreads();

    // sol = T·rhs, then refine_steps rounds of sol += T·(rhs - KKT·sol), on
    // the rank's strips of the solution; the last round writes the gains
    // The gains go to device memory as the last round forms them, or at the
    // walk's widths (NC = 0) after the arrival below, whose release would
    // wait for them: there that was 4-5 % faster a sweep, at the bench's
    // widths 3 % slower (the tile held through [Vxx | vx] took 27 more
    // registers; chip_smoke.py's k1_cluster_check on an H100, PERF.md §6).
    const int i0 = tile_a0(ct.sol), j0 = tile_c0(ct.sol);
    float* K_t = K_o + kt * nu * nx;
    float* Z_t = Z_o + kt * nc * nx;
    auto gain_at = [&](int r, int c) {
      return r < nu ? (c < nx ? K_t + r * nx + c : kff_o + kt * nu + r)
                    : (c < nx ? Z_t + (r - nu) * nx + c : zff_o + kt * nc + r - nu);
    };
    float gain[4][4];
    for (int it = 0; it <= refine_steps; ++it) {
      if (it > 0) {
        if (ct.sol >= 0) {
          float acc[4][4] = {};
          mm_kk<4, 4, false>(acc, l.K + i0, ldT, sol + j0, ldV, nk);
          // whole rows of 4: the pad columns past m stay zero (rhs's are)
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
            const int r = i0 + ii;
            if (r >= nk) break;
            const float4 bv = *reinterpret_cast<const float4*>(l.rhs + r * ldV + j0);
            *reinterpret_cast<float4*>(res + r * ldV + j0) =
                make_float4(bv.x - acc[ii][0], bv.y - acc[ii][1], bv.z - acc[ii][2],
                            bv.w - acc[ii][3]);
          }
        }
        __syncthreads();
      }
      const float* x = it > 0 ? res : l.rhs;
      const bool last = it == refine_steps;
      if (ct.sol >= 0) {
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
            if constexpr (NC == 0) gain[ii][jj] = v;
            else *gain_at(r, c) = v;
          }
      }
      __syncthreads();
    }

    // the others' rows of -Ŝᵀ; then [Vxx | vx] = [Q̂ | q̂] - (rhsᵀ·sol)ᵀ on
    // the threads holding Q̂, which write each entry on and below the
    // diagonal to both halves of V, and the arrival at the cluster barrier
    // that the next knot waits at; [Acl | yff] = [A | f] + B·[K | kff] on
    // the rank's solution strips
    cg::cluster_group::barrier_wait();
    gather(nu * nt, rank, rhs_granule);
    __syncthreads();
    // (V's copies to device memory after the arrival: its release would
    // wait for them)
    const int a0 = tile_a0(ct.p2), c0 = tile_c0(ct.p2);
    if (tid < ct.nq) {
      mm_kk<4, 4, true>(qh, sol + a0, ldV, l.rhs + c0, ldV, nk);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int r = a0 + ii, c = c0 + jj;
          if (r >= nx) continue;
          if (c == nx) {
            l.V[r * ldV + nx] = qh[ii][jj];
          } else if (c < nx && (c0 < a0 || (c0 == a0 && c <= r))) {
            l.V[r * ldV + c] = qh[ii][jj];
            l.V[c * ldV + r] = qh[ii][jj];
          }
        }
    }
    cg::cluster_group::barrier_arrive();
    if constexpr (NC == 0) {
      if (ct.sol >= 0)
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            if (i0 + ii < nk && j0 + jj < m) *gain_at(i0 + ii, j0 + jj) = gain[ii][jj];
    }
    if (tid < ct.nq) {
      float* V_t = Vxx_o + kt * nx * nx;
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int r = a0 + ii, c = c0 + jj;
          if (r >= nx) continue;
          if (c == nx) {
            vx_o[kt * nx + r] = qh[ii][jj];
          } else if (c < nx && (c0 < a0 || (c0 == a0 && c <= r))) {
            V_t[r * nx + c] = qh[ii][jj];
            V_t[c * nx + r] = qh[ii][jj];
          }
        }
    }
    if (ct.acl >= 0) {
      const int ia = tile_a0(ct.acl), ja = tile_c0(ct.acl);
      float* Acl_t = Acl_o + kt * nx * nx;
      float acc[4][4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          acc[ii][jj] = (ia + ii < nx && ja + jj < m) ? Mc[(ia + ii) * ldM + ja + jj] : 0.f;
      mm_ik<4, 4>(acc, Mc + ia * ldM + cB, ldM, nx - ia, sol + ja, ldV, nu);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int r = ia + ii, c = ja + jj;
          if (r < nx && c < nx) Acl_t[r * nx + c] = acc[ii][jj];
          else if (r < nx && c == nx) yff_o[kt * nx + r] = acc[ii][jj];
        }
    }
  }
  cg::cluster_group::barrier_wait();  // no block leaves while another may still read it
}

// Host side: which instantiation serves which widths, the cluster size, the
// shared-memory limit, the launch.

constexpr int kMaxDevices = 64;

// The small-width classes: threads per block × chain length. Each takes the
// fewest threads that give every tile of a knot's largest pass its own
// thread (256 hold more than one), and the shortest chain >= max(nu, nc).
constexpr int kClassThreads[] = {32, 64, 128, 256};
constexpr int kClassChains[] = {8, 16, 32};
constexpr int kNumThreads = 4, kNumChains = 3, kNumSmall = kNumThreads * kNumChains;

// The cluster sizes the compiled widths launch with (1: the kernel without
// a cluster), and which of them the plan takes for the bench's and the
// walk's widths: those that chip_smoke.py's k1_cluster_check measured
// faster than one block per problem at every batch the card held them at,
// on an H100 80GB HBM3 at 700 W (fused_riccati.BACKWARD_CLUSTER_SIZES holds
// the same, with the run that set it).
constexpr int kClusters[] = {1, 2, 4, 8};
constexpr bool kClusterTaken[2][4] = {{true, true, true, true}, {true, false, true, true}};
// A block of the cluster variant takes at least this much dynamic shared
// memory, more than half of an SM's 228 KB: no two blocks share an SM.
constexpr size_t kClusterSmemMin = 116 * 1024;
// kernel_at indices: the two compiled widths, the small-width classes, then
// the compiled widths' cluster variant
constexpr int kClusterIndex = 2 + kNumSmall, kNumKernels = kClusterIndex + 2;

struct Launch {
  Knots g;
  const float* mu;
  float *K, *Z, *kff, *zff, *yff, *Acl, *Vxx, *vx;
  int batch, L;
  RtDims s;
  int refine_steps;
  size_t smem;
  cudaStream_t stream;
};

template <int NT, int NCH>
void launch_small(const Launch& a) {
  riccati_backward_small<NT, NCH><<<a.batch, NT, a.smem, a.stream>>>(
      a.g, a.mu, a.K, a.Z, a.kff, a.zff, a.yff, a.Acl, a.Vxx, a.vx, a.L, a.s, a.refine_steps);
}

// The compiled widths' kernel: one block per problem (cs = 1), or one
// cluster of cs blocks per problem, through cudaLaunchKernelEx.
template <int NX, int NU, int NC>
cudaError_t launch_compiled(const Launch& a, int cs) {
  const Dims<NX, NU, NC> s{a.s.rx, a.s.ru, a.s.rc};
  if (cs == 1) {
    riccati_backward_kernel<NX, NU, NC><<<a.batch, kThreads, a.smem, a.stream>>>(
        a.g, a.mu, a.K, a.Z, a.kff, a.zff, a.yff, a.Acl, a.Vxx, a.vx, a.L, s, a.refine_steps);
    return cudaSuccess;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.batch * cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = a.smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, riccati_backward_cluster<NX, NU, NC>, a.g, a.mu, a.K,
                            a.Z, a.kff, a.zff, a.yff, a.Acl, a.Vxx, a.vx, a.L, s,
                            a.refine_steps, cs);
}

// One entry per instantiation: 0 the bench's, 1 the walk's, 2 + c the
// small-width class c = (index of its threads) · 3 + (index of its chain),
// kClusterIndex + 0 and + 1 the bench's and the walk's cluster variant.
struct Kernel {
  const void* fn;
  int threads;
  void (*launch)(const Launch&);
};

template <int NT, int NCH>
Kernel small_kernel() {
  return {(const void*)&riccati_backward_small<NT, NCH>, NT, &launch_small<NT, NCH>};
}

const Kernel& kernel_at(int index) {
  static const Kernel table[kNumKernels] = {
      {(const void*)&riccati_backward_kernel<56, 22, 22>, kThreads, nullptr},
      {(const void*)&riccati_backward_kernel<56, 22, 0>, kThreads, nullptr},
      small_kernel<32, 8>(),   small_kernel<32, 16>(),  small_kernel<32, 32>(),
      small_kernel<64, 8>(),   small_kernel<64, 16>(),  small_kernel<64, 32>(),
      small_kernel<128, 8>(),  small_kernel<128, 16>(), small_kernel<128, 32>(),
      small_kernel<256, 8>(),  small_kernel<256, 16>(), small_kernel<256, 32>(),
      {(const void*)&riccati_backward_cluster<56, 22, 22>, kThreads, nullptr},
      {(const void*)&riccati_backward_cluster<56, 22, 0>, kThreads, nullptr},
  };
  return table[index];
}

// Which instantiation serves these widths, as the C entry reports it: 1 the
// bench's, 2 the walk's, 100·threads + chain for a small-width class; -1 if
// nu is not in 1..32 or nc not in 0..32 (a factor's rows are a warp's
// lanes), -2 if the Q̂ tiles (4 × 4 each) outnumber 256 threads (nx > 84).
int variant_of(int nx, int nu, int nc) {
  if (nu < 1 || nu > kChainMax || nc < 0 || nc > kChainMax) return -1;
  const RtDims s{nx, nu, nc};
  if (nx < 0 || s.nq() > kThreads) return -2;
  if (nx == 56 && nu == 22 && nc == 22) return 1;
  if (nx == 56 && nu == 22 && nc == 0) return 2;
  const int tiles = knot_tiles(s), chain = imax(nu, nc);
  int threads = kClassThreads[kNumThreads - 1];
  for (int t : kClassThreads)
    if (t >= tiles) {
      threads = t;
      break;
    }
  int len = kClassChains[kNumChains - 1];
  for (int c : kClassChains)
    if (c >= chain) {
      len = c;
      break;
    }
  return 100 * threads + len;
}

// The kernel_at index of a variant >= 1.
int index_of(int variant) {
  if (variant <= 2) return variant - 1;
  int ti = 0, ci = 0;
  while (kClassThreads[ti] != variant / 100) ++ti;
  while (kClassChains[ci] != variant % 100) ++ci;
  return 2 + ti * kNumChains + ci;
}

size_t smem_bytes(int nx, int nu, int nc) {
  return Smem<RtDims>::floats(RtDims{nx, nu, nc}) * sizeof(float);
}

// A block of the cluster variant: at least kClusterSmemMin.
size_t cluster_smem_bytes(int nx, int nu, int nc) {
  const size_t need = smem_bytes(nx, nu, nc);
  return need > kClusterSmemMin ? need : kClusterSmemMin;
}

cudaError_t ensure_smem_limit(int index, size_t smem);

// Clusters of cs blocks of kernel_at(index), with `smem` bytes a block,
// that the current device holds at once; a cudaError as a negative number.
int max_clusters(int index, int cs, size_t smem) {
  cudaError_t err = ensure_smem_limit(index, smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs);
  cfg.blockDim = dim3(kernel_at(index).threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel_at(index).fn, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// Clusters of cs blocks of a compiled variant's cluster kernel that the
// current device holds at once (0 if the runtime cannot say), asked once
// per device.
int device_clusters(int variant, int cs) {
  static int held[2][4][kMaxDevices] = {};
  int dev = 0, ci = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return 0;
  while (kClusters[ci] != cs) ++ci;
  int& n = held[variant - 1][ci][dev];
  if (n == 0) {
    const size_t smem = cluster_smem_bytes(56, 22, variant == 1 ? 22 : 0);
    n = max_clusters(kClusterIndex + variant - 1, cs, smem);
    if (n < 0) n = 0;
  }
  return n;
}

// The cluster size for `batch` problems of a variant: the largest of the
// sizes it takes (kClusterTaken) whose `batch` clusters the card holds at
// once, one block to an SM; 1 for the small-width classes. On a card of
// `sms` SMs it counts sms / cs clusters of cs; with sms = 0 it asks the
// current device (cudaOccupancyMaxActiveClusters: clusters live within one
// GPC, so an H100's 132 SMs hold 15 clusters of 8 and 30 of 4).
int cluster_of(int variant, int batch, int sms) {
  if (variant != 1 && variant != 2) return 1;
  int cs = 1;
  for (int i = 1; i < 4; ++i) {
    const int c = kClusters[i];
    if (kClusterTaken[variant - 1][i] && batch <= (sms > 0 ? sms / c : device_clusters(variant, c)))
      cs = c;
  }
  return cs;
}

// Whether the kernel of this variant launches with clusters of cs blocks.
bool takes_cluster(int variant, int cs) {
  if (variant != 1 && variant != 2) return cs == 1;
  for (int c : kClusters)
    if (c == cs) return true;
  return false;
}


// Raises an instantiation's dynamic shared-memory limit on the current
// device, once per device and only when `smem` is more than was set before.
cudaError_t ensure_smem_limit(int index, size_t smem) {
  static size_t smem_limit[kNumKernels][kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  size_t& lim = smem_limit[index][dev];
  if (smem > lim) {
    err = cudaFuncSetAttribute(kernel_at(index).fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    lim = smem;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs at these dims (a block per
// problem; a block of the cluster variant takes more, kClusterSmemMin).
long long riccati_backward_smem_bytes(int nx, int nu, int nc) {
  return (long long)smem_bytes(nx, nu, nc);
}

// Which instantiation serves these dims: 1 the bench widths (nx = 56,
// nu = nc = 22) and 2 the walk's (nx = 56, nu = 22, nc = 0), each fixed
// at compile time; 100·threads + chain for the small-width class that reads
// its widths at launch (fused_riccati.backward_plan says the same); -1 if
// nu is not in 1..32 or nc not in 0..32, -2 if nx > 84.
int riccati_backward_variant(int nx, int nu, int nc) { return variant_of(nx, nu, nc); }

// The cluster size of a launch of `batch` problems at these dims: 2, 4 or
// 8 at the compiled widths where the card holds that many clusters at
// once, else 1; counted on a card of `sms` SMs, or (sms = 0) on the current
// device, as a launch counts it (fused_riccati.backward_plan(...).cluster
// says the same); -1 for dims outside the kernel.
int riccati_backward_cluster(int nx, int nu, int nc, int batch, int sms) {
  const int variant = variant_of(nx, nu, nc);
  if (variant < 0) return -1;
  return cluster_of(variant, batch, sms > 0 ? sms : 0);
}

// Blocks of the kernel that one SM of the current device holds at once at
// these dims (the instantiation's threads and the shared memory above per
// block), as cudaOccupancyMaxActiveBlocksPerMultiprocessor gives it; a
// cudaError as a negative number.
int riccati_backward_blocks_per_sm(int nx, int nu, int nc) {
  const int variant = variant_of(nx, nu, nc);
  if (variant < 0) return -(int)cudaErrorInvalidValue;
  const Kernel& k = kernel_at(index_of(variant));
  const size_t smem = smem_bytes(nx, nu, nc);
  cudaError_t err = ensure_smem_limit(index_of(variant), smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k.fn, k.threads, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

// Clusters of cs blocks that the current device holds at once at these
// dims (cudaOccupancyMaxActiveClusters; cs = 1: blocks of the kernel
// without a cluster); a cudaError as a negative number.
int riccati_backward_max_clusters(int nx, int nu, int nc, int cs) {
  const int variant = variant_of(nx, nu, nc);
  if (variant < 0 || !takes_cluster(variant, cs)) return -(int)cudaErrorInvalidValue;
  if (cs == 1) return max_clusters(index_of(variant), 1, smem_bytes(nx, nu, nc));
  return max_clusters(kClusterIndex + variant - 1, cs, cluster_smem_bytes(nx, nu, nc));
}

// Launches the sweep on `stream`: one block per problem, or for the
// compiled widths one cluster of `cluster` blocks per problem (0: the size
// riccati_backward_cluster gives on this device; 1 the kernel without a
// cluster; 2, 4, 8). Returns cudaErrorInvalidValue for dims outside the
// kernel or a cluster size it does not take, else the launch's error and
// then cudaGetLastError(): a cluster launch the card refuses raises, with
// no retry at another size.
int riccati_backward_f32(const void* Q, const void* S, const void* R, const void* q,
                         const void* r, const void* A, const void* Bm, const void* f,
                         const void* C, const void* D, const void* d, const void* mu, void* K,
                         void* Z, void* kff, void* zff, void* yff, void* Acl, void* Vxx,
                         void* vx, int batch, int L, int nx, int nu, int nc, int refine_steps,
                         int cluster, void* stream) {
  const int variant = variant_of(nx, nu, nc);
  if (variant < 0) return (int)cudaErrorInvalidValue;
  const int cs = cluster == 0 ? cluster_of(variant, batch, 0) : cluster;
  if (!takes_cluster(variant, cs)) return (int)cudaErrorInvalidValue;
  const int index = cs > 1 ? kClusterIndex + variant - 1 : index_of(variant);
  const size_t smem = cs > 1 ? cluster_smem_bytes(nx, nu, nc) : smem_bytes(nx, nu, nc);
  cudaError_t err = ensure_smem_limit(index, smem);
  if (err != cudaSuccess) return (int)err;
  const Knots g{(const float*)Q, (const float*)S, (const float*)R, (const float*)q,
                (const float*)r, (const float*)A, (const float*)Bm, (const float*)f,
                (const float*)C, (const float*)D, (const float*)d};
  auto out = [](void* p) { return (float*)p; };
  const Launch a{g, (const float*)mu, out(K), out(Z), out(kff), out(zff), out(yff), out(Acl),
                 out(Vxx), out(vx), batch, L, RtDims{nx, nu, nc}, refine_steps, smem,
                 (cudaStream_t)stream};
  if (variant == 1) err = launch_compiled<56, 22, 22>(a, cs);
  else if (variant == 2) err = launch_compiled<56, 22, 0>(a, cs);
  else kernel_at(index).launch(a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
