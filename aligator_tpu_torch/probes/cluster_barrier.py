"""What a thread-block cluster's barrier and its distributed shared memory
cost on the card: the floor under a knot of K1's cluster variant, which
keeps about one cluster barrier per phase.

Launches one cluster of C blocks (256 threads each, as K1) per problem,
for B problems, through ``cudaLaunchKernelEx`` with the cluster attribute,
and times inside the kernel a loop of

* ``__syncthreads()`` (the block's barrier, for scale);
* ``cluster.sync()`` (``barrier.cluster.arrive.release`` and
  ``barrier.cluster.wait.acquire``);
* a round trip through distributed shared memory: every thread stores a
  value into the next rank's shared memory, the cluster waits at its
  barrier, and every thread loads it back from there (a remote load) and
  uses it in the next store;
* the cluster barrier in PTX: ``barrier.cluster.arrive.release`` and
  ``wait.acquire``, and the ``.relaxed`` arrive (which orders no memory);
* a cluster barrier built from mbarriers: the block's ``__syncthreads``,
  then thread r arrives (``mbarrier.arrive.release.cluster``) on the
  mbarrier of rank r, and every thread waits (``try_wait.parity.acquire``)
  on its own block's; alone, and around the round trip above;
* 16 floats a thread moved into the next rank's shared memory before each
  cluster barrier, by generic or ``st.shared::cluster`` stores, scalar or
  float4, or pulled from it by float4 ``ld.shared::cluster`` loads.

Each block reads ``%globaltimer`` (ns) and ``clock64()`` around its loop
and records ``%smid``. Prints µs and cycles per iteration, averaged over
the blocks, whether any two blocks of a cluster shared an SM, and
``cudaOccupancyMaxActiveClusters`` at that shared memory per block. The
default shared memory is K1's at the bench widths (113,440 B, two blocks
on an SM); ``--smem`` takes others (e.g. 120000, one block on an SM).

Run on a machine with a CUDA card::

    python -m aligator_tpu_torch.probes.cluster_barrier [--clusters 2 4 8]
        [--batch 1 16] [--smem 113440 120000] [--iters 20000]
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
import sys

import torch

from aligator_tpu_torch.utils import cuda_build

SOURCE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

// out[block * 4 + {0, 1, 2}] = ns, cycles of the loop, the block's SM
__global__ void __launch_bounds__(256, 2) cluster_loop(long long* out, int iters, int mode) {
  extern __shared__ float buf[];
  cg::cluster_group cl = cg::this_cluster();
  const int tid = threadIdx.x;
  __shared__ unsigned long long bar;  // the mbarrier of modes 5 and 6
  const unsigned bar_addr = (unsigned)__cvta_generic_to_shared(&bar);
  buf[tid] = 0.f;
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar_addr), "r"(cl.num_blocks()));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cl.sync();
  float* peer = cl.map_shared_rank(buf, (int)((cl.block_rank() + 1) % cl.num_blocks()));
  float v = (float)tid;
  long long g0, g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  const long long c0 = clock64();
  if (mode == 0) {
    for (int i = 0; i < iters; ++i) __syncthreads();
  } else if (mode == 1) {
    for (int i = 0; i < iters; ++i) cl.sync();
  } else if (mode == 2) {
    for (int i = 0; i < iters; ++i) {
      peer[tid] = v;
      cl.sync();
      v = peer[tid] + 1.f;
      cl.sync();
    }
  } else if (mode == 3) {
    for (int i = 0; i < iters; ++i) {
      asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
      asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    }
  } else if (mode == 4) {
    for (int i = 0; i < iters; ++i) {
      asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
      asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    }
  } else if (mode >= 7) {
    // 16 floats a thread into (or, mode 11, out of) the next rank's memory
    // between two cluster barriers: generic scalar stores (7), scalar
    // st.shared::cluster (8), generic float4 stores (9), float4
    // st.shared::cluster (10), float4 ld.shared::cluster copied into this
    // block's memory (11)
    const unsigned rank1 = (cl.block_rank() + 1) % cl.num_blocks();
    const unsigned base = (unsigned)__cvta_generic_to_shared(buf + 16 * tid);
    unsigned rbase;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rbase) : "r"(base), "r"(rank1));
    float* gp = cl.map_shared_rank(buf + 16 * tid, (int)rank1);
    for (int i = 0; i < iters; ++i) {
      if (mode == 7) {
#pragma unroll
        for (int k = 0; k < 16; ++k) gp[k] = v + k;
      } else if (mode == 8) {
#pragma unroll
        for (int k = 0; k < 16; ++k)
          asm volatile("st.shared::cluster.f32 [%0], %1;\n"
                       :: "r"(rbase + 4 * k), "f"(v + k) : "memory");
      } else if (mode == 9) {
#pragma unroll
        for (int k = 0; k < 16; k += 4)
          *reinterpret_cast<float4*>(gp + k) = make_float4(v, v + 1, v + 2, v + k);
      } else if (mode == 10) {
#pragma unroll
        for (int k = 0; k < 16; k += 4)
          asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n"
                       :: "r"(rbase + 4 * k), "f"(v), "f"(v + 1), "f"(v + 2), "f"(v + k)
                       : "memory");
      } else {
        float4 t[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                       : "=f"(t[k].x), "=f"(t[k].y), "=f"(t[k].z), "=f"(t[k].w)
                       : "r"(rbase + 16 * k) : "memory");
#pragma unroll
        for (int k = 0; k < 4; ++k) reinterpret_cast<float4*>(buf + 4096 + 16 * tid)[k] = t[k];
        __syncthreads();
        v += buf[4096 + 16 * tid + (i & 15)];
      }
      cl.sync();
    }
  } else {
    // the block's barrier, then thread r arrives (release, cluster scope) on
    // rank r's mbarrier, and every thread waits (acquire) on its own
    const unsigned nb = cl.num_blocks();
    unsigned parity = 0;
    for (int i = 0; i < iters; ++i) {
      if (mode == 6) peer[tid] = v;
      __syncthreads();
      if (tid < nb) {
        unsigned remote;
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                     : "=r"(remote) : "r"(bar_addr), "r"(tid));
        asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
                     :: "r"(remote) : "memory");
      }
      unsigned done = 0;
      while (!done)
        asm volatile("{\n .reg .pred p;\n"
                     " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
                     " selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(bar_addr), "r"(parity) : "memory");
      parity ^= 1;
      if (mode == 6) v = peer[tid] + 1.f;
    }
  }
  const long long c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  unsigned sm;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
  if (tid == 0) {
    const int b = blockIdx.x;
    out[b * 4] = g1 - g0;
    out[b * 4 + 1] = c1 - c0;
    out[b * 4 + 2] = sm;
    out[b * 4 + 3] = (long long)v;
  }
  cl.sync();  // no block leaves while another may still read its memory
}

extern "C" int cluster_probe_run(long long* out, int batch, int clusters, int iters, int mode,
                                 int smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(cluster_loop,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * clusters);
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = clusters;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, cluster_loop, out, iters, mode);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int cluster_probe_max_active(int clusters, int smem) {
  cudaError_t err = cudaFuncSetAttribute(cluster_loop,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters);
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = clusters;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, cluster_loop, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}
"""

MODES = ("__syncthreads", "cluster.sync", "DSMEM store, cluster.sync, remote load, cluster.sync",
         "barrier.cluster.arrive.release + wait.acquire (aligned)",
         "barrier.cluster.arrive.relaxed + wait (aligned; orders no memory)",
         "__syncthreads + mbarrier arrive.release.cluster on each rank + try_wait.acquire",
         "DSMEM store, the mbarrier barrier of mode 5, remote load",
         "16 generic scalar stores into the next rank, cluster.sync",
         "16 scalar st.shared::cluster into the next rank, cluster.sync",
         "4 generic float4 stores into the next rank, cluster.sync",
         "4 float4 st.shared::cluster into the next rank, cluster.sync",
         "4 float4 ld.shared::cluster from the next rank, local copy, __syncthreads, "
         "cluster.sync")
K1_BENCH_SMEM = 113440
_I, _P = ctypes.c_int, ctypes.c_void_p


def build() -> ctypes.CDLL:
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha256(SOURCE.encode()).hexdigest()[:12]
    cu = cuda_build.BUILD_DIR / f"cluster_barrier-{digest}.cu"
    so = cu.with_suffix(".so")
    if not so.exists():
        cu.write_text(SOURCE)
        r = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed on the cluster probe:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.cluster_probe_run.argtypes = [_P] + [_I] * 5 + [_P]
    lib.cluster_probe_run.restype = _I
    lib.cluster_probe_max_active.argtypes = [_I, _I]
    lib.cluster_probe_max_active.restype = _I
    return lib


def run(lib, B: int, C: int, iters: int, mode: int, smem: int, dev) -> dict:
    """µs and cycles per iteration (mean over the blocks), and whether two
    blocks of one cluster sat on one SM."""
    out = torch.zeros(B * C * 4, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for n in (min(iters, 100), iters):  # a warm-up launch, then the timed one
        err = lib.cluster_probe_run(out.data_ptr(), B, C, n, mode, smem, stream)
        if err != 0:
            raise RuntimeError(f"cluster probe launch failed: cudaError {err}")
        torch.cuda.synchronize()
    h = out.view(B * C, 4).cpu()
    sms = h[:, 2].view(B, C)
    shared = any(len(set(row.tolist())) < C for row in sms)
    return dict(us=float(h[:, 0].double().mean()) / iters / 1e3,
                cycles=float(h[:, 1].double().mean()) / iters, shared_sm=shared,
                sms=sorted(set(h[:, 2].tolist())))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clusters", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 16])
    ap.add_argument("--smem", type=int, nargs="+", default=[K1_BENCH_SMEM])
    ap.add_argument("--iters", type=int, default=20000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("cluster_barrier: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    lib = build()
    for smem in args.smem:
        for C in args.clusters:
            print(f"cluster barrier, C={C}, {smem} B of shared memory per block: "
                  f"cudaOccupancyMaxActiveClusters {lib.cluster_probe_max_active(C, smem)}")
            for B in args.batch:
                for mode, what in enumerate(MODES):
                    r = run(lib, B, C, args.iters, mode, smem, dev)
                    print(f"  B={B} C={C} {what}: {r['us']:.4f} us, {r['cycles']:.1f} cycles per "
                          f"iteration; two blocks of a cluster on one SM: {r['shared_sm']} "
                          f"({len(r['sms'])} SMs used)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
