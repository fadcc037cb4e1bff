"""K1's small classes at nu = nc = 17 and 32, µ = 1e-6, float32, against the
JAX Pallas kernel: a scan over random problems on the CPU (ROADMAP C16).

For each width and seed (B = 4, N = 6, ``chip_smoke.random_lq_arrays``'s
draws), the JAX kernel runs in interpret mode, the port's CUDA source under
``tests/cuda_emulation.py`` and the plain recursion in float32 and float64.
Printed per problem: whether each kernel's gains K and kff are finite, and
the relative error max|·−f64|/max|f64| of each (the plain recursion's
beside them); then, per width, the problems where the two kernels agree on
breaking down. ``test_torch_k1_emulated.py`` pins two of these cases.

Run from the repository root (~2 min on one core)::

    JAX_PLATFORMS=cpu python tests/k1_reference_scan.py [--seeds 6]
"""

import argparse
import ctypes
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import cuda_emulation as E  # noqa: E402
import test_torch_k1_emulated as K  # noqa: E402
from aligator_tpu import gar as JG  # noqa: E402
from aligator_tpu.gar import pallas_riccati as PR  # noqa: E402
from aligator_tpu.gar import riccati as JR  # noqa: E402
from aligator_tpu_torch.gar import fused_riccati as FR  # noqa: E402
from aligator_tpu_torch.utils import cuda_build  # noqa: E402

WIDTHS = ((8, 17), (20, 17), (8, 32))  # (nx, nu = nc)
B, N, MU = 4, 6, 1e-6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=6)
    args = ap.parse_args()
    torch.set_num_threads(1)
    lib = ctypes.CDLL(str(E.build(cuda_build.CSRC / "riccati_backward.cu",
                                  Path(tempfile.mkdtemp()))))
    lib.riccati_backward_f32.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    lib.riccati_backward_f32.restype = ctypes.c_int
    for nx, nu in WIDTHS:
        agree = total = 0
        for seed in range(args.seeds):
            arrays = K._random_arrays(B, N, nx, nu, nu, seed)
            probs = [JG.LQRProblem(**{f: jnp.asarray(a[b], jnp.float32)
                                      for f, a in arrays.items()}) for b in range(B)]
            jk = jax.tree.map(lambda *a: jnp.stack(a), *[JR.knots_of(p) for p in probs])
            gj, _ = PR.backward_sweep_batched(jk, jnp.full((B,), MU, jnp.float32))
            knots = K._random_lq(B, N, nx, nu, nu, seed)
            mus = torch.full((B,), MU)
            port = K._run(lib, knots, mus, 1)
            plain, _ = FR.backward_sweep_batched_ref(knots, mus)
            exact, _ = FR.backward_sweep_batched_ref(
                K._random_lq(B, N, nx, nu, nu, seed, torch.float64), mus.double())
            ref = {n: getattr(exact, n).numpy() for n in ("K", "kff")}
            gains = {"jax": {n: np.asarray(getattr(gj, n)) for n in ("K", "kff")},
                     "port": {n: port[n].numpy() for n in ("K", "kff")},
                     "plain": {n: getattr(plain, n).numpy() for n in ("K", "kff")}}
            fin = {k: K._finite(g["K"]) & K._finite(g["kff"]) for k, g in gains.items()}
            err = {k: K._rel_err(g, ref) for k, g in gains.items()}
            for b in range(B):
                print(f"nx={nx} nu=nc={nu} seed={seed} problem {b}: " + ", ".join(
                    f"{k} {'finite' if fin[k][b] else 'broken'} {err[k][b]:.2e}"
                    for k in ("jax", "port", "plain")))
            agree += int((fin["jax"] == fin["port"]).sum())
            total += B
        print(f"nx={nx} nu=nc={nu}: the kernels agree on breaking down in {agree} of "
              f"{total} problems")
    return 0


if __name__ == "__main__":
    sys.exit(main())
