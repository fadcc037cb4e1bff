"""The port's main path end to end at small size, against the JAX package:
the lqr bench problem made by chip_smoke.lqr_bench_arrays at nx = 8,
nu = nc = 4, N = 10, a batch of 4, a 2-iteration ProxDDP solve with
lq_solver="pallas" (the fused path; here on the CPU its plain versions),
then 3 MPC steps — in float64, so both sides agree to rounding (1e-7).
Also: the package and chip_smoke.py import neither JAX nor the JAX
package, and chip_smoke.py fails without a CUDA device."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aligator_tpu import constraints as JS
from aligator_tpu import costs as JC
from aligator_tpu import manifolds as JM
from aligator_tpu import mpc as JMPC
from aligator_tpu.dynamics import LinearDiscreteDynamics
from aligator_tpu.functions import ControlErrorResidual
from aligator_tpu.problem import build_problem
from aligator_tpu.solvers import ProxDDPSettings as JSettings
from aligator_tpu.solvers import proxddp_solve

import chip_smoke
from aligator_tpu_torch import mpc as TMPC
from aligator_tpu_torch.convert import problem_from_numpy
from aligator_tpu_torch.solvers import ProxDDPSettings, proxddp_solve as port_solve

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NX, NU, N, BATCH = 8, 4, 10, 4
TOL = 1e-7
SETTINGS = dict(tol=1e-7, mu_init=1e-2, max_iters=2, max_al_iters=2, lq_solver="pallas")


def _jax_problem(a):
    t = jnp.asarray
    return build_problem(
        JM.VectorSpace(NX), NU, N, t(a["x0"]),
        LinearDiscreteDynamics(A=t(a["A"]), B=t(a["B"]), c=t(a["c"])),
        JC.QuadraticCost.create(t(a["Q"]), t(a["R"])),
        JC.QuadraticCost.create(t(a["Qf"]), t(a["R"])),
        constraints=((ControlErrorResidual(target=jnp.zeros(NU)),
                      JS.BoxConstraint(lower=tuple(a["lower"]), upper=tuple(a["upper"])),
                      NU),),
    )


def _port_problem(a, x0s):
    return problem_from_numpy(a["A"], a["B"], a["c"], a["Q"], a["R"], a["Qf"], x0s, N,
                              a["lower"], a["upper"], device="cpu", dtype=torch.float64)


def _close(port, ref, name):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=TOL, rtol=0,
                               err_msg=name)


def test_slice_solve_and_mpc_steps_match_jax():
    arrays = chip_smoke.lqr_bench_arrays(NX, NU, seed=0)
    x0s = chip_smoke.batch_x0(BATCH, NX)
    jprob = _jax_problem(arrays)

    # the batched 2-iteration solve (bench.py:102-121 at small size)
    res_j = jax.jit(jax.vmap(lambda x0: proxddp_solve(
        jprob.replace_x0(x0), JSettings(**SETTINGS))))(jnp.asarray(x0s))
    res_t = port_solve(_port_problem(arrays, x0s), ProxDDPSettings(**SETTINGS))
    for name in ("xs", "us", "vs", "lams"):
        _close(getattr(res_t, name), getattr(res_j, name), name)
    for name in ("conv", "num_iters", "al_iter"):
        np.testing.assert_array_equal(getattr(res_t, name).numpy(),
                                      np.asarray(getattr(res_j, name)), err_msg=name)

    # three receding-horizon steps from the cold start
    jstep = jax.jit(jax.vmap(
        lambda x, st: JMPC.mpc_step(jprob, JSettings(**SETTINGS), x, st)[:2]))
    st0 = JMPC.init_mpc_state(jprob)
    jstate = jax.tree.map(lambda a: jnp.broadcast_to(a, (BATCH,) + a.shape), st0)
    tprob = _port_problem(arrays, np.tile(arrays["x0"], (BATCH, 1)))
    tstate = TMPC.init_mpc_state(tprob)
    rng = np.random.default_rng(3)
    for k in range(3):
        x = 0.1 * rng.standard_normal((BATCH, NX))
        u_j, jstate = jstep(jnp.asarray(x), jstate)
        u_t, tstate, res, tprob = TMPC.mpc_step(
            tprob, ProxDDPSettings(**SETTINGS), torch.as_tensor(x), tstate)
        _close(u_t, u_j, f"u, step {k}")
        for name in ("xs", "us", "vs", "lams"):
            _close(getattr(tstate, name), getattr(jstate, name), f"{name}, step {k}")


def test_cycle_problem_rolls_the_time_axis():
    arrays = chip_smoke.lqr_bench_arrays(NX, NU, seed=0)
    st = lambda a: np.stack([a, 2 * a])
    prob = problem_from_numpy(st(arrays["A"]), st(arrays["B"]), st(arrays["c"]),
                              arrays["Q"], arrays["R"], arrays["Qf"],
                              np.zeros((2, NX)), N, device="cpu")
    A = prob.dynamics.A.clone()
    A[:, 0] += 1.0  # make stage 0 distinguishable
    prob = prob.replace(dynamics=prob.dynamics.__class__(A=A, B=prob.dynamics.B,
                                                         c=prob.dynamics.c))
    cyc = TMPC.cycle_problem(prob)
    assert torch.equal(cyc.dynamics.A[:, -1], A[:, 0])
    assert torch.equal(cyc.dynamics.A[:, 0], A[:, 1])


_GUARD = """
import sys, pkgutil, importlib
sys.path.insert(0, {root!r})
import aligator_tpu_torch
for m in pkgutil.walk_packages(aligator_tpu_torch.__path__, "aligator_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = [m for m in sys.modules
       if m in ("jax", "aligator_tpu") or m.startswith(("jax.", "aligator_tpu."))]
print("FORBIDDEN", bad)
sys.exit(1 if bad else 0)
"""


def test_port_and_chip_smoke_import_no_jax():
    out = subprocess.run([sys.executable, "-c", _GUARD.format(root=ROOT)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No CUDA device: non-zero exit and no result line; alone in a
    directory without the repository: non-zero exit."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH="")
    here = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert here.returncode != 0 and '"ok"' not in here.stdout
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    alone = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                           capture_output=True, text=True, timeout=120)
    assert alone.returncode != 0 and '"ok"' not in alone.stdout
