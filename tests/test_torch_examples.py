"""The port's examples (slice 5) against the repository's JAX examples in
float64 on the CPU: each ``create_*`` builds the same problem in both
packages (horizon, widths, constraint stacks, x0), and the port's
``proxddp_solve`` on it matches ``jax.jit(proxddp_solve)`` with the JAX
example's own settings: equal ``conv`` and iteration counts, xs and us
to 1e-9·max(1, max|ref|). This file holds the cheap examples (the LQR
with its bounds and with its terminal constraint, the SE(2) car, the
cartpole), solved to convergence; the multibody ones are in
``test_torch_examples_*.py``."""

import numpy as np
import pytest
import torch

import jax

from aligator_tpu.solvers import ProxDDPSettings as JSettings
from aligator_tpu.solvers import proxddp_solve as jax_solve

from aligator_tpu_torch.solvers import ProxDDPSettings, proxddp_solve

torch.set_num_threads(1)

TOL = 1e-9


def same_problem(jp, tp):
    """The two builders' problems have the same horizon, widths,
    constraint stacks and x0."""
    assert (tp.nsteps, tp.ndx, tp.nu, tp.nc, tp.nc_term) == (
        jp.nsteps, jp.ndx, jp.nu, jp.nc, jp.nc_term)
    assert tp.constraint_dims == tuple(jp.constraint_dims)
    assert [type(s).__name__ for s in tp.constraint_sets] == [
        type(s).__name__ for s in jp.constraint_sets]
    np.testing.assert_array_equal(tp.x0.numpy(), np.asarray(jp.x0))


def solve_both(jp, tp, **settings):
    """(JAX result, port result) of the same solve."""
    same_problem(jp, tp)
    s = JSettings(**settings)
    ref = jax.jit(lambda p: jax_solve(p, s))(jp)
    return ref, proxddp_solve(tp, ProxDDPSettings(**settings))


def check_same_solve(ref, res, tol=TOL, conv=None):
    """Equal ``conv`` (and equal to ``conv`` when given) and iterations,
    xs and us within ``tol``·max(1, max|ref|); the measured errors are
    printed (``pytest -s``)."""
    errs = {}
    for name in ("xs", "us"):
        a, b = getattr(res, name).numpy(), np.asarray(getattr(ref, name))
        errs[name] = float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))
    print(f"port vs JAX: conv {bool(res.conv)} / {bool(ref.conv)}, iterations "
          f"{int(res.num_iters)} / {int(ref.num_iters)}, max|dxs| {errs['xs']:.3e}, "
          f"max|dus| {errs['us']:.3e} (relative to max(1, max|.|))")
    assert bool(res.conv) == bool(ref.conv)
    if conv is not None:
        assert bool(ref.conv) is conv
    assert int(res.num_iters) == int(ref.num_iters)
    for name, err in errs.items():
        assert err <= tol, f"{name}: {err:.3e}"


@pytest.mark.parametrize("variant", ["bounds", "term_cstr"])
def test_lqr_matches_jax(variant):
    from examples.lqr import create_lqr_problem as jax_lqr

    from aligator_tpu_torch.examples.lqr import create_lqr_problem

    bounds, term = variant == "bounds", variant == "term_cstr"
    ref, res = solve_both(jax_lqr(bounds, term), create_lqr_problem(bounds, term, device="cpu"),
                          tol=1e-8, mu_init=2e-3 if bounds else 1e-7, max_iters=20)
    check_same_solve(ref, res, conv=True)
    if bounds:
        assert float(res.us.abs().max()) <= 0.18 + 1e-8


def test_se2_car_matches_jax():
    from examples.se2_car import create_se2_problem as jax_se2

    from aligator_tpu_torch.examples.se2_car import create_se2_problem

    ref, res = solve_both(jax_se2(40), create_se2_problem(40, device="cpu"), tol=1e-6,
                          mu_init=1e-2, max_iters=100)
    check_same_solve(ref, res, conv=True)


def test_cartpole_matches_jax():
    from examples.cartpole import create_cartpole_problem as jax_cartpole

    from aligator_tpu_torch.examples.cartpole import create_cartpole_problem

    ref, res = solve_both(jax_cartpole(), create_cartpole_problem(device="cpu"), tol=1e-3,
                          mu_init=1e-2, max_iters=300)
    check_same_solve(ref, res, conv=True)
    # upright at the end; the bound holds to the solve's primal tolerance
    assert abs(float(res.xs[-1, 1]) - np.pi) < 0.1 and float(res.us.abs().max()) <= 5.0 + 1e-3


@pytest.mark.parametrize("name", ["lqr", "se2_car", "cartpole", "acrobot", "ur5_reach",
                                  "ur5_obstacle", "quadrotor_obstacles", "ur5_ballistic"])
def test_example_builders_without_device_raise_on_a_cpu_only_host(name):
    """``device=None`` means the card: without one the builders raise
    rather than carry on on the CPU."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    mod = importlib.import_module(f"aligator_tpu_torch.examples.{name}")
    create = next(getattr(mod, n) for n in dir(mod) if n.startswith("create_"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create(40) if name == "se2_car" else create()
