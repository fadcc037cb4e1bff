"""The port's solo-12 jump (slice 6) against the repository's JAX example
in float64 on the CPU.

- At its published size (contact dynamics with a flight phase, ndx = 36,
  nu = 12, N = 45): the built problems are the same (``same_problem``,
  the contact schedule and landing weights), and one
  ``compute_derivatives`` at x0 and at a seeded trajectory is within
  1e-10·max(1, max|ref|) of the JAX pass.
- In the slow tier: the full f64 solve against ``jax.jit(proxddp_solve)``
  (259 s of JAX on the CPU, 89 iterations), whose iterations amplify
  rounding (ROADMAP C12): the first 10 iterates to 1e-8, the costs to
  1e-3 and both outcomes; and the float32 fused batch of 4 scenarios
  against ``jax.vmap(proxddp_solve)`` through the Pallas kernels in
  interpret mode (ROADMAP C13).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from aligator_tpu.solvers import ProxDDPSettings as JSettings
from aligator_tpu.solvers import proxddp_solve as jax_solve

from aligator_tpu_torch.examples import solo_jump as TJ
from aligator_tpu_torch.solvers import ProxDDPSettings, proxddp_solve
from test_torch_contact_centroidal import check_derivs
from test_torch_examples import same_problem
from test_torch_examples_legged import _derivs_at_x0_and_seeded

torch.set_num_threads(1)


def _jump():
    from examples.solo_jump import create_jump_problem as jax_jump

    jp, jm, jk = jax_jump()
    tp, tm, tk = TJ.create_jump_problem(device="cpu")
    assert jk == tk == (20, 30)
    return jp, (tp, tm, tk)


def test_jump_problem_and_derivative_pass_match_jax():
    """The contact schedule (every foot off over stages 20-29) and the
    landing weights stamped as in the JAX example; the derivative pass of
    the contact dynamics with the flight phase."""
    jp, (tp, model, _) = _jump()
    same_problem(jp, tp)
    assert (tp.nsteps, tp.space.nx, tp.ndx, tp.nu, tp.nc) == (45, 37, 36, 12, 0)
    np.testing.assert_array_equal(tp.dynamics.ode.contacts.active[0].numpy(),
                                  np.asarray(jp.dynamics.ode.contacts.active))
    for tw, jw in zip(tp.cost.weights, jp.cost.weights):
        np.testing.assert_array_equal(tw.expand(1, tp.nsteps)[0].numpy(),
                                      np.broadcast_to(np.asarray(jw), (tp.nsteps,)))
    err = check_derivs(jp, tp, *_derivs_at_x0_and_seeded(jp, tp, 1), 1e-10, "jump")
    print(f"jump: derivative pass max rel err {err:.3e}")


@pytest.mark.slow
def test_jump_solve_against_jax_is_rounding_amplified():
    """The jump's full f64 solve in both packages (ROADMAP C12, reference
    behaviour). Both converge and both jump (apex above the start by more
    than 0.04 m, the end within 0.08 m of it); the iterates of the first
    10 iterations agree to 1e-8·max(1, max|·|), with the same step sizes;
    from about iteration 14 their rounding-level difference grows ~5× per
    iteration to ~1e-2 and the solves end apart (87 and 89 iterations,
    1.9e-4 in xs). The port's own solve from an x0 perturbed by 1e-12
    (one joint velocity) ends as far from its unperturbed solve: the
    iteration amplifies rounding, as the JAX package's does."""
    jp, (tp, model, _) = _jump()
    kw = dict(TJ.SETTINGS, record_iterates=True)
    ref = jax.jit(lambda p: jax_solve(p, JSettings(**kw)))(jp)
    res = proxddp_solve(tp, ProxDDPSettings(**kw))
    hx, hx_ref = res.history_xs.numpy(), np.asarray(ref.history_xs)
    early = max(float(np.abs(hx[k] - hx_ref[k]).max()) / max(1.0, float(np.abs(hx_ref[k]).max()))
                for k in range(10))
    rel = lambda a, b: float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))
    x0p = tp.x0.clone()
    x0p[model.nq + 6] += 1e-12
    res_p = proxddp_solve(tp.replace_x0(x0p), ProxDDPSettings(**TJ.SETTINGS))
    print(f"jump: iterations port {int(res.num_iters)}, JAX {int(ref.num_iters)}, port from a "
          f"perturbed x0 {int(res_p.num_iters)}; first 10 iterates max rel diff {early:.3e}; "
          f"final xs port vs JAX {rel(res.xs.numpy(), np.asarray(ref.xs)):.3e}, port vs "
          f"perturbed port {rel(res_p.xs.numpy(), res.xs.numpy()):.3e}; traj cost port "
          f"{float(res.traj_cost):.6f}, JAX {float(ref.traj_cost):.6f}")
    assert bool(res.conv) and bool(ref.conv) and bool(res_p.conv)
    assert early <= 1e-8
    assert abs(float(res.traj_cost) - float(ref.traj_cost)) <= 1e-3 * abs(float(ref.traj_cost))
    assert rel(res_p.xs.numpy(), res.xs.numpy()) >= 1e-6
    for xs in (res.xs, torch.as_tensor(np.asarray(ref.xs))):
        z0, apex, zN = (float(v) for v in TJ.base_heights(xs))
        assert apex > z0 + 0.04 and abs(zN - z0) < 0.08


def jump_batch(batch, dtype=torch.float32):
    """The jump's first ``batch`` perturbed scenarios (joint velocities
    + 0.01·N(0, 1) from default_rng(7), as ``chip_smoke`` makes them)."""
    problem, model, _ = TJ.create_jump_problem(dtype=dtype, device="cpu")
    return chip_smoke.walk_scenarios(problem, model, batch)


@pytest.mark.slow
def test_jump_f32_fused_batch_against_jax():
    """Four scenarios in float32 through the fused LQ path in both
    packages (the kernels' plain versions here, the Pallas kernels in
    interpret mode in JAX). Reference behaviour (ROADMAP C13): the JAX
    batch converges in none of the four within the example's 200
    iterations (the port's in one, at 128), so the convergence flags and
    iterations are printed, not compared; the traj costs agree to 1e-3 in
    every scenario, and every port scenario jumps (apex above the start by
    more than 0.04 m, the end within 0.08 m of it)."""
    from examples.solo_jump import create_jump_problem as jax_jump

    problem = jump_batch(4)
    res = proxddp_solve(problem, ProxDDPSettings(lq_solver="pallas", **TJ.SETTINGS))
    jp = jax_jump(dtype=jnp.float32)[0]
    s = JSettings(lq_solver="pallas", **TJ.SETTINGS)
    ref = jax.jit(jax.vmap(lambda x0: jax_solve(jp.replace_x0(x0), s)))(
        jnp.asarray(problem.x0.numpy()))
    cost, jcost = res.traj_cost.double().numpy(), np.asarray(ref.traj_cost, np.float64)
    gap = np.abs(cost - jcost) / np.maximum(np.abs(jcost), 1.0)
    z0, apex, zN = (v.numpy() for v in TJ.base_heights(res.xs))
    print(f"jump f32 fused B=4: conv port {res.conv.tolist()}, JAX "
          f"{np.asarray(ref.conv).tolist()}; iterations port {res.num_iters.tolist()}, JAX "
          f"{np.asarray(ref.num_iters).tolist()}; traj cost rel gap {gap.tolist()}; rise "
          f"{(apex - z0).tolist()}, end drift {np.abs(zN - z0).tolist()}")
    assert not bool(np.asarray(ref.conv).any())
    assert float(gap.max()) <= 1e-3
    assert bool(np.all(apex > z0 + 0.04)) and bool(np.all(np.abs(zN - z0) < 0.08))


@pytest.mark.slow
def test_f32_riccati_on_the_jumps_lq_inputs_is_reference_behaviour():
    """ROADMAP C13: on the LQ knots of the fused float32 solve's second K1
    call (2 scenarios, µ = 1e-2) the JAX Pallas kernel (interpret mode) and
    the port's plain K1 (the serial recursion) are both non-finite on
    scenario 1 and differ by more than 1e-2 relative on scenario 0, while
    the float64 recursion is finite on both: the float32 Riccati of these
    inputs breaks down, in the reference kernel as in the port, so the
    card prints its kernel-vs-plain comparison of the jump's calls
    instead of gating it."""
    from aligator_tpu.gar import pallas_riccati as PR
    from aligator_tpu.gar import riccati as JR

    from aligator_tpu_torch.gar import fused_riccati as FR
    from aligator_tpu_torch.solvers import proxddp as P

    problem = jump_batch(2)
    calls, orig = [], FR.backward_sweep_batched

    def spy(knots, mu, refine_steps=1):
        calls.append((knots, mu, refine_steps))
        return orig(knots, mu, refine_steps)

    FR.backward_sweep_batched = spy
    try:
        P.solve(problem, ProxDDPSettings(lq_solver="pallas", **{**TJ.SETTINGS, "max_iters": 2}))
    finally:
        FR.backward_sweep_batched = orig
    knots, mu, rs = calls[1]
    gp, vp = FR.backward_sweep_batched_ref(knots, mu, rs)
    jk = JR.Knot(**{f: jnp.asarray(getattr(knots, f).numpy()) for f in JR.Knot._fields})
    gj, vj = PR.backward_sweep_batched(jk, jnp.asarray(mu.numpy()), rs)
    g64, _ = FR.backward_sweep_batched_ref(type(knots)(*(a.double() for a in knots)),
                                           mu.double(), rs)
    outs = lambda g, v, b: [np.asarray(getattr(g, n))[b] for n in ("kff", "K", "Acl")] + [
        np.asarray(v.Vxx)[b]]
    finite = lambda xs: all(np.isfinite(x).all() for x in xs)
    assert finite([g64.kff.numpy(), g64.K.numpy()])
    assert not finite(outs(gp, vp, 1)) and not finite(outs(gj, vj, 1))
    plain0, pallas0 = outs(gp, vp, 0), outs(gj, vj, 0)
    assert finite(plain0) and finite(pallas0)
    rel = max(np.abs(a - b).max() for a, b in zip(pallas0, plain0)) / max(
        1.0, max(np.abs(b).max() for b in plain0))
    print(f"scenario 0: Pallas vs plain K1 max|d|/max(1, max|plain|) {rel:.3e}")
    assert rel > 1e-2
