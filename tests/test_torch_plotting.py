"""The port's plotting helpers (``aligator_tpu_torch.utils.plotting``)
against the JAX package's: each case draws with both on equivalent inputs
(torch tensors for the port, numpy or JAX arrays for the JAX package) on
matplotlib's Agg backend and compares the artists."""

import os
import subprocess
import sys

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from aligator_tpu import constraints as JS  # noqa: E402
from aligator_tpu import costs as JC  # noqa: E402
from aligator_tpu import manifolds as JM  # noqa: E402
from aligator_tpu.dynamics import LinearDiscreteDynamics  # noqa: E402
from aligator_tpu.functions import ControlErrorResidual  # noqa: E402
from aligator_tpu.problem import build_problem  # noqa: E402
from aligator_tpu.solvers import ProxDDPSettings as JSettings  # noqa: E402
from aligator_tpu.solvers import proxddp_solve  # noqa: E402
from aligator_tpu.utils import plotting as JP  # noqa: E402

from aligator_tpu_torch.convert import problem_from_numpy  # noqa: E402
from aligator_tpu_torch.solvers import ProxDDPSettings, proxddp_solve as port_solve  # noqa: E402
from aligator_tpu_torch.utils import plotting as TP  # noqa: E402
from aligator_tpu_torch.utils.tree import tree_map  # noqa: E402

torch.set_num_threads(1)

NX = NU = 3
N = 20
SETTINGS = dict(tol=1e-8, mu_init=1e-2, max_iters=30, record_history=True)


def _fixture():
    """The float64 box-LQR of tests/test_torch_proxddp.py (seed 0)."""
    rng = np.random.default_rng(0)
    A = np.eye(NX) * 1.02
    B = rng.standard_normal((NX, NU))
    c = 0.01 * rng.standard_normal(NX)
    x0 = rng.standard_normal(NX)
    return dict(A=A, B=B, c=c, Q=0.1 * np.eye(NX), R=0.01 * np.eye(NU), Qf=np.eye(NX),
                x0=x0, lower=np.full(NU, -0.18), upper=np.full(NU, 0.18))


def _port_result(x0s):
    f = _fixture()
    problem = problem_from_numpy(f["A"], f["B"], f["c"], f["Q"], f["R"], f["Qf"], x0s, N,
                                 f["lower"], f["upper"], device="cpu", dtype=torch.float64)
    return port_solve(problem, ProxDDPSettings(**SETTINGS))


@pytest.fixture(scope="module")
def solves():
    """(the unbatched ``jax.jit(proxddp_solve)`` result, the port's at B = 1)."""
    f = _fixture()
    a = lambda v: jnp.asarray(v, jnp.float64)
    problem = build_problem(
        JM.VectorSpace(NX), NU, N, a(f["x0"]),
        LinearDiscreteDynamics(A=a(f["A"]), B=a(f["B"]), c=a(f["c"])),
        JC.QuadraticCost.create(a(f["Q"]), a(f["R"])),
        JC.QuadraticCost.create(a(f["Qf"]), a(f["R"])),
        constraints=((ControlErrorResidual(target=jnp.zeros(NU, jnp.float64)),
                      JS.BoxConstraint(lower=tuple(f["lower"]), upper=tuple(f["upper"])),
                      NU),),
    )
    settings = JSettings(**SETTINGS)
    res_j = jax.jit(lambda p: proxddp_solve(p, settings))(problem)
    return res_j, _port_result(f["x0"][None])


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


def _lines(ax):
    return [(ln.get_xydata(), ln.get_label(), ln.get_linestyle(), ln.get_marker())
            for ln in ax.get_lines()]


def _same_lines(ax_t, ax_j, tol=1e-12):
    lt, lj = _lines(ax_t), _lines(ax_j)
    assert len(lt) == len(lj)
    for (xy_t, *style_t), (xy_j, *style_j) in zip(lt, lj):
        assert style_t == style_j
        np.testing.assert_allclose(xy_t, xy_j, rtol=0, atol=tol)


def test_plot_convergence(solves):
    res_j, res_t = solves
    assert int(res_t.num_iters[0]) == int(res_j.num_iters) > 1
    ax_j = JP.plot_convergence(res_j, title="lqr")
    ax_t = TP.plot_convergence(res_t, title="lqr")
    _same_lines(ax_t, ax_j)
    assert len(ax_t.get_lines()) == 2
    assert ax_t.get_yscale() == ax_j.get_yscale() == "log"
    assert ax_t.get_title() == ax_j.get_title() == "lqr"
    assert ax_t.get_xlabel() == ax_j.get_xlabel()
    legend = lambda ax: [t.get_text() for t in ax.get_legend().get_texts()]
    assert legend(ax_t) == legend(ax_j) == ["primal err", "dual err"]


def test_plot_convergence_refuses_a_batch():
    f = _fixture()
    res = _port_result(np.stack([f["x0"], 0.5 * f["x0"]]))
    with pytest.raises(ValueError, match="batch of 2"):
        TP.plot_convergence(res)
    # one element of it is drawn
    TP.plot_convergence(tree_map(lambda a: a[1:2], res))


def _trajectory_inputs():
    rng = np.random.default_rng(5)
    times = np.linspace(0.0, 1.0, 12)
    us = rng.standard_normal((11, 3))
    limit = np.array([1.0, 2.0, 0.5])
    names = ["hip", "knee", "ankle"]
    return times, us, limit, names


def _same_figures(fig_t, axes_t, fig_j, axes_j, nu=3):
    """One step line and two limit lines on each of the first ``nu`` axes,
    nothing on the others, and the same artists on both sides."""
    assert len(axes_t) == len(axes_j)
    assert [len(ax.get_lines()) for ax in axes_t] == [1] * nu + [0] * (len(axes_t) - nu)
    assert [len(ax.collections) for ax in axes_t] == [2] * nu + [0] * (len(axes_t) - nu)
    for ax_t, ax_j in zip(axes_t, axes_j):
        _same_lines(ax_t, ax_j)
        assert ax_t.get_ylabel() == ax_j.get_ylabel()
        seg = lambda ax: [np.asarray(s) for c in ax.collections for s in c.get_segments()]
        col = lambda ax: [np.asarray(c.get_colors()) for c in ax.collections]
        st, sj = seg(ax_t), seg(ax_j)
        assert len(st) == len(sj)
        for a, b in zip(st, sj):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
        for a, b in zip(col(ax_t), col(ax_j)):
            np.testing.assert_array_equal(a, b)
    assert fig_t._supxlabel.get_text() == fig_j._supxlabel.get_text() == "Time [s]"


def test_plot_controls_traj():
    times, us, limit, names = _trajectory_inputs()
    fig_j, axes_j = JP.plot_controls_traj(times, us, effort_limit=limit, joint_names=names)
    fig_t, axes_t = TP.plot_controls_traj(torch.as_tensor(times), torch.as_tensor(us),
                                          effort_limit=torch.as_tensor(limit),
                                          joint_names=names)
    _same_figures(fig_t, axes_t, fig_j, axes_j)
    assert [ax.get_ylabel() for ax in axes_t[:3]] == names


def test_plot_velocity_traj():
    times, vs, limit, names = _trajectory_inputs()
    fig_j, axes_j = JP.plot_velocity_traj(times, vs, ncols=3, vel_limit=limit,
                                          joint_names=names)
    fig_t, axes_t = TP.plot_velocity_traj(times, torch.as_tensor(vs), ncols=3,
                                          vel_limit=limit, joint_names=names)
    _same_figures(fig_t, axes_t, fig_j, axes_j)


@pytest.mark.parametrize("pose", [
    np.array([0.3, -0.2, 0.7]),  # (x, y, θ)
    np.array([0.3, -0.2, np.cos(2.5), np.sin(2.5)]),  # (px, py, cos θ, sin θ)
])
def test_plot_se2_pose(pose):
    def draw(fn, x):
        _, ax = plt.subplots()
        ax.set_xlim(-1, 1)
        ax.set_ylim(-1, 1)
        fn(x, ax, alpha=0.3, fc="tab:red")
        (patch,) = ax.patches
        return patch

    p_j = draw(JP.plot_se2_pose, jnp.asarray(pose))
    p_t = draw(TP.plot_se2_pose, torch.as_tensor(pose))
    np.testing.assert_allclose(p_t.get_transform().get_matrix(),
                               p_j.get_transform().get_matrix(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(p_t.get_patch_transform().get_matrix(),
                               p_j.get_patch_transform().get_matrix(), rtol=0, atol=1e-12)
    assert p_t.get_facecolor() == p_j.get_facecolor()


def test_plotting_imports_matplotlib_lazily():
    code = ("import sys, aligator_tpu_torch, aligator_tpu_torch.utils.plotting; "
            "print('matplotlib' in sys.modules)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True, cwd=root)
    assert out.stdout.strip() == "False"
