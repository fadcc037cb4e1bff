"""Plotting helpers (port of ``aligator_tpu.utils.plotting``): primal and
dual errors, convergence, control and velocity trajectories, SE(2) poses.

Tensors on any device are read with ``.detach().cpu().numpy()``; numpy
arrays are taken as they are. matplotlib is imported inside the functions,
so the port needs it only where a plot is drawn; no other module of the
port imports this one."""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib.pyplot as plt

    return plt


def _np(a) -> np.ndarray:
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def plot_pd_errs(ax, prim_errs, dual_errs):
    """Primal and dual infeasibility against the iteration, on a log axis."""
    prim_errs = _np(prim_errs)
    dual_errs = _np(dual_errs)
    it = np.arange(len(prim_errs))
    ax.plot(it, prim_errs, ls="--", marker=".", label="primal err")
    ax.plot(it, dual_errs, ls="--", marker=".", label="dual err")
    ax.set_yscale("log")
    ax.set_xlabel("iteration")
    ax.legend()
    return ax


def plot_convergence(results, ax=None, title: str = "convergence"):
    """Convergence plot of a solve with ``record_history=True``: the
    per-iteration [alpha, inner_crit, prim, dual, merit, mu, preg] rows.
    The port's results carry a batch axis: this plots a result of batch 1
    (or an unbatched one) and raises ``ValueError`` for more; pick element
    i with ``utils.tree.tree_map(lambda a: a[i:i + 1], res)``."""
    hist, n_iters = _np(results.history), _np(results.num_iters)
    if hist.ndim == 3:
        if hist.shape[0] != 1:
            raise ValueError(f"plot_convergence draws one solve; got a batch of "
                             f"{hist.shape[0]} (select one element first)")
        hist, n_iters = hist[0], n_iters.reshape(-1)[0]
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots()
    h = hist[: int(n_iters)]
    plot_pd_errs(ax, h[:, 2], h[:, 3])
    ax.set_title(title)
    return ax


def plot_controls_traj(times, us, ncols: int = 2, axes=None, effort_limit=None,
                       joint_names=None, rmodel=None):
    """Per-dimension control trajectories on a grid of subplots, with the
    effort limits as dashed lines."""
    plt = _plt()
    us = _np(us)
    nu = us.shape[1]
    nrows, r = divmod(nu, ncols)
    nrows += bool(r)
    if axes is None:
        fig, axes = plt.subplots(nrows, ncols, sharex="col",
                                 figsize=(6.4, 1.6 * nrows))
    else:
        fig = axes.flat[0].get_figure()
    axes = np.asarray(axes).reshape(-1)
    t = _np(times)[: us.shape[0]]
    limit = None if effort_limit is None else _np(effort_limit)
    for i in range(nu):
        ax = axes[i]
        ax.step(t, us[:, i], where="post")
        if limit is not None:
            ax.hlines(-limit[i], t[0], t[-1], colors="k", linestyles="--")
            ax.hlines(+limit[i], t[0], t[-1], colors="r", linestyles="dashdot")
        name = joint_names[i] if joint_names is not None else f"u{i}"
        ax.set_ylabel(name)
    fig.supxlabel("Time [s]")
    return fig, axes


def plot_velocity_traj(times, vs, ncols: int = 2, axes=None, vel_limit=None,
                       joint_names=None):
    """Per-dimension velocity trajectories, with the velocity limits."""
    return plot_controls_traj(times, vs, ncols=ncols, axes=axes,
                              effort_limit=vel_limit, joint_names=joint_names)


def plot_se2_pose(x, ax, alpha: float = 0.5, fc: str = "tab:blue"):
    """Draw an SE(2) pose as a rotated square: ``x`` is (x, y, θ) or the
    library's SE(2) chart (px, py, cos θ, sin θ)."""
    plt = _plt()
    from matplotlib import transforms

    x = _np(x)
    if x.shape[-1] == 4:
        px, py = x[0], x[1]
        theta = np.arctan2(x[3], x[2])
    else:
        px, py, theta = x[0], x[1], x[2]
    w = 0.4
    rect = plt.Rectangle((-w / 2, -w / 2), w, w, fc=fc, alpha=alpha)
    tr = transforms.Affine2D().rotate(theta).translate(px, py)
    rect.set_transform(tr + ax.transData)
    ax.add_patch(rect)
    return ax
