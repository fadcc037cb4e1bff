"""GAR utilities (port of ``aligator_tpu.gar.utils``): KKT residuals of a
candidate LQ solution, the monolithic dense KKT system and its solve, and
random problems for tests. Every tensor carries a leading batch axis."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.port.gar.lqr_problem import LQRProblem
from portbench.reference.port.gar.riccati import mv
from portbench.reference.port.utils.device import resolve_device, scalar_like
from portbench.reference.port.utils.tree import tree_map


def _kkt_rows(p: LQRProblem, xs, us, vs, lbdas, mueq):
    """(dyn0, dyn, cstr, gx, gu) residual rows, each with leading batch."""
    N = p.horizon
    mu = scalar_like(mueq, p.Q)
    mu = mu.reshape(mu.shape + (1, 1)) if mu.dim() else mu
    dyn0 = p.g0 + mv(p.G0, xs[:, 0])
    dyn = (mv(p.A[:, :N], xs[:, :N]) + mv(p.B[:, :N], us[:, :N])
           + p.f[:, :N] - xs[:, 1:])
    cstr = mv(p.C, xs) + mv(p.D, us) + p.d - mu * vs
    gx = p.q + mv(p.Q, xs) + mv(p.S, us) + mv(p.C.mT, vs)
    gu = p.r + mv(p.S.mT, xs) + mv(p.R, us) + mv(p.D.mT, vs)
    zx = xs.new_zeros(xs[:, :1].shape)
    gx = gx + torch.cat([mv(p.A[:, :N].mT, lbdas[:, 1:]), zx], dim=1)
    gu = gu + torch.cat([mv(p.B[:, :N].mT, lbdas[:, 1:]),
                         us.new_zeros(us[:, :1].shape)], dim=1)
    g0_term = mv(p.G0.mT, lbdas[:, 0, : p.nc0]).unsqueeze(1)
    gx = gx + torch.cat([g0_term, -lbdas[:, 1:]], dim=1)
    return dyn0, dyn, cstr, gx, gu


def lqr_kkt_residuals(problem: LQRProblem, xs, us, vs, lbdas, mueq=0.0
                      ) -> LQRProblem:
    """KKT residual vectors packaged as an ``LQRProblem`` whose rhs fields
    (q, r, d, f, g0) hold the residual components: solving it with any LQ
    solver gives the refinement correction δ with K·δ = −res."""
    dyn0, dyn, cstr, gx, gu = _kkt_rows(problem, xs, us, vs, lbdas, mueq)
    f_res = torch.cat([dyn, dyn.new_zeros(dyn[:, :1].shape)], dim=1)
    return problem.replace(q=gx, r=gu, d=cstr, f=f_res, g0=dyn0)


def lqr_kkt_error(problem: LQRProblem, xs, us, vs, lbdas, mueq=0.0):
    """Per-problem infinity norms (B,) of the KKT residual: dyn, cstr,
    dual and their max — the tests' gate (θ-free problems)."""
    dyn0, dyn, cstr, gx, gu = _kkt_rows(problem, xs, us, vs, lbdas, mueq)
    inf = lambda a: (a.abs().flatten(1).amax(dim=1) if a[0].numel()
                     else a.new_zeros(a.shape[0]))
    dyn_err = torch.maximum(inf(dyn0), inf(dyn))
    cstr_err = inf(cstr)
    dual_err = torch.maximum(inf(gx), inf(gu))
    return {
        "dyn": dyn_err,
        "cstr": cstr_err,
        "dual": dual_err,
        "max": torch.maximum(torch.maximum(dyn_err, cstr_err), dual_err),
    }


def lqr_dense_matrix(problem: LQRProblem, mueq=0.0):
    """The monolithic KKT matrix (B, n, n) and right-hand side (B, n) of
    each problem, in the problem's dtype: the variables of knot t are
    [x_t, u_t, v_t, λ_{t+1}], after λ_0; the solution z of mat·z = −rhs is
    the primal-dual trajectory. The unused terminal A, B, f are not read.
    ``mueq`` is a scalar or (B,)."""
    p = problem
    N, nx, nu, nc, nc0 = p.horizon, p.nx, p.nu, p.nc, p.nc0
    n_blk = nx + nu + nc
    nrows = nc0 + (N + 1) * n_blk + N * nx
    mat = p.Q.new_zeros((p.batch, nrows, nrows))
    rhs = p.Q.new_zeros((p.batch, nrows))
    mu = scalar_like(mueq, p.Q)
    mu = mu.reshape(mu.shape + (1, 1)) if mu.dim() else mu
    neg_mu_eye = -mu * torch.eye(nc, dtype=p.dtype, device=p.device)
    neg_eye = -torch.eye(nx, dtype=p.dtype, device=p.device)

    def put(i, j, blk):
        mat[:, i : i + blk.shape[-2], j : j + blk.shape[-1]] = blk

    put(nc0, 0, p.G0.mT)
    put(0, nc0, p.G0)
    rhs[:, :nc0] = p.g0
    idx = nc0
    for t in range(N + 1):
        ix, iu, iv = idx, idx + nx, idx + nx + nu
        put(ix, ix, p.Q[:, t])
        put(ix, iu, p.S[:, t])
        put(iu, ix, p.S[:, t].mT)
        put(iu, iu, p.R[:, t])
        put(iv, ix, p.C[:, t])
        put(ix, iv, p.C[:, t].mT)
        put(iv, iu, p.D[:, t])
        put(iu, iv, p.D[:, t].mT)
        put(iv, iv, neg_mu_eye)
        rhs[:, ix : ix + nx] = p.q[:, t]
        rhs[:, iu : iu + nu] = p.r[:, t]
        rhs[:, iv : iv + nc] = p.d[:, t]
        if t != N:
            il = idx + n_blk
            put(il, ix, p.A[:, t])
            put(ix, il, p.A[:, t].mT)
            put(il, iu, p.B[:, t])
            put(iu, il, p.B[:, t].mT)
            put(il, il + nx, neg_eye)
            put(il + nx, il, neg_eye)
            rhs[:, il : il + nx] = p.f[:, t]
            idx += n_blk + nx
    return mat, rhs


def lqr_dense_solve(problem: LQRProblem, mueq=0.0):
    """The dense KKT solved in float64 (the tests' oracle) → (xs, us, vs,
    lbdas) in float64, ``lbdas[:, 0]`` λ0 zero-padded to nx."""
    from portbench.reference.port.gar.dense import dense_solve

    return dense_solve(tree_map(lambda a: a.to(torch.float64), problem), mueq)


def _random_lqr_arrays(rng, N, nx, nu, nc, nth, well_conditioned, strict) -> dict:
    """One problem's fields, drawn from ``rng`` in the order of the JAX
    package's ``random_lqr_problem``, so one seed gives the same problem."""

    def spd(n, batch):
        w = rng.standard_normal((batch, n, n))
        out = w @ np.transpose(w, (0, 2, 1)) / n
        out += np.eye(n) * (1.0 if well_conditioned else 0.01)
        return out

    Q = spd(nx, N + 1)
    R = spd(nu, N + 1)
    S = rng.standard_normal((N + 1, nx, nu)) * 0.1
    q = rng.standard_normal((N + 1, nx))
    r = rng.standard_normal((N + 1, nu))
    A = rng.standard_normal((N + 1, nx, nx)) / np.sqrt(nx)
    A += np.eye(nx) * 0.5
    B = rng.standard_normal((N + 1, nx, nu)) / np.sqrt(nx)
    f = rng.standard_normal((N + 1, nx)) * 0.1
    C = rng.standard_normal((N + 1, nc, nx)) * 0.5
    d = rng.standard_normal((N + 1, nc)) * 0.1
    if strict:
        if nc > nu:
            raise ValueError("strict random problems require nc <= nu")
        D = rng.standard_normal((N + 1, nc, nu)) * 0.1
        D += np.eye(nc, nu)
        C[0] = 0.0
        D[0] = 0.0
        d[0] = 0.0
        C[N] = 0.0
        d[N] = 0.0
    else:
        D = rng.standard_normal((N + 1, nc, nu))
    R[N] = np.eye(nu)
    S[N] = 0.0
    r[N] = 0.0
    D[N] = 0.0
    Gx = rng.standard_normal((N + 1, nx, nth))
    Gu = rng.standard_normal((N + 1, nu, nth))
    Gu[N] = 0.0
    Gth_half = rng.standard_normal((N + 1, nth, nth))
    Gth = Gth_half @ np.transpose(Gth_half, (0, 2, 1)) / max(nth, 1)
    gamma = rng.standard_normal((N + 1, nth))
    # θ-coefficient of the constraint rows, zero on padding rows
    Gv = 0.1 * rng.standard_normal((N + 1, nc, nth))
    Gv[(C == 0.0).all(axis=(1, 2)) & (d == 0.0).all(axis=1)] = 0.0
    x0 = rng.standard_normal(nx)
    return dict(Q=Q, S=S, R=R, q=q, r=r, A=A, B=B, f=f, C=C, D=D, d=d, Gx=Gx, Gu=Gu,
                Gth=Gth, gamma=gamma, G0=-np.eye(nx), g0=x0, Gv=Gv)


def random_lqr_problem(rng: np.random.Generator, N: int, nx: int, nu: int, nc: int = 0,
                       nth: int = 0, dtype: torch.dtype = torch.float64,
                       well_conditioned: bool = True, strict: bool = True,
                       device=None, batch: int = 1) -> LQRProblem:
    """A batch of random constrained LQ problems (SPD costs, random
    dynamics, initial constraint x0 = x̂0, exact terminal control padding),
    on ``device`` (default: the card; raises without one). Problem i is
    what the JAX package's ``random_lqr_problem`` draws on its i-th call
    with the same ``rng``. ``strict`` keeps the constraints satisfiable
    (nc ≤ nu, D ≈ I, knots 0 and N unconstrained); ``Gv`` is set only when
    nth > 0."""
    device = resolve_device(device)
    draws = [_random_lqr_arrays(rng, N, nx, nu, nc, nth, well_conditioned, strict)
             for _ in range(batch)]
    fields = {k: torch.as_tensor(np.stack([a[k] for a in draws]), dtype=dtype,
                                 device=device) for k in draws[0]}
    if nth == 0:
        fields["Gv"] = None
    return LQRProblem(**fields)
