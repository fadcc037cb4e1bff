"""KKT residuals of a candidate LQ solution (port of the residual half of
``aligator_tpu.gar.utils``; the dense oracles and random fixtures stay on
the JAX side). Every tensor carries a leading batch axis."""

from __future__ import annotations

import torch

from aligator_tpu_torch.gar.lqr_problem import LQRProblem
from aligator_tpu_torch.gar.riccati import mv


def _kkt_rows(p: LQRProblem, xs, us, vs, lbdas, mueq):
    """(dyn0, dyn, cstr, gx, gu) residual rows, each with leading batch."""
    N = p.horizon
    mu = torch.as_tensor(mueq, dtype=p.dtype, device=p.device)
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
