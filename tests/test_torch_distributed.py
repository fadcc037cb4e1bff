"""Riccati legs and scenario batches over several processes
(``aligator_tpu_torch.distributed``, the mesh path of ``gar.parallel`` and
ProxDDP's ``lq_mesh``) against the JAX package's mesh-sharded solves.

Workers are functions of this module started in the spawn context: two
processes over Gloo on the loopback interface (a (1, 2) leg mesh and a
(2, 1) batch mesh in one world) and four for the combined (2, 2) mesh.
The module level imports torch, numpy and the port only, so that a worker
never imports JAX; the JAX side runs in the test process, on the 8 CPU
devices of ``tests/conftest.py``. Every group has a 60 s timeout and each
world a 120 s join deadline, so a divergent rank fails the test instead
of hanging it.

Gates: the sharded ``parallel_solve`` and ProxDDP solve against JAX's
``shard_map`` solves at 1e-12 (float64) with equal ``conv`` and
``num_iters``; against the port's serial solves at 1e-8 (the JAX tests'
gate); the batch and b × t grids against single-process solves at 1e-10;
the ranks of each t group bitwise equal."""

from __future__ import annotations

import multiprocessing
import os
import socket
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

from aligator_tpu_torch import distributed as D
from aligator_tpu_torch.convert import problem_from_numpy
from aligator_tpu_torch.gar import parallel as GP
from aligator_tpu_torch.gar import parallel_solve, random_lqr_problem, riccati_solve
from aligator_tpu_torch.solvers import ProxDDPSettings, proxddp_solve

torch.set_num_threads(1)

GROUP_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 120
MUEQ = 1e-10
LEGS = 8
# ProxDDP with legs over the mesh: the problem and settings of
# tests/test_proxddp_mesh.py
MESH_SOLVE = dict(tol=1e-8, mu_init=1e-2, max_iters=15)
# scenario batches: the problems and settings of tests/multihost_worker.py
BATCH_SOLVE = dict(tol=1e-8, mu_init=1e-3, max_iters=20)
B_LOCAL = 4


def _lqr_problem():
    """tests/test_gar_parallel.py:43-60: N = 31, nx = 6, nu = 4, nc = 3."""
    return random_lqr_problem(np.random.default_rng(23), N=31, nx=6, nu=4, nc=3,
                              device="cpu")


def _make_problem_arrays(ndx=6, nu=3, seed=1):
    """The draws of ``__graft_entry__._make_problem``."""
    rng = np.random.default_rng(seed)
    A = np.eye(ndx) + 0.05 * rng.standard_normal((ndx, ndx)) / np.sqrt(ndx)
    B = rng.standard_normal((ndx, nu)) / np.sqrt(ndx)
    c = 0.01 * rng.standard_normal(ndx)
    x0 = 0.1 * rng.standard_normal(ndx)
    return A, B, c, x0


def _mesh_problem(nsteps=4 * LEGS - 1):
    A, B, c, x0 = _make_problem_arrays()
    nx, nu = B.shape
    return problem_from_numpy(A, B, c, 0.01 * np.eye(nx), 0.01 * np.eye(nu), np.eye(nx),
                              x0, nsteps, np.full(nu, -0.5), np.full(nu, 0.5),
                              device="cpu", dtype=torch.float64)


def _worker_problem(nx, nu, nsteps, x0s):
    """tests/multihost_worker.py:make_problem, with a batch of initial states."""
    rng = np.random.default_rng(0)
    A = np.eye(nx) + 0.1 * rng.standard_normal((nx, nx)) / np.sqrt(nx)
    B = rng.standard_normal((nx, nu)) / np.sqrt(nx)
    return problem_from_numpy(A, B, np.zeros(nx), 0.1 * np.eye(nx), 0.1 * np.eye(nu),
                              np.eye(nx), x0s, nsteps, np.full(nu, -0.3),
                              np.full(nu, 0.3), device="cpu", dtype=torch.float64)


def _global_x0s(nproc, nx):
    return 0.5 * np.random.default_rng(42).standard_normal((nproc * B_LOCAL, nx))


def _np(res, *names):
    return {n: getattr(res, n).numpy() for n in names}


# ---------------------------------------------------------------------------
# workers
# ---------------------------------------------------------------------------


def _refusals(mesh_t) -> dict:
    """Each refusal as it is met (the raise comes before any collective)."""
    out = {}
    try:
        D.make_solver_mesh(legs=3, timeout=GROUP_TIMEOUT_S)
        out["world_not_divisible"] = "no error"
    except ValueError as e:
        out["world_not_divisible"] = f"ValueError: {e}"
    os.environ["LOCAL_WORLD_SIZE"] = "1"
    try:
        D.make_solver_mesh(legs=2, timeout=GROUP_TIMEOUT_S)
        out["leg_group_crosses_node"] = "no error"
    except ValueError as e:
        out["leg_group_crosses_node"] = f"ValueError: {e}"
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]
    try:
        parallel_solve(_lqr_problem(), MUEQ, 3, mesh=mesh_t)
        out["num_legs_not_multiple"] = "no error"
    except ValueError as e:
        out["num_legs_not_multiple"] = f"ValueError: {e}"
    group = dist.group.WORLD
    D.initialize("127.0.0.1:1", 7, 5, backend="gloo")  # must change nothing
    out["initialize_twice"] = (f"world {dist.get_world_size()}, rank {dist.get_rank()}, "
                               f"same group {dist.group.WORLD is group}")
    return out


def _two_rank_task(rank: int) -> dict:
    mesh_t = D.make_solver_mesh(legs=2, device="cpu", timeout=GROUP_TIMEOUT_S)
    mesh_b = D.make_solver_mesh(legs=1, device="cpu", timeout=GROUP_TIMEOUT_S)
    out = {"shape_t": mesh_t.shape, "shape_b": mesh_b.shape,
           "coords_t": mesh_t.coords, "coords_b": mesh_b.coords}
    lq = _lqr_problem()
    out["parallel"] = [a.numpy() for a in parallel_solve(lq, MUEQ, LEGS, mesh=mesh_t)]
    _, gains = parallel_solve(lq, MUEQ, LEGS, mesh=mesh_t, return_gains=True)
    out["gains"] = {n: getattr(gains, n).numpy() for n in ("kff", "K", "zff", "Z")}
    gathers, gather = [], GP.all_gather_cat  # the collectives of the solve's LQ calls
    GP.all_gather_cat = lambda *a, **k: (gathers.append(1), gather(*a, **k))[1]
    try:
        res = proxddp_solve(_mesh_problem(), ProxDDPSettings(
            **MESH_SOLVE, lq_num_legs=LEGS, lq_mesh=mesh_t))
    finally:
        GP.all_gather_cat = gather
    out["proxddp"] = _np(res, "xs", "us", "lams", "conv", "num_iters", "dual_infeas")
    out["proxddp_gathers"] = len(gathers)
    x0s = _global_x0s(2, 4)[rank * B_LOCAL:(rank + 1) * B_LOCAL]
    solve = D.make_batch_solver(_worker_problem(4, 2, 8, x0s), ProxDDPSettings(**BATCH_SOLVE),
                                mesh_b)
    out["batch"] = _np(solve(D.shard_batch(x0s, mesh_b)), "xs", "conv", "num_iters")
    out["refusals"] = _refusals(mesh_t)
    return out


def _bt_task(rank: int) -> dict:
    """tests/multihost_worker.py with legs = 2: NX = 16, NU = 8, N = 31, a
    (2, 2) grid, each b row solving its 4 scenarios with 2 legs over t."""
    mesh = D.make_solver_mesh(legs=2, device="cpu", timeout=GROUP_TIMEOUT_S)
    b = mesh.coords["b"]
    x0s = _global_x0s(2, 16)[b * B_LOCAL:(b + 1) * B_LOCAL]
    settings = ProxDDPSettings(**BATCH_SOLVE, lq_num_legs=2, lq_mesh=mesh)
    solve = D.make_batch_solver(_worker_problem(16, 8, 31, x0s), settings, mesh)
    res = solve(D.shard_batch(x0s, mesh))
    return {"coords": mesh.coords, **_np(res, "xs", "us", "conv", "num_iters")}


def _worker(rank: int, world: int, port: int, conn, task) -> None:
    torch.set_num_threads(1)
    try:
        D.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo",
                     timeout=GROUP_TIMEOUT_S)
        conn.send(("ok", task(rank)))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        conn.close()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_world(task, world: int) -> list:
    """Run ``task(rank)`` in ``world`` spawned processes joined over Gloo;
    their results in rank order. Fails when a rank raises, dies or has not
    answered by the join deadline, and stops every process on the way out."""
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs, pipes = [], []
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        for rank in range(world):
            recv, send = ctx.Pipe(duplex=False)
            procs.append(ctx.Process(target=_worker, args=(rank, world, port, send, task),
                                     daemon=True))
            procs[-1].start()
            send.close()
            pipes.append(recv)
        results = []
        for rank, recv in enumerate(pipes):
            assert recv.poll(max(0.0, deadline - time.monotonic())), (
                f"rank {rank} sent nothing within {JOIN_TIMEOUT_S} s")
            try:
                status, payload = recv.recv()
            except EOFError:
                raise AssertionError(f"rank {rank} died without a result") from None
            assert status == "ok", f"rank {rank} failed:\n{payload}"
            results.append(payload)
        return results
    finally:
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join()


@pytest.fixture(scope="module")
def two_ranks():
    return _run_world(_two_rank_task, 2)


@pytest.fixture(scope="module")
def four_ranks():
    return _run_world(_bt_task, 4)


def _bitwise(a: dict, b: dict, path=""):
    for k, v in a.items():
        if isinstance(v, dict):
            _bitwise(v, b[k], f"{path}{k}.")
        elif isinstance(v, np.ndarray):
            assert v.dtype == b[k].dtype and np.array_equal(v, b[k], equal_nan=True), (
                f"{path}{k} differs between the ranks")
        elif isinstance(v, list):
            for i, (x, y) in enumerate(zip(v, b[k])):
                assert np.array_equal(x, y, equal_nan=True), f"{path}{k}[{i}] differs"


# ---------------------------------------------------------------------------
# parallel_solve with legs over two processes
# ---------------------------------------------------------------------------


def _jax_mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:LEGS]), axis_names=("t",))


def _jax_lqr_problem():
    from aligator_tpu import gar as jgar

    return jgar.random_lqr_problem(np.random.default_rng(23), N=31, nx=6, nu=4, nc=3)


def test_mesh_layout(two_ranks):
    for rank, out in enumerate(two_ranks):
        assert out["shape_t"] == {"b": 1, "t": 2} and out["coords_t"] == {"b": 0, "t": rank}
        assert out["shape_b"] == {"b": 2, "t": 1} and out["coords_b"] == {"b": rank, "t": 0}


def test_parallel_solve_mesh_matches_serial(two_ranks):
    ref = riccati_solve(_lqr_problem(), MUEQ)[:4]
    for got, want, name in zip(two_ranks[0]["parallel"], ref, ("xs", "us", "vs", "lbds")):
        assert got.shape == tuple(want.shape)
        np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-8, err_msg=name)


def test_parallel_solve_mesh_matches_jax(two_ranks):
    from aligator_tpu import gar as jgar

    solve = jgar.make_parallel_solver(LEGS, mesh=_jax_mesh(), axis_name="t")
    ref = solve(_jax_lqr_problem(), MUEQ)
    for got, want, name in zip(two_ranks[0]["parallel"], ref, ("xs", "us", "vs", "lbds")):
        np.testing.assert_allclose(got[0], np.asarray(want), rtol=0, atol=1e-12,
                                   err_msg=name)


def test_parallel_solve_mesh_gains_match_jax(two_ranks):
    """return_gains with a mesh: the collapsed stage-0 feedback included."""
    import jax
    from aligator_tpu import gar as jgar

    mesh = _jax_mesh()
    _, gains = jax.jit(lambda p: jgar.parallel_solve(p, MUEQ, LEGS, mesh=mesh,
                                                     return_gains=True))(_jax_lqr_problem())
    for name, got in two_ranks[0]["gains"].items():
        np.testing.assert_allclose(got[0], np.asarray(getattr(gains, name)), rtol=0,
                                   atol=1e-12, err_msg=name)


def test_parallel_solve_mesh_ranks_bitwise(two_ranks):
    _bitwise({"parallel": two_ranks[0]["parallel"], "gains": two_ranks[0]["gains"]},
             {"parallel": two_ranks[1]["parallel"], "gains": two_ranks[1]["gains"]})


# ---------------------------------------------------------------------------
# ProxDDP with lq_mesh over two processes
# ---------------------------------------------------------------------------


def test_proxddp_lq_mesh_matches_jax(two_ranks):
    """tests/test_proxddp_mesh.py's solve: the JAX package's legs over its
    8-device mesh against the port's over 2 processes (4 legs each)."""
    import jax
    import jax.numpy as jnp
    from aligator_tpu.solvers import ProxDDPSettings as JSettings
    from aligator_tpu.solvers import proxddp_solve as jax_solve
    from __graft_entry__ import _make_problem

    problem = _make_problem(ndx=6, nu=3, nsteps=4 * LEGS - 1, dtype=jnp.float64, seed=1)
    settings = JSettings(**MESH_SOLVE, lq_num_legs=LEGS, lq_mesh=_jax_mesh())
    ref = jax.jit(lambda p: jax_solve(p, settings))(problem)
    got = two_ranks[0]["proxddp"]
    assert bool(got["conv"]) and bool(ref.conv)
    assert int(got["num_iters"]) == int(ref.num_iters)
    for name in ("xs", "us", "lams"):
        np.testing.assert_allclose(got[name], np.asarray(getattr(ref, name)), rtol=0,
                                   atol=1e-12, err_msg=name)


def test_proxddp_lq_mesh_matches_serial(two_ranks):
    """The same solve on the serial LQ path in one process, at the JAX
    test's gate, and the dual residual that the 252be30 fault corrupted."""
    ser = proxddp_solve(_mesh_problem(), ProxDDPSettings(**MESH_SOLVE))
    got = two_ranks[0]["proxddp"]
    assert bool(got["conv"]) and bool(ser.conv)
    np.testing.assert_allclose(got["xs"], ser.xs.numpy(), rtol=0, atol=1e-8)
    np.testing.assert_allclose(got["us"], ser.us.numpy(), rtol=0, atol=1e-8)
    assert float(got["dual_infeas"]) <= 10 * float(ser.dual_infeas) + 1e-10


def test_proxddp_lq_mesh_ranks_bitwise(two_ranks):
    """Both ranks end bitwise equal, having gathered their legs twice per
    LQ solve (summaries, then the sweep's outputs), in at least one LQ
    solve per Newton step."""
    _bitwise(two_ranks[0]["proxddp"], two_ranks[1]["proxddp"])
    n = [out["proxddp_gathers"] for out in two_ranks]
    assert n[0] == n[1] and n[0] % 2 == 0
    assert n[0] >= 2 * int(two_ranks[0]["proxddp"]["num_iters"]) > 0


# ---------------------------------------------------------------------------
# scenario batches: the (2, 1) grid and the (2, 2) grid
# ---------------------------------------------------------------------------


def test_batch_solver_matches_local(two_ranks):
    """tests/test_multihost.py::test_two_process_batched_solve: each rank's
    4 scenarios against the 8 solved in one process."""
    x0s = _global_x0s(2, 4)
    ref = proxddp_solve(_worker_problem(4, 2, 8, x0s), ProxDDPSettings(**BATCH_SOLVE))
    for rank, out in enumerate(two_ranks):
        rows = slice(rank * B_LOCAL, (rank + 1) * B_LOCAL)
        assert out["batch"]["conv"].all()
        np.testing.assert_array_equal(out["batch"]["num_iters"], ref.num_iters[rows].numpy())
        np.testing.assert_allclose(out["batch"]["xs"], ref.xs[rows].numpy(), rtol=0,
                                   atol=1e-10)


def test_bt_mesh_matches_serial_oracle(four_ranks):
    """tests/test_multihost.py::test_two_process_combined_bt_mesh: each b
    row's scenarios, legs over its t group, against a serial-LQ solve of
    the whole batch in one process."""
    x0s = _global_x0s(2, 16)
    ref = proxddp_solve(_worker_problem(16, 8, 31, x0s), ProxDDPSettings(**BATCH_SOLVE))
    for out in four_ranks:
        b = out["coords"]["b"]
        rows = slice(b * B_LOCAL, (b + 1) * B_LOCAL)
        assert out["conv"].all()
        np.testing.assert_allclose(out["xs"], ref.xs[rows].numpy(), rtol=0, atol=1e-10)
        np.testing.assert_allclose(out["us"], ref.us[rows].numpy(), rtol=0, atol=1e-10)


def test_bt_mesh_t_groups_bitwise(four_ranks):
    by_b = {}
    for out in four_ranks:
        by_b.setdefault(out["coords"]["b"], []).append(out)
    assert sorted(by_b) == [0, 1] and all(len(g) == 2 for g in by_b.values())
    for first, second in by_b.values():
        _bitwise({k: v for k, v in first.items() if k != "coords"},
                 {k: v for k, v in second.items() if k != "coords"})


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case, expect", [
    ("world_not_divisible", "ValueError: world size 2 not divisible by legs=3"),
    ("leg_group_crosses_node", "ValueError: leg axis must not cross nodes"),
    ("num_legs_not_multiple", "ValueError: num_legs=3 is not a multiple"),
    ("initialize_twice", "world 2, rank {rank}, same group True"),
])
def test_mesh_refusals(two_ranks, case, expect):
    for rank, out in enumerate(two_ranks):
        assert out["refusals"][case].startswith(expect.format(rank=rank)), (
            out["refusals"][case])
