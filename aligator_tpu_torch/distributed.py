"""Scenario batches and Riccati legs over several processes (port of
``aligator_tpu.distributed``).

The solver grid is a (b, t) grid of processes:

  * **batch axis "b"**: independent scenarios. Each process solves its own
    shard of the batch, and no collective crosses this axis;
  * **leg axis "t"**: the horizon legs of the partitioned-condensing
    Riccati solver (``gar.parallel``). The ranks of one t group hold the
    same scenarios, each runs the backward and forward sweeps of its own
    legs, and the leg summaries and sweep outputs are all-gathered over
    the group. Its ranks are kept on one node.

There are no global tensors: every process holds its own, and each
collective is an explicit ``torch.distributed`` call over the process
group of one line of the grid. Typical use, one process per card (as
``torchrun`` starts them)::

    from aligator_tpu_torch import distributed as D
    D.initialize()                          # torch's env:// variables
    mesh = D.make_solver_mesh(legs=4)       # "b" across nodes, "t" within
    settings = ProxDDPSettings(lq_num_legs=8, lq_mesh=mesh)
    solve = D.make_batch_solver(problem, settings, mesh)
    res = solve(D.shard_batch(x0s_local, mesh))

On the CPU the same path runs over Gloo on the loopback interface
(``tests/test_torch_distributed.py``).
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from aligator_tpu_torch.utils.device import resolve_device


def _timedelta(seconds: Optional[float]):
    return None if seconds is None else datetime.timedelta(seconds=seconds)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
    timeout: Optional[float] = None,
) -> None:
    """Join the process group (``torch.distributed.init_process_group``);
    a no-op once it is initialized.

    With no arguments the rendezvous comes from torch's ``env://``
    variables (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    as ``torchrun`` sets them). ``coordinator_address`` is ``host:port``
    or a URL (``tcp://host:port``). ``backend=None`` means ``"nccl"`` when
    the process computes on a CUDA device (``device``, resolved as every
    entry point resolves it) and ``"gloo"`` otherwise. ``timeout``
    (seconds) bounds every collective of the default group, so that a rank
    whose peers never arrive fails instead of hanging."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    kw = {}
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    if timeout is not None:
        kw["timeout"] = _timedelta(timeout)
    dist.init_process_group(backend, init_method=init_method, **kw)


@dataclasses.dataclass(frozen=True, eq=False)
class SolverMesh:
    """The (b, t) grid of world ranks, batch-major with each leg group's
    ranks contiguous; where ``jax.sharding.Mesh`` stands in the JAX
    package. ``groups[axis]`` is the process group of this rank's line
    along ``axis`` (its t group for "t", its b group for "b"), ``coords``
    its index along each axis, ``device`` the device it computes on."""

    ranks: tuple  # ranks[b][t]: one row per t group
    axis_names: tuple
    coords: dict
    groups: dict
    device: torch.device

    @property
    def shape(self) -> dict:
        """Axis name → size, as ``Mesh.shape``."""
        return {self.axis_names[0]: len(self.ranks),
                self.axis_names[1]: len(self.ranks[0])}

    def group(self, axis: str):
        return self.groups[axis]


def _mesh_device(device, rank: int, local: int) -> torch.device:
    """The device of ``rank``: a CUDA device without an index is the card of
    the rank's slot on its node."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", (rank % local) % torch.cuda.device_count())
    return dev


def make_solver_mesh(
    legs: int = 1,
    ranks: Optional[Sequence[int]] = None,
    axis_names=("b", "t"),
    device=None,
    timeout: Optional[float] = None,
) -> SolverMesh:
    """The solver grid over the world: batch ("b") major, Riccati legs
    ("t") minor, ``legs`` consecutive ranks of ``ranks`` per leg group
    (``ranks`` orders all the world's ranks; default 0 … W−1). Every rank of the
    world must call this, in the same order as every other group it
    creates. ``legs=1`` gives a pure batch grid.

    Raises ``ValueError`` when the world is not divisible by ``legs``, or
    when a leg group would cross a node (nodes hold ``LOCAL_WORLD_SIZE``
    consecutive ranks; default: the whole world): the leg axis carries the
    condensed system's collectives on every LQ solve. ``timeout``
    (seconds) bounds the collectives of the mesh's groups."""
    if not dist.is_initialized():
        raise RuntimeError("call aligator_tpu_torch.distributed.initialize() first")
    world = dist.get_world_size()
    order = list(range(world)) if ranks is None else [int(r) for r in ranks]
    if sorted(order) != list(range(world)):
        raise ValueError(f"ranks must order all {world} ranks of the world: {order}")
    if world % legs != 0:
        raise ValueError(f"world size {world} not divisible by legs={legs}")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    # a leg group's index on "t" is its rank's index in the group, as
    # torch.distributed numbers the members of a group: in increasing order
    rows = [tuple(sorted(order[i:i + legs])) for i in range(0, world, legs)]
    for row in rows:
        if len({r // local for r in row}) > 1:
            raise ValueError(
                f"leg axis must not cross nodes: leg group {row} spans nodes of "
                f"LOCAL_WORLD_SIZE={local} ranks")
    cols = [tuple(row[j] for row in rows) for j in range(legs)]
    me = dist.get_rank()
    groups = {}
    tkw = {} if timeout is None else {"timeout": _timedelta(timeout)}
    # every rank creates every group, rows first, in the same order
    for axis, lines in ((axis_names[1], rows), (axis_names[0], cols)):
        for line in lines:
            g = dist.new_group(list(line), **tkw)
            if me in line:
                groups[axis] = g
    i = next(k for k, row in enumerate(rows) if me in row)
    coords = {axis_names[0]: i, axis_names[1]: rows[i].index(me)}
    return SolverMesh(ranks=tuple(rows), axis_names=tuple(axis_names), coords=coords,
                      groups=groups, device=_mesh_device(device, me, local))


def all_gather_cat(pieces: Sequence[torch.Tensor], mesh: SolverMesh,
                   axis: str) -> list:
    """All-gather each (B, n, ...) tensor over ``mesh``'s ``axis`` group
    and concatenate the ranks' pieces along dim 1, in the order of their
    index on the axis → (B, T·n, ...). The tensors (one dtype, one
    device) travel packed in one buffer, so this is one collective. NCCL
    and Gloo both take CUDA tensors here (Gloo's ``all_gather`` does in
    torch 2.11; ``chip_smoke.py``'s distributed phase runs it on a card)."""
    group, T = mesh.group(axis), mesh.shape[axis]
    B, n = pieces[0].shape[:2]
    sizes = [math.prod(p.shape[2:]) for p in pieces]
    buf = torch.cat([p.reshape(B, n, k) for p, k in zip(pieces, sizes)], dim=-1)
    out = [torch.empty_like(buf) for _ in range(T)]
    dist.all_gather(out, buf, group=group)
    full = torch.cat(out, dim=1)
    return [a.reshape((B, T * n) + p.shape[2:])
            for a, p in zip(torch.split(full, sizes, dim=-1), pieces)]


def shard_batch(x0s, mesh: SolverMesh, axis: str = "b") -> torch.Tensor:
    """This process's (B_local, nx) scenarios ``x0s`` on its device. There
    is no global tensor: each b index holds its own shard, and the ranks of
    one t group must pass the same one (they solve the same scenarios)."""
    if axis not in mesh.axis_names:
        raise ValueError(f"no axis {axis!r} in the mesh {mesh.axis_names}")
    return torch.as_tensor(x0s).to(mesh.device)


def make_batch_solver(problem, settings, mesh: SolverMesh, axis: str = "b"):
    """``solve(x0s) -> ProxDDPResults`` of this process's scenarios:
    ``problem`` (built on ``mesh.device``) with its initial states replaced
    by the shard (taken in the problem's dtype), solved by ProxDDP.
    Scenario solves never communicate; with ``settings.lq_mesh`` (and
    ``lq_num_legs``) each solve also splits its Riccati legs over the
    mesh's "t" axis."""
    from aligator_tpu_torch.solvers.proxddp import solve as proxddp_solve

    if axis not in mesh.axis_names:
        raise ValueError(f"no axis {axis!r} in the mesh {mesh.axis_names}")

    def solve(x0s):
        x0s = torch.as_tensor(x0s).to(dtype=problem.x0.dtype, device=problem.x0.device)
        return proxddp_solve(problem.replace_x0(x0s), settings)

    return solve
