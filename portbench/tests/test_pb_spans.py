"""The port's span log and sync counters against the card, on the card:
a span holds the kernel it waited for, on the trace's own clock; and over
a batched lqr56 solve, every host sync that torch's sync detection flags
in the solver is a site the solver counts, and the two counts agree."""

import ast
import inspect
from pathlib import Path

import pytest
import torch

from portbench.core import CHECKOUT, data
from portbench.trace import SPIN


@pytest.mark.card
def test_a_span_holds_its_kernel_on_the_traces_clock(card):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from aligator_tpu_torch.utils import profiling as P

    P.reset()
    torch.cuda.synchronize(card)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(256):  # the first kernels of a trace may be missing from it
            torch.cuda._sleep(1000)
        torch.cuda.synchronize(card)
        for _ in range(5):
            with P.span("pb.sleep"):
                torch.cuda._sleep(2_000_000)  # ~1 ms
                torch.cuda.synchronize(card)
    mine = [r for r in P.spans() if r.name == "pb.sleep"]
    kernels = sorted((e for e in prof.profiler.kineto_results.events()
                      if e.device_type() == DeviceType.CUDA and SPIN in e.name()),
                     key=lambda e: e.start_ns())[-5:]
    assert len(mine) == len(kernels) == 5
    for r, k in zip(mine, kernels):
        assert k.end_ns() - k.start_ns() > 100_000
        assert r.start_ns <= k.start_ns() <= k.end_ns() <= r.end_ns, (
            r.start_ns, k.start_ns(), k.end_ns(), r.end_ns)


def _counted_lines() -> set:
    """(file, line) of each statement whose syncs the solver counts: the
    read inside ``profiling.host_flag``, and every statement inside a
    ``host_sync`` block of ``solvers/``."""
    from aligator_tpu_torch.solvers import linesearch, proxddp
    from aligator_tpu_torch.utils import profiling as P

    src, start = inspect.getsourcelines(P.host_flag)
    lines = {(str(Path(P.__file__).resolve()), start + k)
             for k, text in enumerate(src) if "bool(t)" in text}
    for mod in (proxddp, linesearch):
        path = str(Path(mod.__file__).resolve())
        for node in ast.walk(ast.parse(Path(path).read_text())):
            if isinstance(node, ast.With) and any(
                    "host_sync" in ast.unparse(item.context_expr) for item in node.items):
                lines |= {(path, n) for n in range(node.body[0].lineno,
                                                   node.body[-1].end_lineno + 1)}
    return lines


@pytest.mark.card
def test_the_solvers_sync_count_agrees_with_torchs(card):
    import chip_smoke
    from aligator_tpu_torch.utils import profiling as P
    from portbench.systems import Program
    from portbench.window import Mix

    sizes, traffic = data("configs", "lqr56"), data("traffic", "solve.b1024")
    mix = Mix(Program("lqr56", sizes, card), sizes, traffic, 2 ** 31 + 77, card)
    mix.setup()
    z = mix.cfg.noise(sizes, mix.gen, mix.batch, mix.scale, card)
    before, sites = P.counters(), {}
    chip_smoke.count_syncs(lambda: mix.kind.step(mix, z), sites)
    after = P.counters()
    counted = sum(after[k] - before.get(k, 0) for k in after if k.startswith(P.SYNC_COUNTER))

    def where(key):
        path, line = key.rsplit(":", 1)
        return str(Path(path).resolve()), int(line)

    solver_dir = str(CHECKOUT / "aligator_tpu_torch" / "solvers")
    ok = _counted_lines()
    flagged = {where(k): n for k, n in sites.items()}
    stray = {k: n for k, n in flagged.items() if k[0].startswith(solver_dir) and k not in ok}
    assert not stray, f"syncs the solver does not count: {stray}"
    assert counted > 0
    assert sum(n for k, n in flagged.items() if k in ok) == counted, (flagged, after)
