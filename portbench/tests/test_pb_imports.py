"""What the benchmark's processes load: no ``jax``, ``jaxlib``, ``flax`` or
``aligator_tpu`` (top-level names compared whole: ``aligator_tpu_torch``
is the port), and the reference nothing of the port either."""

import json
import subprocess
import sys

from portbench.core import CHECKOUT

PROBE = """
import json, sys
{imports}
print(json.dumps(sorted({{k.split(".")[0] for k in sys.modules}})))
"""


def _top_level(imports: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(imports=imports)], cwd=CHECKOUT,
                         capture_output=True, text=True, check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    names = _top_level("import portbench.run, portbench.calibrate\n"
                       "from portbench.systems import Program\n"
                       "import torch\n"
                       "Program('lqr56', {'dtype': 'float32'}, torch.device('cpu'))\n"
                       "import portbench.reference.port.examples.talos_walk")
    assert not names & {"jax", "jaxlib", "flax", "aligator_tpu"}
    assert "aligator_tpu_torch" in names  # the program itself, loaded by Program


def test_the_reference_loads_nothing_of_the_port():
    names = _top_level("import portbench.reference.lqr56, portbench.reference.talos_walk\n"
                       "import portbench.reference.port.mpc, portbench.check")
    assert not names & {"jax", "jaxlib", "flax", "aligator_tpu", "aligator_tpu_torch"}


def test_a_run_with_jax_loaded_gives_no_result(monkeypatch):
    """The run refuses, and prints nothing, where JAX is loaded once the
    window has closed."""
    import types

    import pytest
    import torch

    from portbench.core import data
    from portbench.run import Refused, run_cell

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    traffic = {**data("traffic", "solve.b1024"), "batch": 2, "warmup_calls": 0}
    with pytest.raises(Refused, match="jax"):
        run_cell("lqr56.solve.b1024", 1, 1e-9, False, device=torch.device("cpu"),
                 sizes={**data("configs", "lqr56"), "nsteps": 4}, traffic=traffic)


def test_no_card_no_result():
    """Without a CUDA card the command exits non-zero with no result line."""
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here: the refusal is for machines without one")
    out = subprocess.run([sys.executable, "-c", "import sys\n"
                          "from portbench.run import main\n"
                          "sys.exit(main(['--workload', 'lqr56.solve.b1024', '--seed', '1',"
                          " '--seconds', '1']))"],
                         cwd=CHECKOUT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "correct" not in out.stdout
