"""The control at each cell's own size, on the card: the reference's copy
put in the port's place in float32 with TF32 products (the precision below
the configurations' float32 with TF32 off) must come out not correct by the
cell's limits, on three seeds. The window is one call (one step after the
settle steps), the comparison as in every run."""

import pytest
import torch

from portbench.core import data, manifest
from portbench.run import run_cell
from portbench.systems import Reference

CELLS = manifest()["workloads"]


@pytest.mark.card
@pytest.mark.parametrize("w", CELLS, ids=lambda w: w["name"])
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303])
def test_control_is_not_correct(card, w, seed):
    sizes = data("configs", w["config"])
    control = Reference(w["config"], sizes, card, dtype=torch.float32, tf32=True)
    try:
        out, _ = run_cell(w["name"], seed, 1e-9, False, device=card, system=control)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    assert not out["correct"], out["checks"]
