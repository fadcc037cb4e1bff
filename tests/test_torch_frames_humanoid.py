"""Every residual of the port's ``functions/frames.py`` on the
talos-dimension humanoid against the JAX package in float64 on the CPU,
as ``test_torch_frames_geometry.py`` checks them on the serial chain and
the UR5 (a file of its own, so that the two run side by side): value,
value and Jacobian from one pass, and the Jacobians, 1e-10·max(1,
max|ref|)."""

import pytest
import torch

from test_torch_frames_geometry import RESIDUALS, _robot, check_residual

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def humanoid():
    return _robot("humanoid")


@pytest.mark.parametrize("name", RESIDUALS)
def test_frame_residuals_on_the_humanoid_match_jax(humanoid, name):
    check_residual(humanoid, name)
