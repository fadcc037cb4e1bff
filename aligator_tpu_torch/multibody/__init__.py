"""Rigid-body dynamics layer of the port (``aligator_tpu.multibody``):
spatial algebra, the multibody model, its algorithms, phase spaces and
contact dynamics."""

from aligator_tpu_torch.multibody.algorithms import (
    aba,
    crba,
    forward_kinematics,
    frame_placement,
    fwd_dynamics,
    mass_matrix_and_bias,
    rnea,
)
from aligator_tpu_torch.multibody.contact import (
    ContactSet,
    ContactSpec,
    anchor_at_configuration,
    constrained_dynamics,
    make_contact_set,
)
from aligator_tpu_torch.multibody.model import (
    FrameSpec,
    JointSpec,
    MultibodyModel,
    build_humanoid,
    humanoid_half_sitting,
)
from aligator_tpu_torch.multibody.spaces import (
    MultibodyConfiguration,
    MultibodyPhaseSpace,
)
from aligator_tpu_torch.multibody.spatial import SE3T, se3_log, so3_log
from aligator_tpu_torch.multibody.urdf import load_talos_like, load_urdf
