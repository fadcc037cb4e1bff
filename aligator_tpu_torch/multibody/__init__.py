"""Rigid-body dynamics layer of the port (``aligator_tpu.multibody``):
spatial algebra, the multibody model and its builders, its algorithms,
collision geometry, phase spaces, URDF import and export, and contact
dynamics."""

from aligator_tpu_torch.multibody.algorithms import (
    aba,
    centroidal_momentum,
    com_position,
    crba,
    forward_kinematics,
    frame_jacobian_local,
    frame_placement,
    frame_velocity,
    fwd_dynamics,
    gravity_torque,
    mass_matrix,
    mass_matrix_and_bias,
    mass_matrix_rnea,
    nonlinear_effects,
    rnea,
)
from aligator_tpu_torch.multibody.contact import (
    ContactSet,
    ContactSpec,
    anchor_at_configuration,
    constrained_dynamics,
    contact_forces,
    contact_slice,
    make_contact_set,
    underactuated_constrained_inverse_dynamics,
)
from aligator_tpu_torch.multibody.geometry import GeomObject, pair_distance
from aligator_tpu_torch.multibody.model import (
    FrameSpec,
    JointSpec,
    MultibodyModel,
    build_humanoid,
    build_quadruped,
    build_serial_chain,
    humanoid_half_sitting,
    quadruped_standing,
)
from aligator_tpu_torch.multibody.spaces import (
    MultibodyConfiguration,
    MultibodyPhaseSpace,
)
from aligator_tpu_torch.multibody.spatial import (
    SE3T,
    Inertia,
    se3_act_force,
    se3_act_inv_motion,
    se3_act_motion,
    se3_adjoint,
    se3_inv,
    se3_log,
    se3_mul,
    so3_log,
)
from aligator_tpu_torch.multibody.urdf import load_talos_like, load_ur5, load_urdf, model_to_urdf
