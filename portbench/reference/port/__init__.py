"""A frozen copy of the plain serial float64 path of the port
(``aligator_tpu_torch`` as of the benchmark's first version): the problem
layer, costs, constraints, manifolds, dynamics, multibody and contact
algorithms, the serial proximal Riccati recursion, ProxDDP and the MPC step.

It serves as the benchmark's reference and imports nothing of the port.
Changes from the source: imports renamed to this package; ProxDDP keeps the
serial LQ solver only, leaves the matmul precision to its caller and prints
no iteration rows; the talos-like URDF is read from ``../assets``. Later
changes to the port do not reach this copy: it is the yardstick.
"""
