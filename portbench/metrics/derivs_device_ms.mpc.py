"""derivs_device_ms.mpc (ms, device trace): device time a batched MPC step of the kernels launched inside proxddp.derivatives."""

from portbench.readers import derivs_device_ms as read  # noqa: F401
