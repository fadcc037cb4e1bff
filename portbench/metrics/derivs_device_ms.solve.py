"""derivs_device_ms.solve (ms, device trace): device time a batched solve of the kernels launched inside proxddp.derivatives."""

from portbench.readers import derivs_device_ms as read  # noqa: F401
