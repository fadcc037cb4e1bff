"""derivs_idle_ms.solve (ms, program span): device idle ms a batched solve while the host is inside problem.derivatives (the gaps between kernels intersected with its spans)."""

from portbench.spans import derivs_idle_ms as read  # noqa: F401
