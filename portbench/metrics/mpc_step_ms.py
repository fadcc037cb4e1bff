"""mpc_step_ms (ms, host clock): the window's time over the batched mpc_step calls it completed."""

from portbench.readers import step_ms as read  # noqa: F401
