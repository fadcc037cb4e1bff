"""cycle_ms.mpc (ms, program span): host ms a batched MPC step inside mpc.cycle and mpc.shift (the horizon's roll and the warm start's shift)."""

from portbench.spans import cycle_ms as read  # noqa: F401
