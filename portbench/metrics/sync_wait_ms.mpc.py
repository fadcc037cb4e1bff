"""sync_wait_ms.mpc (ms, program span): host ms a batched MPC step inside proxddp.sync spans, the host waiting for the card at the solver's syncs."""

from portbench.spans import sync_wait_ms as read  # noqa: F401
