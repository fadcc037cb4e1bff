"""host_syncs_per_step.mpc (syncs, program counter): the host syncs the solver counts (proxddp.sync spans, each of its site's count) a batched MPC step."""

from portbench.spans import host_syncs as read  # noqa: F401
