"""host_syncs_per_solve (syncs, program counter): the host syncs the solver counts (proxddp.sync spans, each of its site's count) a batched solve."""

from portbench.spans import host_syncs as read  # noqa: F401
