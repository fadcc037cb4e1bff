"""iters_per_solve (iterations, program counter): the mean of results.num_iters over every instance of the window."""

from portbench.readers import iters_per_solve as read  # noqa: F401
