"""solves_per_s (solves/s, host clock): instances solved in the window (all of each batched solve, or those that converged where the configuration counts convergence) over the window's time."""

from portbench.readers import solves_per_s as read  # noqa: F401
