"""kernels_per_batch_solve (kernels, device trace): device operations a batched solve, the benchmark's sampling left out."""

from portbench.readers import kernels_per_call as read  # noqa: F401
