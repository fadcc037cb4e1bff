"""kernels_per_step.mpc (kernels, device trace): device operations a batched MPC step, the benchmark's sampling left out."""

from portbench.readers import kernels_per_call as read  # noqa: F401
