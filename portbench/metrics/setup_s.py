"""setup_s (s, host clock): from the process's start to the window's, kernels' load or build, inputs, the problem and the warm-up calls included."""

from portbench.readers import setup_s as read  # noqa: F401
