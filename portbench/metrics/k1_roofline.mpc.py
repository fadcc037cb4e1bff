"""k1_roofline.mpc (%, device trace): K1's bound from its shapes over its device time a launch, in a window of MPC steps."""

from portbench.readers import k1_roofline as read  # noqa: F401
