"""k1_roofline.solve (%, device trace): K1's bound from its shapes over its device time a launch, in a window of solves."""

from portbench.readers import k1_roofline as read  # noqa: F401
