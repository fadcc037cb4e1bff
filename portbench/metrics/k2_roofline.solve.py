"""k2_roofline.solve (%, device trace): K2's bound from its shapes over its device time a sweep, in a window of solves."""

from portbench.readers import k2_roofline as read  # noqa: F401
