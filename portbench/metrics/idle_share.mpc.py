"""idle_share.mpc (%, device trace): the share of a traced window of MPC steps in which no kernel ran."""

from portbench.readers import idle_share as read  # noqa: F401
