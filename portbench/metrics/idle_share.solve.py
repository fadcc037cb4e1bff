"""idle_share.solve (%, device trace): the share of a traced window of solves in which no kernel ran."""

from portbench.readers import idle_share as read  # noqa: F401
