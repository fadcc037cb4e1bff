"""initial_solve_ms.solve (ms, program span): host ms a batched solve inside gar.initial_solve, the initial-stage KKT solve after each backward sweep."""

from portbench.spans import initial_solve_ms as read  # noqa: F401
