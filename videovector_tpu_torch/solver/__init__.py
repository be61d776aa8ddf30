"""The solver: Caffe's update rules, snapshots and the training loop."""

from videovector_tpu_torch.solver.solvers import (  # noqa: F401
    SolverConfig, init_solver_state, learning_rate, solver_update,
)
