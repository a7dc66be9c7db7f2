"""Solver orchestration of the PyTorch port."""

from paralleljohnson_tpu_torch.solver.johnson import (
    ConvergenceError,
    NegativeCycleError,
    ParallelJohnsonSolver,
    SolveResult,
    ValidationError,
)

__all__ = [
    "ConvergenceError",
    "NegativeCycleError",
    "ParallelJohnsonSolver",
    "SolveResult",
    "ValidationError",
]
