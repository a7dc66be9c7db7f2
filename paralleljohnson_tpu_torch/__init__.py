"""paralleljohnson_tpu_torch — Johnson all-pairs shortest paths in PyTorch
on an NVIDIA H100, with hand-written CUDA kernels for the batched fan-out
sweep and the min-plus product.

The port of the JAX package ``paralleljohnson_tpu``, which stays the
reference it is tested against. Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU.

    import paralleljohnson_tpu_torch as pjt
    g = pjt.load_graph("dag:n=300,p=0.02,neg=0.4,seed=42")
    res = pjt.ParallelJohnsonSolver(pjt.SolverConfig()).solve(g)
"""

from paralleljohnson_tpu_torch.backends import get_backend
from paralleljohnson_tpu_torch.config import SolverConfig
from paralleljohnson_tpu_torch.graphs import CSRGraph, load_graph
from paralleljohnson_tpu_torch.solver import (
    ConvergenceError,
    NegativeCycleError,
    ParallelJohnsonSolver,
)

__all__ = [
    "CSRGraph",
    "ConvergenceError",
    "NegativeCycleError",
    "ParallelJohnsonSolver",
    "SolverConfig",
    "get_backend",
    "load_graph",
]
