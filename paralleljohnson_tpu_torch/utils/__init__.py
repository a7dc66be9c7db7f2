"""Host-side utilities of the PyTorch port."""

from paralleljohnson_tpu_torch.utils.checkpoint import BatchCheckpointer
from paralleljohnson_tpu_torch.utils.metrics import SolverStats, phase_timer

__all__ = ["BatchCheckpointer", "SolverStats", "phase_timer"]
