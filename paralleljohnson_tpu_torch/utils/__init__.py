"""Host-side utilities of the PyTorch port."""

from paralleljohnson_tpu_torch.utils.metrics import SolverStats, phase_timer

__all__ = ["SolverStats", "phase_timer"]
