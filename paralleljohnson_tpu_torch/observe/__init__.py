"""Observability of the PyTorch port: the convergence trajectory
counters (``convergence``)."""
