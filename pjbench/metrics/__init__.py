"""Metric readers, one module per metric of ``BENCHMARK.json``, found by
the metric's name. Each has ``read(run)``: the metric's value from the
run's record (``harness.Run``), or None where the run has nothing for it
to read, so that the metric is left out of the result line."""
