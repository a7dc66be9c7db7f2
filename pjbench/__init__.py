"""pjbench: the benchmark of ``paralleljohnson_tpu_torch`` on NVIDIA cards.

One run is ``python3 pjbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout. The cells,
configurations, traffic mixes and metrics are data: ``BENCHMARK.json``
at the root names them, and the harness finds each one's file by name
(``configs/<name>.json``, ``traffic/<name>.json``, ``metrics/<name>.py``,
``generators/<kind>.py``). ``reference/`` holds the plain shortest-path
reference that decides ``correct``; ``frozen/`` the yardstick (the
sweep's byte model and the card's peaks), copied here so that a change
to the program cannot move it.

Nothing here imports JAX or the JAX package, and ``reference/`` imports
nothing of the program.
"""
