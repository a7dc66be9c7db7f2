"""How a traffic mix drives the program: one module per entry point of
the program, named by the traffic file's ``"entry"``. Each has
``warm(run, solver, graph, sources)`` (one request, in set-up) and
``drive(run, solver, graph)`` (the closed loop of the window, which
records deliveries, requests and the outputs kept for the check on the
``run``)."""
