"""The plain reference: Johnson's shortest paths as Bellman-Ford and a
min over the benchmark's own CSR arrays, in plain PyTorch ops (on the
card or the CPU). It imports nothing of the program and takes nothing the
program made: it works the potentials, the reweighting and the rows out
again from the arrays the benchmark handed the program."""
