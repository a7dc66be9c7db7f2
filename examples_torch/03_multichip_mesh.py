"""Source-parallel APSP over the default mesh, on the PyTorch port.

The fan-out's parallel dimension is sources: the in-edge CSC is copied
to every rank, the source batch shards over a 1-D mesh, and the ranks'
rows are assembled on the caller's card. With no ``mesh_shape`` a solve
takes every card ``CUDA_VISIBLE_DEVICES`` leaves visible (a rank per
card, NCCL between them), as the JAX package takes every device:

    python examples_torch/03_multichip_mesh.py

``--device cpu`` runs it on CPU ranks instead; torch sees one CPU
device, so list the ranks:

    PJ_MESH_DEVICES='cpu*8' python examples_torch/03_multichip_mesh.py --device cpu
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import paralleljohnson_tpu_torch as pjt  # noqa: E402
from paralleljohnson_tpu_torch.parallel import mesh  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda")
ap.add_argument("--sources", type=int, default=256)
args = ap.parse_args()

g = pjt.load_graph("rmat:scale=12,ef=16,seed=1")
with pjt.ParallelJohnsonSolver(pjt.SolverConfig(), device=args.device) as solver:
    print("ranks:", [str(d) for d in mesh.default_devices(args.device)])
    res = solver.multi_source(g, np.arange(args.sources))
    print("mesh:", solver.backend._mesh().describe())
print(f"sharded fan-out ({res.stats.routes_by_phase['fanout']}): dist "
      f"{tuple(res.dist.shape)}, {res.stats.edges_relaxed:,} edges relaxed "
      "across the mesh")
