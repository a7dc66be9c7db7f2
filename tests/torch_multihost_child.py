"""Child process of the port's two-process test
(``tests/test_torch_multihost.py``): ``multihost.initialize`` over a
localhost gloo group, one CPU rank per process, then the sharded fan-out
with the explicit all-gather on a host-padded off-multiple batch. Prints
``MHOK`` with the row-sweep total and a digest of the rows. Not a test.

    python tests/torch_multihost_child.py <process_id> <num_processes> <port>
"""

import hashlib
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(process_id: int, num_processes: int, port: int) -> None:
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csgraph
    import torch

    from paralleljohnson_tpu_torch.graphs import erdos_renyi
    from paralleljohnson_tpu_torch.parallel import multihost
    from paralleljohnson_tpu_torch.parallel.mesh import sharded_fanout

    torch.set_num_threads(1)
    assert multihost.initialize(
        coordinator_address=f"127.0.0.1:{port}", num_processes=num_processes,
        process_id=process_id, device="cpu", timeout_s=60)
    info = multihost.process_info()
    assert info["process_count"] == num_processes, info
    assert info["global_devices"] == num_processes, info

    g = erdos_renyi(48, 0.12, seed=5)  # the same graph in every process
    mesh = multihost.global_mesh(device="cpu")
    assert mesh.multiprocess and mesh.size == num_processes
    b = 11  # off-multiple of the ranks: the host pads
    srcs = np.arange(b)
    garr = multihost.global_sources(mesh, srcs)
    dist, iters, improving, row_sweeps = sharded_fanout(
        mesh, garr, torch.as_tensor(g.src, dtype=torch.int32),
        torch.as_tensor(g.indices, dtype=torch.int32),
        torch.as_tensor(g.weights, dtype=torch.float32),
        num_nodes=g.num_nodes, max_iter=g.num_nodes, replicate=True,
        with_row_sweeps=True, n_real_rows=b)
    assert not improving
    rows = dist.numpy()[:b]
    mat = sp.csr_matrix((g.weights.astype(np.float64), g.indices, g.indptr),
                        shape=(g.num_nodes, g.num_nodes))
    oracle = csgraph.dijkstra(mat, directed=True, indices=srcs)
    assert np.allclose(rows, oracle, rtol=1e-5, atol=1e-5), "oracle mismatch"
    assert b <= row_sweeps <= iters * b, (row_sweeps, iters)
    digest = hashlib.sha256(np.ascontiguousarray(rows).tobytes()).hexdigest()
    print(f"MHOK pid={process_id} row_sweeps={row_sweeps} iters={iters} "
          f"rows={digest}", flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
