"""PyTorch port: the mesh's in-process exchange (``parallel.mesh``), on
eight CPU ranks (``PJ_MESH_DEVICES=cpu*8``: eight threads of one process).

The rank threads of one process trade tensors through one exchange per
collective group and run: no ``torch.distributed`` process group. These
cases hold the collectives to a plain fold in rank order (bitwise), and
hold the failure contract: a failing rank releases its peers, members
that post different specs all raise, and the next run on the same mesh
completes. Every barrier is bounded by ``parallel.mesh.DEFAULT_TIMEOUT_S``
= 30 s."""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paralleljohnson_tpu_torch as pjt
from paralleljohnson_tpu_torch.graphs import random_dag
from paralleljohnson_tpu_torch.parallel import make_mesh, make_mesh_2d
from paralleljohnson_tpu_torch.parallel import mesh as mesh_mod


@pytest.fixture(autouse=True)
def _eight_cpu_ranks(monkeypatch):
    monkeypatch.setenv("PJ_MESH_DEVICES", "cpu*8")
    monkeypatch.setattr(mesh_mod, "DEFAULT_TIMEOUT_S", 30.0)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blocks(seed, n, shape, dtype):
    """One integer-valued block per rank, some entries +inf."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.integers(-50, 50, shape).astype(np.float64)
        x[rng.random(shape) < 0.2] = np.inf
        out.append(x.astype(dtype))
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("axes", [("edges",), None])
def test_collectives_equal_a_plain_fold(axes, dtype):
    """On a 4 x 2 mesh, three rounds of a MIN all-reduce over ``axes``
    (each source row's "edges" group, or the whole mesh), an all-gather
    and an integer gather, back to back: each rank's reduced block is
    the plain minimum folded over its group's blocks in rank order, the
    gathered blocks are every rank's in rank order, bitwise."""
    mesh = make_mesh_2d((4, 2))
    rounds = [_blocks(seed, mesh.size, (37, 5), dtype) for seed in range(3)]

    def body(comm):
        out = []
        for k, blocks in enumerate(rounds):
            x = torch.as_tensor(blocks[comm.rank].copy())
            comm.all_reduce_min_(x, axes)
            gathered = comm.all_gather(x)
            ints = comm.gather_ints([comm.rank, k])
            out.append((x.numpy(), [g.numpy() for g in gathered], ints))
        return out

    got = mesh.run(body)
    key = mesh.axis_names if axes is None else axes
    for k, blocks in enumerate(rounds):
        want = []
        for r in range(mesh.size):
            fold = blocks[mesh.members(r, key)[0]]
            for m in mesh.members(r, key)[1:]:
                fold = np.minimum(fold, blocks[m])
            want.append(fold)
        for r in range(mesh.size):
            x, gathered, ints = got[r][k]
            assert x.dtype == dtype and x.tobytes() == want[r].tobytes()
            assert [g.tobytes() for g in gathered] == [
                w.tobytes() for w in want]
            np.testing.assert_array_equal(
                ints, [[m, k] for m in range(mesh.size)])


@pytest.mark.parametrize("fail_at", [0, 1])
@pytest.mark.parametrize("shape", [(8,), (4, 2)])
def test_a_failing_rank_releases_its_peers(shape, fail_at):
    """A rank that raises before its first collective (``fail_at=0``) or
    between two (``fail_at=1``): every other rank leaves with
    ``MeshAborted``, the caller gets the root error, and the next run on
    the same mesh completes; on a 2-D mesh too, where the collectives
    alternate between the "edges" group and the whole mesh."""
    mesh = make_mesh(shape) if len(shape) == 1 else make_mesh_2d(shape)
    groups = [("edges",), None] if len(shape) == 2 else [None]
    seen = {}

    def body(comm):
        x = torch.full((6,), float(comm.rank))
        try:
            for step in range(2):
                if comm.rank == 1 and step == fail_at:
                    raise KeyError("rank 1")
                for axes in groups:
                    comm.all_reduce_min_(x, axes)
        except BaseException as e:
            seen[comm.rank] = type(e).__name__
            raise
        return x

    for _ in range(2):
        seen.clear()
        t0 = time.perf_counter()
        with pytest.raises(KeyError, match="rank 1"):
            mesh.run(body)
        assert time.perf_counter() - t0 < 10.0
        assert seen == {r: "KeyError" if r == 1 else "MeshAborted"
                        for r in range(mesh.size)}

        def good(comm):
            x = torch.full((6,), float(comm.rank))
            return float(comm.all_reduce_min_(x).max())

        assert mesh.run(good) == [0.0] * mesh.size


@pytest.mark.parametrize("mismatch", ["shape", "dtype", "kind"])
def test_members_posting_different_specs_all_raise(mismatch):
    """Members of a group that post different specs (a shape, a dtype, a
    collective of another kind): every member raises ``ValueError``
    naming its spec and the other's, none waits for the barrier's
    timeout, and the next run on the same mesh completes."""
    mesh = make_mesh((4,))
    seen = {}

    def body(comm):
        odd = comm.rank == 2
        x = torch.zeros((5, 3) if odd and mismatch == "shape" else (5, 4),
                        dtype=torch.float64 if odd and mismatch == "dtype"
                        else torch.float32)
        try:
            if odd and mismatch == "kind":
                return comm.all_gather(x)
            return comm.all_reduce_min_(x)
        except BaseException as e:
            seen[comm.rank] = type(e).__name__
            raise

    t0 = time.perf_counter()
    with pytest.raises(ValueError, match=r"rank \d posted .* rank \d "
                                         r"posted"):
        mesh.run(body)
    assert time.perf_counter() - t0 < mesh_mod.DEFAULT_TIMEOUT_S / 3
    assert seen == {r: "ValueError" for r in range(4)}
    assert mesh.run(lambda comm: comm.gather_ints([comm.rank]).tolist()) == [
        [[0], [1], [2], [3]]] * 4


def _no_process_groups(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("an in-process mesh built a process group")

    for name in ("ProcessGroupNCCL", "ProcessGroupGloo", "new_group",
                 "init_process_group", "HashStore"):
        if hasattr(mesh_mod.tdist, name):
            monkeypatch.setattr(mesh_mod.tdist, name, refuse)


@pytest.mark.parametrize("shape,fanout", [((8,), "sharded-1d+pred"),
                                          ((4, 2), "sharded-2d+pred")])
def test_in_process_runs_build_no_process_group(monkeypatch, shape, fanout):
    """With every ``torch.distributed`` process-group constructor made to
    raise, an in-process mesh still solves: edge-sharded phase 1, then
    the sharded fan-out with trees on a 1-D and a 2-D mesh, rows equal to
    one rank's."""
    _no_process_groups(monkeypatch)
    g = random_dag(56, 0.12, negative_fraction=0.4, seed=43)
    g = g.with_weights(np.round(g.weights * 8))
    sources = np.arange(24)
    with pjt.ParallelJohnsonSolver(
            pjt.SolverConfig(mesh_shape=shape, edge_shard=True),
            device="cpu") as solver:
        res = solver.solve(g, sources, predecessors=True)
        assert solver.backend._mesh().backends() == ["threads"]
        assert solver.backend._mesh().describe().endswith(
            "(threads: CPU ranks)")
    assert dict(res.stats.routes_by_phase) == {"bellman_ford": "edge-sharded",
                                               "fanout": fanout}
    one = pjt.ParallelJohnsonSolver(pjt.SolverConfig(mesh_shape=(1,)),
                                    device="cpu").solve(g, sources)
    np.testing.assert_array_equal(res.matrix, one.matrix)


def test_collective_seconds_count_the_barrier_wait():
    """``Mesh.collective_s`` adds the slowest rank's seconds in
    collectives, its wait at the barrier for a late peer included; a CPU
    mesh sets up no peer access."""
    mesh = make_mesh((4,))
    late = 0.3

    def body(comm):
        if comm.rank == 3:
            time.sleep(late)
        return comm.gather_ints([comm.rank])

    got = mesh.run(body)
    assert all(g[:, 0].tolist() == [0, 1, 2, 3] for g in got)
    assert late * 0.8 <= mesh.collective_s < late + 5.0
    assert mesh.peer_access() == {}


def test_many_rounds_under_fast_thread_switches(monkeypatch):
    """Sixteen rank threads (more than this host's cores) on an 8 x 2
    mesh, 200 rounds of an "edges" MIN all-reduce, an all-gather and an
    integer gather each, with the interpreter switching threads every
    microsecond: every round's results are exact, so no rank read a slot
    a faster peer had already refilled for the next collective."""
    import sys

    monkeypatch.setenv("PJ_MESH_DEVICES", "cpu*16")
    mesh = make_mesh_2d((8, 2))
    rounds = 200

    def body(comm):
        bad = 0
        for k in range(rounds):
            x = torch.full((3,), float(k * 100 + comm.rank))
            comm.all_reduce_min_(x, ("edges",))
            low = mesh.members(comm.rank, ("edges",))[0]
            bad += int((x != k * 100 + low).sum())
            rows = comm.all_gather(torch.tensor([k, comm.rank]))
            bad += int(torch.stack(rows).tolist() != [[k, r] for r in
                                                      range(16)])
            ints = comm.gather_ints([k * 16 + comm.rank])
            bad += int(ints[:, 0].tolist() != [k * 16 + r
                                               for r in range(16)])
        return bad

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.perf_counter()
        got = mesh.run(body)
    finally:
        sys.setswitchinterval(switch)
    assert got == [0] * 16
    assert time.perf_counter() - t0 < 60.0
