"""PyTorch port on the card: each hand CUDA kernel against its plain
PyTorch version, and ``solve()`` on the card against ``solve()`` on the
CPU. Every test needs a CUDA device and skips without one.

This file imports nothing of JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest`` skips ``tests/conftest.py``, which configures JAX for
the reference's tests.)"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paralleljohnson_tpu_torch as pjt
from paralleljohnson_tpu_torch.ops import fanout_sweep as fs
from paralleljohnson_tpu_torch.ops.minplus import minplus_kernel, minplus_plain


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand kernels run only on the card")
    return torch.device("cuda")


def _layout(g, device):
    e = g.num_real_edges
    src = torch.as_tensor(g.src[:e]).to(device)
    dst = torch.as_tensor(g.indices[:e]).to(device)
    lay = fs.build_in_edge_layout(src, dst, g.num_nodes)
    w_in = torch.as_tensor(g.weights[:e]).to(device)[lay["order"]].contiguous()
    return lay["indptr_in"], lay["src_in"], w_in


def _dist0(sources, rows, b, device):
    d = torch.full((rows, b), float("inf"), device=device)
    d[torch.as_tensor(sources, device=device),
      torch.arange(b, device=device)] = 0.0
    return d


def _operands(rng, i, k, j, inf_frac=0.3):
    d = rng.random((i, k)).astype(np.float32)
    a = rng.random((k, j)).astype(np.float32)
    d[rng.random((i, k)) < inf_frac] = np.inf
    a[rng.random((k, j)) < inf_frac] = np.inf
    return d, a


@pytest.mark.parametrize("b", [1, 5, 128, 200, 512])
def test_fanout_sweep_kernel_equals_plain(cuda, b):
    """B=1/5/200 take the scalar lane path, 128/512 the float4 path; 200
    also has a ragged second column tile."""
    g = pjt.load_graph("rmat:scale=12,ef=16,seed=3")
    layout = _layout(g, cuda)
    sources = np.random.default_rng(b).integers(0, g.num_nodes, b)
    d = _dist0(sources, g.num_nodes, b, cuda)
    for _ in range(3):  # a block with finite values to fold
        d, _ = fs.fanout_sweep_plain(d, *layout)
    before = fs.fanout_sweep.launches
    got, flag = fs.fanout_sweep(d, *layout)
    want, imp = fs.fanout_sweep_plain(d, *layout)
    torch.cuda.synchronize()
    assert fs.fanout_sweep.launches == before + 1
    assert torch.equal(got, want)
    assert bool(flag.item()) == bool(imp)


def test_fanout_fixpoint_on_card_equals_cpu(cuda):
    g = pjt.load_graph("grid:rows=30,cols=40,seed=7")
    sources = np.arange(0, g.num_nodes, 97)
    b = len(sources)
    want, it_w, imp_w = fs.fanout_fixpoint(
        _dist0(sources, g.num_nodes, b, "cpu"), *_layout(g, "cpu"),
        max_iter=g.num_nodes,
    )
    got, it, imp = fs.fanout_fixpoint(
        _dist0(sources, g.num_nodes, b, cuda), *_layout(g, cuda),
        max_iter=g.num_nodes,
    )
    assert torch.equal(got.cpu(), want)
    assert (it, imp) == (it_w, imp_w)


def test_fanout_sweep_rejects_bad_inputs(cuda):
    g = pjt.load_graph("rmat:scale=6,ef=4,seed=0")
    indptr_in, src_in, w_in = _layout(g, cuda)
    d = torch.zeros((g.num_nodes, 4), device=cuda)
    with pytest.raises(TypeError):
        fs.fanout_sweep(d.double(), indptr_in, src_in, w_in)
    with pytest.raises(ValueError, match="contiguous"):
        fs.fanout_sweep(torch.zeros((4, g.num_nodes), device=cuda).t(),
                        indptr_in, src_in, w_in)
    with pytest.raises(ValueError, match="is on cpu"):
        fs.fanout_sweep(d, indptr_in.cpu(), src_in, w_in)


@pytest.mark.parametrize("shape", [(5, 7, 9), (8, 128, 128), (100, 300, 50),
                                   (1, 1, 1), (64, 33, 65), (3, 129, 2),
                                   (1000, 777, 513)])
def test_minplus_kernel_equals_plain(cuda, shape):
    i, k, j = shape
    d, a = _operands(np.random.default_rng(sum(shape)), i, k, j)
    d, a = torch.as_tensor(d).to(cuda), torch.as_tensor(a).to(cuda)
    before = minplus_kernel.launches
    got = minplus_kernel(d, a)
    torch.cuda.synchronize()
    assert minplus_kernel.launches == before + 1
    assert torch.equal(got, minplus_plain(d, a))


def test_minplus_all_inf_rows(cuda):
    d = torch.full((70, 90), float("inf"), device=cuda)
    d[5, 3] = 2.0
    a = torch.rand((90, 130), device=cuda)
    got = minplus_kernel(d, a)
    assert torch.equal(got, minplus_plain(d, a))
    assert torch.isinf(got[torch.arange(70, device=cuda) != 5]).all()


def test_minplus_rejects_bad_inputs(cuda):
    d = torch.zeros((4, 5), device=cuda)
    with pytest.raises(ValueError, match="disagree"):
        minplus_kernel(d, torch.zeros((6, 3), device=cuda))
    with pytest.raises(TypeError):
        minplus_kernel(d.double(), torch.zeros((5, 3), device=cuda).double())
    with pytest.raises(ValueError, match="contiguous"):
        minplus_kernel(torch.zeros((5, 4), device=cuda).t(),
                       torch.zeros((5, 3), device=cuda))


SPECS = ["dag:n=90,p=0.08,neg=0.4,seed=3", "er:n=48,p=0.12,seed=5",
         "grid:rows=9,cols=11,neg=0.2,seed=1", "rmat:scale=8,ef=8,seed=2"]


@pytest.mark.parametrize("spec", SPECS)
def test_solve_on_card_equals_cpu(cuda, spec):
    g = pjt.load_graph(spec)
    want = pjt.ParallelJohnsonSolver(device="cpu").solve(g)
    got = pjt.ParallelJohnsonSolver(device=cuda).solve(g)
    assert got.stats.routes_by_phase == want.stats.routes_by_phase
    np.testing.assert_array_equal(got.matrix, want.matrix)


def test_use_pallas_false_raises_on_card(cuda):
    g = pjt.load_graph(SPECS[0])
    with pytest.raises(NotImplementedError, match="use_pallas"):
        pjt.ParallelJohnsonSolver(pjt.SolverConfig(use_pallas=False),
                                  device=cuda).solve(g)
