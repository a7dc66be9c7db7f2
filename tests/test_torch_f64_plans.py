"""The f64 kernels' host-side plans, on the CPU: the fan-out sweep's hub
set (the sources whose rows the f64 kernel keeps in L2, which the f64
tight-edge pass takes too), the f64 min-plus launch plan and the f64
Kleene closure's rounds. The kernels themselves are held against their plain
versions on the card (``tests/test_torch_cuda.py``); here the pure
functions that choose what they are given."""

import numpy as np
import pytest
import torch

import paralleljohnson_tpu_torch as pjt
from paralleljohnson_tpu_torch.backends.torch_backend import TorchBackend
from paralleljohnson_tpu_torch.ops import fanout_sweep as fs
from paralleljohnson_tpu_torch.ops import fw
from paralleljohnson_tpu_torch.ops import minplus as mp
from paralleljohnson_tpu_torch.ops import pred as pm

F64 = torch.float64


def _out_degree(g):
    e = g.num_real_edges
    return torch.bincount(torch.as_tensor(g.src[:e]).long(),
                          minlength=g.num_nodes)


@pytest.mark.parametrize("b,cols", [(1, 64), (64, 64), (65, 128),
                                    (128, 128), (129, 256), (301, 256),
                                    (512, 256), (700, 256)])
def test_pass_columns_at_f64(b, cols):
    """One pass: 32 lanes x NV 16-byte vectors, NV = 1, 2, 4 by B; the
    f64 kernel with hubs stops at NV = 2 (1 KB of a hub's row a pass)."""
    assert fs.pass_columns(b, 8) == cols
    assert fs.pass_columns(b, 8, hubs=True) == min(cols, 128)
    assert fs.hub_row_bytes(b) == 8 * min(b, cols, 128)
    assert fs.pass_columns(b, 4) == fs.pass_columns(b, 4, hubs=True) == (
        128 if b <= 128 else 256 if b <= 256 else 512)


@pytest.mark.parametrize("budget_mb", [1, 4, 24])
@pytest.mark.parametrize("b", [128, 512])
def test_hub_set_is_ordered_deterministic_and_within_budget(b, budget_mb):
    g = pjt.load_graph("rmat:scale=14,ef=16,seed=0")
    deg = _out_degree(g)
    row_bytes = fs.hub_row_bytes(b)
    budget = budget_mb << 20
    hubs = fs.hub_sources(deg, row_bytes, budget=budget)
    assert hubs.numel() > 0
    assert hubs.numel() * row_bytes <= budget
    assert torch.equal(hubs, fs.hub_sources(deg.clone(), row_bytes,
                                            budget=budget))
    d = deg[hubs]
    # Descending out-degree, ties by ascending id.
    assert bool((d[:-1] >= d[1:]).all())
    ties = (d[:-1] == d[1:])
    assert bool((hubs[:-1][ties] < hubs[1:][ties]).all())
    # Nothing left out that beats a hub, unless the budget is full.
    least = int(d.min())
    rest = torch.ones_like(deg, dtype=torch.bool)
    rest[hubs] = False
    if hubs.numel() < budget // row_bytes:
        assert int(deg[rest].max()) < least or least == fs.HUB_MIN_OUT_DEGREE
    else:
        assert int(deg[rest].max()) <= least
    mean = deg.double().mean().item()
    assert least >= max(fs.HUB_MIN_OUT_DEGREE, fs.HUB_SKEW * mean)
    # The flags mark exactly the edges whose source is a hub.
    e = g.num_real_edges
    src = torch.as_tensor(g.src[:e]).to(torch.int32)
    flags = fs.hub_flags(src, g.num_nodes, b, F64, budget=budget)
    assert flags.dtype == torch.uint8 and flags.shape == src.shape
    assert torch.equal(flags.bool(), torch.isin(src.long(), hubs))


def test_hub_set_ties_by_vertex_id():
    deg = torch.tensor([5, 40, 40, 3, 40, 90])
    hubs = fs.hub_sources(deg, 1024, budget=3 * 1024, min_degree=10)
    assert hubs.tolist() == [5, 1, 2]
    assert fs.hub_sources(deg, 1024, budget=10 * 1024,
                          min_degree=10).tolist() == [5, 1, 2, 4]


@pytest.mark.parametrize("spec", ["grid:rows=64,cols=64,neg=0.2,seed=0",
                                  "grid:rows=512,cols=512,neg=0.2,seed=0",
                                  "er:n=1024,p=0.1,seed=0",
                                  "er:n=4096,p=0.004,seed=1"])
@pytest.mark.parametrize("b", [128, 256, 512])
def test_hub_set_is_empty_without_skew(spec, b):
    """A grid (out-degree <= 4) and uniform random graphs have no source
    far above the mean: no flags, so the f64 sweep loads plainly there."""
    g = pjt.load_graph(spec)
    deg = _out_degree(g)
    row_bytes = fs.hub_row_bytes(b)
    assert fs.hub_sources(deg, row_bytes).numel() == 0
    e = g.num_real_edges
    assert fs.hub_flags(torch.as_tensor(g.src[:e]).to(torch.int32),
                        g.num_nodes, b, F64) is None


def test_hub_set_is_never_built_at_f32():
    g = pjt.load_graph("rmat:scale=12,ef=16,seed=0")
    src = torch.as_tensor(g.src[:g.num_real_edges]).to(torch.int32)
    assert fs.hub_flags(src, g.num_nodes, 512, torch.float32) is None
    for precision in ("f32", "f64"):
        dg = TorchBackend(pjt.SolverConfig(precision=precision),
                          device="cpu").upload(g)
        # On the CPU the plain sweep runs: no flags at either precision.
        assert dg.hub_flags(512) is None
        assert not any(isinstance(k, tuple) and k[0] == "hubs"
                       for k in dg._struct_cache)


def test_fixpoint_rows_do_not_depend_on_the_hub_flags():
    """The flags steer the card's L2, never the values: on the CPU the
    fixpoint with any flags is the fixpoint without."""
    g = pjt.load_graph("rmat:scale=8,ef=8,seed=1")
    e = g.num_real_edges
    lay = fs.build_in_edge_layout(torch.as_tensor(g.src[:e]),
                                  torch.as_tensor(g.indices[:e]), g.num_nodes)
    w_in = torch.as_tensor(g.weights[:e]).double()[lay["order"]]
    d0 = torch.full((g.num_nodes, 9), float("inf"), dtype=F64)
    d0[np.arange(9) * 7, np.arange(9)] = 0.0
    args = (lay["indptr_in"], lay["src_in"], w_in)
    want = fs.fanout_fixpoint(d0.clone(), *args, max_iter=g.num_nodes)
    flags = torch.ones(e, dtype=torch.uint8)
    got = fs.fanout_fixpoint(d0.clone(), *args, max_iter=g.num_nodes,
                             hubs=flags)
    assert torch.equal(got[0], want[0]) and got[1:] == want[1:]


SHAPES = [(1, 1, 1), (5, 7, 9), (16, 1024, 1024), (30, 1024, 1024),
          (100, 300, 50), (128, 1024, 1024), (200, 1024, 1024),
          (511, 1024, 1024), (1000, 777, 513), (1024, 1024, 1024),
          (512, 512, 1024), (1024, 512, 512), (1024, 512, 1024),
          (4096, 4096, 4096)]


@pytest.mark.parametrize("shape", SHAPES)
def test_f64_minplus_plan_covers_k_with_f64_tiles(shape):
    i, k, j = shape
    p = mp.minplus_plan(i, k, j, 8)
    assert p.rows in mp.TILE_ROWS_F64 and p.rows in mp.RESIDENT_F64
    assert p.k_split % mp.TILE_K == 0
    # The splits cover K once, none empty.
    assert (p.splits - 1) * p.k_split < max(k, 1) <= p.splits * p.k_split
    assert 1 <= p.splits <= mp.MAX_SPLITS
    assert mp.minplus_plan(i, k, j, 8) == p  # a pure function of the shape
    gx, gy, gz = p.grid(i, j)
    assert gz == p.splits and gy * p.rows >= i and gx * mp.TILE_COLS >= j


@pytest.mark.parametrize("shape", [(1024, 1024, 1024), (511, 1024, 1024),
                                   (128, 1024, 1024), (1024, 512, 1024)])
def test_f64_minplus_plan_fills_the_resident_slots(shape):
    """At the dense route's and the FW trailing update's shapes the f64
    grid takes at least 90% of the card's resident block slots, and no
    second wave."""
    i, k, j = shape
    p = mp.minplus_plan(i, k, j, 8)
    gx, gy, gz = p.grid(i, j)
    slots = mp.SMS * mp.RESIDENT_F64[p.rows]
    assert 0.9 * slots <= gx * gy * gz <= slots


def test_f64_minplus_plan_keeps_narrow_batches_on_narrow_tiles():
    assert mp.minplus_plan(1, 1024, 1024, 8).rows == 16
    assert mp.minplus_plan(16, 1024, 1024, 8).rows == 16
    assert mp.minplus_plan(128, 1024, 1024, 8).rows == 32
    # f32's plans are not the f64 ones.
    assert mp.minplus_plan(1024, 1024, 1024, 4).rows == 128



# -- the f64 Kleene closure's rounds (csrc/fw_kleene.cu kleene_rounds) ----


@pytest.mark.parametrize("t", [1, 16, 40, 100, 128, 200, 256, 384, 500, 512])
def test_f64_kleene_plan_hands_over_in_rounds(t):
    """At f64 the cluster takes KLEENE_STEPS_F64 steps per hand-over (a
    divisor of its rows per thread, so a round is whole rows of one
    thread), with the rounds' shared memory: two slots of the row panel,
    the column panel and the diagonal block's snapshots, the stage, the
    next block and its snapshots, inside the 48 KB a launch takes without opting in; at f32
    one step, as before."""
    plan, plan32 = fw.kleene_plan(t, 8), fw.kleene_plan(t)
    rr = plan.rows // fw.KLEENE_THREAD_ROWS
    assert (plan.variant, plan.rows, plan.cols, plan.threads) == (
        plan32.variant, plan32.rows, plan32.cols, plan32.threads)
    assert plan32.steps == 1 and plan.steps == fw.KLEENE_STEPS_F64 == 4
    assert rr % plan.steps == 0
    b = plan.steps
    assert plan.smem_bytes == 16 + 8 * (2 * b * (plan.rows + plan.cols + b)
                                        + b * plan.rows + 2 * b * b)
    assert plan.smem_bytes <= 48 * 1024
    # Every panel line has a thread of its own.
    assert plan.rows + plan.cols <= plan.threads


def test_f64_kleene_steps_match_the_kernel():
    """The plan sizes the rounds' shared memory with KLEENE_STEPS_F64;
    the kernel's entry points take no count and build their rounds with
    kSteps64 (``csrc/fw_kleene.cu``): the two constants agree."""
    import re
    from pathlib import Path

    src = (Path(fw.__file__).resolve().parent.parent / "csrc"
           / "fw_kleene.cu").read_text()
    found = re.findall(r"constexpr int kSteps64 = (\d+);", src)
    assert found == [str(fw.KLEENE_STEPS_F64)]


# -- the f64 tight-edge pass's hub flags (ops/pred.py tight_pred_pass) ----


def _pred_case(b):
    g = pjt.load_graph("rmat:scale=9,ef=8,seed=3")
    e = g.num_real_edges
    lay = fs.build_in_edge_layout(torch.as_tensor(g.src[:e]),
                                  torch.as_tensor(g.indices[:e]), g.num_nodes)
    w_in = torch.as_tensor(g.weights[:e]).double()[lay["order"]].contiguous()
    layout = (lay["indptr_in"], lay["src_in"], w_in)
    sources = np.random.default_rng(b).choice(g.num_nodes, b, replace=False)
    d = torch.full((g.num_nodes, b), float("inf"), dtype=F64)
    d[torch.as_tensor(sources), torch.arange(b)] = 0.0
    d = fs.fanout_fixpoint(d, *layout, max_iter=g.num_nodes)[0]
    return g, layout, d, sources


@pytest.mark.parametrize("kind", ["zeros", "hubs", "all"])
@pytest.mark.parametrize("b", [1, 7, 64, 128])
def test_tight_pred_hub_flags_change_nothing_on_cpu(b, kind):
    """On CPU tensors the pass takes the plain version and the flags'
    values are unused: trees and tree flags equal the call without them."""
    g, layout, d, sources = _pred_case(b)
    src_in = layout[1]
    if kind == "hubs":
        hubs = fs.hub_flags(src_in, g.num_nodes, b, F64,
                            budget=fs.hub_row_bytes(b) * 16)
        assert hubs is not None and 0 < int(hubs.sum()) < src_in.shape[0]
    else:
        hubs = torch.full(src_in.shape, int(kind == "all"), dtype=torch.uint8)
    want = pm.tight_pred_pass(d, *layout)
    assert torch.equal(pm.tight_pred_pass(d, *layout, hubs=hubs), want)
    want_s, want_f = pm.tight_pred_pass(d, *layout, sources=sources)
    got_s, got_f = pm.tight_pred_pass(d, *layout, sources=sources, hubs=hubs)
    assert torch.equal(got_s, want_s) and got_f.tolist() == want_f.tolist()


def test_tight_pred_rejects_bad_hub_flags():
    """Hub flags are uint8[E] over the CSC, for f64 distances only, on
    either device."""
    g, layout, d, _ = _pred_case(4)
    e = layout[1].shape[0]
    ok = torch.zeros(e, dtype=torch.uint8)
    with pytest.raises(TypeError, match="uint8"):
        pm.tight_pred_pass(d, *layout, hubs=ok.int())
    with pytest.raises(TypeError, match="uint8"):
        pm.tight_pred_pass(d, *layout, hubs=ok.bool())
    with pytest.raises(ValueError, match=f"hubs must be \\[{e}\\]"):
        pm.tight_pred_pass(d, *layout, hubs=ok[1:])
    with pytest.raises(ValueError, match="hubs must be"):
        pm.tight_pred_pass(d, *layout, hubs=ok.reshape(1, -1))
    with pytest.raises(ValueError, match="f64"):
        pm.tight_pred_pass(d.float(), layout[0], layout[1],
                           layout[2].float(), hubs=ok)


def test_extract_takes_no_hub_flags_on_cpu():
    """The backend's f64 graph has no hub flags on the CPU (the pass runs
    its plain version there), so ``_extract`` hands the pass None."""
    g = pjt.load_graph("rmat:scale=10,ef=16,seed=0")
    dg = TorchBackend(pjt.SolverConfig(precision="f64"), device="cpu").upload(g)
    assert dg.hub_flags(512) is None
