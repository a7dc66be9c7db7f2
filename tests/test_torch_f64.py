"""PyTorch port at ``precision="f64"`` on the CPU: the plain f64 versions
of the four hand kernels and ``solve()`` against the JAX package at f64.

``jax_enable_x64`` is a process-wide switch, so the reference runs once,
in a subprocess with x64 on (as ``tests/test_f64.py`` runs it), under a
time limit of its own. It saves its inputs and outputs to an ``.npz``
that the tests here hold the port to: bitwise on integer weights and in
every single kernel call (each candidate is one correctly rounded f64
add and min is exact), ``rtol=1e-12`` where a solve's float path sums
may associate differently. The card's side (each f64 kernel against its
plain f64 version) is in ``tests/test_torch_cuda.py``."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paralleljohnson_tpu_torch as pjt
from paralleljohnson_tpu_torch import interop
from paralleljohnson_tpu_torch.observe import roofline
from paralleljohnson_tpu_torch.ops import fanout_sweep as fs
from paralleljohnson_tpu_torch.ops import fw as port_fw
from paralleljohnson_tpu_torch.ops import minplus as port_mp
from paralleljohnson_tpu_torch.ops import pred as port_pred
from paralleljohnson_tpu_torch.solver.johnson import to_numpy
from paralleljohnson_tpu_torch.utils.paths import validate_pred_tree

REPO = Path(__file__).resolve().parent.parent
# The reference's side: JAX import, interpret-mode Pallas and three
# pinned solves took 20-40 s on one core of the CPU container.
REFERENCE_TIMEOUT_S = 120
PINNED = dict(use_pallas=True, mesh_shape=(1,), fw=False, frontier=False,
              dia=False, gauss_seidel=False, bucket=False)

_SCRIPT = r"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import functools

import jax.numpy as jnp
import numpy as np

from paralleljohnson_tpu import ParallelJohnsonSolver, SolverConfig
from paralleljohnson_tpu.graphs import erdos_renyi, load_graph, random_dag, rmat
from paralleljohnson_tpu.ops.fw import tile_kleene
from paralleljohnson_tpu.ops.pallas_kernels import minplus_pallas
from paralleljohnson_tpu.ops.pallas_sweep import (
    build_pallas_sweep_layout, pallas_fanout_sweep,
)
from paralleljohnson_tpu.ops.pred import tight_pred_pass

PINNED = dict(use_pallas=True, mesh_shape=(1,), fw=False, frontier=False,
              dia=False, gauss_seidel=False, bucket=False)
out = {}


def save_graph(tag, g):
    out[f"{tag}_indptr"] = g.indptr
    out[f"{tag}_indices"] = g.indices
    out[f"{tag}_weights"] = g.weights


# The sweep and the tight-edge pass on R-MAT-8, float and integer
# weights (zeros among the integers: tight ties), 5 sources.
base = rmat(8, 8, seed=4)
rng = np.random.default_rng(11)
w_float = rng.uniform(0.5, 10.0, base.num_real_edges)
for tag, w in (("float", w_float), ("int", np.floor(w_float / 2))):
    g = base.with_weights(w.astype(np.float64))
    save_graph(f"sweep_{tag}", g)
    vb, ec = 128, 256
    lay = build_pallas_sweep_layout(g.indptr, g.indices, g.num_nodes,
                                    vb=vb, ec=ec)
    order = lay["edge_order"]
    wk = np.where(order >= 0, g.weights[np.maximum(order, 0)], np.inf)
    args = [jnp.asarray(lay[k]) if k != "w" else jnp.asarray(wk)
            for k in ("srcl_ck", "dstl_ck", "w", "runend_ck", "sb_ids",
                      "db_ids", "first_ck")]
    sweep = jax.jit(functools.partial(pallas_fanout_sweep, vb=vb,
                                      interpret=True))
    v = g.num_nodes
    sources = np.array([0, 3, v - 1, 7, v // 2], np.int32)
    d = np.full((lay["v_pad"], len(sources)), np.inf)
    d[sources, np.arange(len(sources))] = 0.0
    d = jnp.asarray(d)
    steps = []
    for i in range(v):
        new = sweep(d, *args)
        steps.append(np.asarray(new)[:v])
        if not bool((new < d).any()):
            break
        d = new
    out[f"sweep_{tag}_sources"] = sources
    out[f"sweep_{tag}_steps"] = np.stack(steps)
    conv = np.asarray(d)[:v].T                  # [B, V], converged
    e = g.num_real_edges
    pred = tight_pred_pass(jnp.asarray(conv), jnp.asarray(g.src[:e]),
                           jnp.asarray(g.indices[:e]),
                           jnp.asarray(g.weights[:e]))
    out[f"pred_{tag}_dist"] = conv
    out[f"pred_{tag}"] = np.asarray(pred)

# Min-plus: [40, 70] x [70, 50], +inf entries and negative ones.
rng = np.random.default_rng(12)
for tag, scale in (("float", None), ("int", 9)):
    dm = rng.uniform(-3.0, 10.0, (40, 70))
    am = rng.uniform(-3.0, 10.0, (70, 50))
    if scale:
        dm, am = np.floor(dm), np.floor(am)
    dm[rng.random(dm.shape) < 0.3] = np.inf
    am[rng.random(am.shape) < 0.3] = np.inf
    out[f"mp_{tag}_d"], out[f"mp_{tag}_a"] = dm, am
    out[f"mp_{tag}"] = np.asarray(minplus_pallas(
        jnp.asarray(dm), jnp.asarray(am), interpret=True))

# Kleene closure of a [48, 48] tile with negative entries, no negative
# cycle (a DAG's upper triangle) and one whose diagonal goes negative.
rng = np.random.default_rng(13)
for tag in ("dag", "cycle"):
    m = np.where(rng.random((48, 48)) < 0.3, rng.uniform(-2.0, 8.0, (48, 48)),
                 np.inf)
    if tag == "dag":
        m = np.triu(m, 1) + np.tril(np.full((48, 48), np.inf), -1)
    np.fill_diagonal(m, 0.0)
    out[f"kleene_{tag}_in"] = m
    out[f"kleene_{tag}"] = np.asarray(tile_kleene(jnp.asarray(m)))

# The tiles of the rounds-order model (test_kleene_rounds_order_*): t in
# (16, 40, 42, 128), +inf holes, negative entries, and with a negative
# 2-cycle (a negative diagonal); closed at f64 and at f32.
for t in (16, 40, 42, 128):
    for neg in (0, 1):
        rng = np.random.default_rng(100 * t + neg)
        p = rng.random(t) * 4
        m = rng.random((t, t)) * 10 + p[:, None] - p[None, :] + 1e-9
        m[rng.random((t, t)) < 0.7] = np.inf
        np.fill_diagonal(m, 0.0)
        if neg:
            m[t - 2, t - 1], m[t - 1, t - 2] = -1.5, 0.25
            m[3, 5], m[5, 3] = -3.0, 1.0
        tag = f"korder_{t}_{neg}"
        out[f"{tag}_in"] = m
        out[f"{tag}_f64"] = np.asarray(tile_kleene(jnp.asarray(m)))
        out[f"{tag}_f32"] = np.asarray(tile_kleene(jnp.asarray(
            m.astype(np.float32))))

# solve() on pinned routes at f64: a negative DAG (float and integer
# weights), a negative grid with trees, a dense ER on the FW route.
solves = {
    "dag_float": (random_dag(60, 0.1, negative_fraction=0.4, seed=21), {}),
    "grid_pred": (load_graph("grid:rows=9,cols=11,neg=0.2,seed=1"), {}),
    "er_fw": (erdos_renyi(48, 0.3, seed=5), dict(fw=True)),
}
g0 = solves["dag_float"][0]
solves["dag_int"] = (g0.with_weights(np.round(g0.weights)), {})
g0 = solves["grid_pred"][0]
solves["grid_pred_int"] = (g0.with_weights(np.round(g0.weights)), {})
g0 = solves["er_fw"][0]
solves["er_fw"] = (g0.with_weights(np.round(g0.weights)), dict(fw=True))
for tag, (g, kw) in solves.items():
    g = g.astype(np.float64)
    save_graph(f"solve_{tag}", g)
    cfg = SolverConfig(precision="f64", **{**PINNED, **kw})
    res = ParallelJohnsonSolver(cfg).solve(g, predecessors="pred" in tag)
    out[f"solve_{tag}_dist"] = np.asarray(res.matrix)
    out[f"solve_{tag}_route"] = np.array(res.stats.routes_by_phase["fanout"])
    if "pred" in tag:
        out[f"solve_{tag}_pred"] = np.asarray(res.predecessors)

np.savez(sys.argv[1], **out)
print("ok", jax.config.jax_enable_x64)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's f64 arrays (the subprocess above)."""
    path = tmp_path_factory.mktemp("f64") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(path)], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=REFERENCE_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["ok", "True"]
    with np.load(path) as z:
        return dict(z)


def _graph(ref, tag):
    return interop.graph_from_arrays(ref[f"{tag}_indptr"],
                                     ref[f"{tag}_indices"],
                                     ref[f"{tag}_weights"])


def _layout(g):
    e = g.num_real_edges
    lay = fs.build_in_edge_layout(torch.as_tensor(g.src[:e]),
                                  torch.as_tensor(g.indices[:e]), g.num_nodes)
    w_in = torch.as_tensor(g.weights[:e])[lay["order"]].contiguous()
    return lay["indptr_in"], lay["src_in"], w_in


def _solver(**kw):
    return pjt.ParallelJohnsonSolver(pjt.SolverConfig(**kw), device="cpu")


@pytest.mark.parametrize("tag", ["float", "int"])
def test_sweep_f64_bitwise_equals_pallas(ref, tag):
    """Every sweep from the sources to the fixpoint: the plain f64 sweep
    (the CPU side of ``fanout_sweep``) bitwise the interpret-mode Pallas
    sweep at f64, with the same improved flag."""
    g = _graph(ref, f"sweep_{tag}")
    layout = _layout(g)
    assert layout[2].dtype == torch.float64
    steps = ref[f"sweep_{tag}_steps"]
    sources = ref[f"sweep_{tag}_sources"]
    d = np.full((g.num_nodes, len(sources)), np.inf)
    d[sources, np.arange(len(sources))] = 0.0
    for want in steps:
        got, improved = fs.fanout_sweep(torch.as_tensor(d), *layout)
        assert got.dtype == torch.float64
        np.testing.assert_array_equal(got.numpy(), want)
        assert bool(improved) == bool((want < d).any())
        d = want
    assert not bool(fs.fanout_sweep(torch.as_tensor(d), *layout)[1])


@pytest.mark.parametrize("tag", ["float", "int"])
def test_tight_pred_f64_equals_reference(ref, tag):
    """The tight-edge pass at f64 (tolerance 4 DBL_EPSILON) over the CSC,
    bitwise the reference's pass on the converged distances; with the
    sources, its mask and flags are ``tree_flags_plain`` of the
    reference's tree."""
    g = _graph(ref, f"sweep_{tag}")
    layout = _layout(g)
    dist = torch.as_tensor(ref[f"pred_{tag}_dist"])           # [B, V]
    want = ref[f"pred_{tag}"]
    got = port_pred.tight_pred_pass(dist.t().contiguous(), *layout)
    np.testing.assert_array_equal(got.t().numpy(), want)
    sources = ref[f"sweep_{tag}_sources"]
    got_s, flags = port_pred.tight_pred_pass(dist.t().contiguous(), *layout,
                                             sources=sources)
    want_s, want_flags = port_pred.tree_flags_plain(torch.as_tensor(want),
                                                    dist, sources)
    np.testing.assert_array_equal(got_s.t().numpy(), want_s.numpy())
    assert flags.tolist() == want_flags.tolist()
    if tag == "int":  # zero weights: ties broken by the lower id
        assert flags.tolist()[1] == 1


@pytest.mark.parametrize("tag", ["float", "int"])
def test_minplus_f64_bitwise_equals_pallas(ref, tag):
    d = torch.as_tensor(ref[f"mp_{tag}_d"])
    a = torch.as_tensor(ref[f"mp_{tag}_a"])
    got = port_mp.minplus_kernel(d, a)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), ref[f"mp_{tag}"])


@pytest.mark.parametrize("tag", ["dag", "cycle"])
def test_kleene_f64_bitwise_equals_reference(ref, tag):
    got = port_fw.fw_kleene(torch.as_tensor(ref[f"kleene_{tag}_in"]))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), ref[f"kleene_{tag}"])
    assert (np.diagonal(got.numpy()) < 0).any() == (tag == "cycle")


def kleene_rounds(m, b):
    """The order of the f64 Kleene kernel's rounds (``csrc/fw_kleene.cu``,
    ``kleene_rounds``) in plain torch, steps k0 .. k0+b-1 a round: the b
    steps on the diagonal block, keeping each entry (i, c) as it was
    before step min(i, c); the column panel's rows and the row panel's
    columns taken through the round's steps in order with those values;
    then every entry takes the b candidates C[:, k] + R[k, :], k
    ascending. As in the kernel, a t that is no multiple of b is padded
    with +inf rows and columns, and the last round runs its b steps, past
    t into the padding."""
    t = m.shape[0]
    tp = -(-t // b) * b
    m = torch.nn.functional.pad(m, (0, tp - t, 0, tp - t),
                                value=float("inf"))
    for k0 in range(0, tp, b):
        blk = slice(k0, k0 + b)
        d = m[blk, blk].clone()
        snap = d.clone()
        for k in range(b):
            snap[k, k + 1:] = d[k, k + 1:]
            snap[k + 1:, k] = d[k + 1:, k]
            d = torch.minimum(d, d[:, k:k + 1] + d[k:k + 1, :])
        c, r = m[:, blk].clone(), m[blk, :].clone()
        for k in range(b):
            for j in range(k + 1, b):
                c[:, j] = torch.minimum(c[:, j], c[:, k] + snap[k, j])
                r[j, :] = torch.minimum(r[j, :], snap[j, k] + r[k, :])
        for k in range(b):
            m = torch.minimum(m, c[:, k:k + 1] + r[k:k + 1, :])
    return m[:t, :t]


@pytest.mark.parametrize("neg", [0, 1])
@pytest.mark.parametrize("t", [16, 40, 42, 128])
@pytest.mark.parametrize("b", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_kleene_rounds_order_bitwise_equals_reference(ref, dtype, b, t, neg):
    """The rounds' order changes no bit: bitwise ``fw.tile_kleene`` (the
    plain loop, one step at a time) and the JAX package's ``tile_kleene``
    (at f64 with x64 on, and at f32), with a last round that runs past t
    into +inf padding (t = 42 at b = 4 and 8), negative
    entries and +inf holes, and a negative diagonal."""
    tag = f"korder_{t}_{neg}"
    m = torch.as_tensor(ref[f"{tag}_in"])
    if dtype == "f32":
        m = m.float()
    got = kleene_rounds(m, b)
    assert got.dtype == m.dtype
    assert torch.equal(got, port_fw.tile_kleene(m))
    np.testing.assert_array_equal(got.numpy(), ref[f"{tag}_{dtype}"])
    assert (np.diagonal(got.numpy()) < 0).any() == bool(neg)


@pytest.mark.parametrize("tag", ["dag_float", "dag_int", "grid_pred",
                                 "grid_pred_int", "er_fw"])
def test_solve_f64_equals_reference(ref, tag):
    """``solve()`` at f64 on the reference's pinned routes: the same
    route and float64 rows, bitwise on integer weights and to
    ``rtol=1e-12`` on float weights; trees valid."""
    g = _graph(ref, f"solve_{tag}")
    kw = dict(fw=True) if tag == "er_fw" else {}
    cfg = interop.config_from_dict(dataclasses.asdict(
        pjt.SolverConfig(precision="f64", **{**PINNED, **kw})))
    res = pjt.ParallelJohnsonSolver(cfg, device="cpu").solve(
        g, predecessors="pred" in tag)
    assert res.stats.routes_by_phase["fanout"] == str(
        ref[f"solve_{tag}_route"])
    assert res.matrix.dtype == np.float64
    want = ref[f"solve_{tag}_dist"]
    if tag.endswith("float") or tag == "grid_pred":
        np.testing.assert_array_equal(np.isinf(res.matrix), np.isinf(want))
        np.testing.assert_allclose(res.matrix, want, rtol=1e-12)
    else:
        np.testing.assert_array_equal(res.matrix, want)
    if "pred" in tag:
        pred = to_numpy(res.predecessors)
        validate_pred_tree(g, to_numpy(res.dist), pred, res.sources)
        validate_pred_tree(g, want, ref[f"solve_{tag}_pred"], res.sources)
        if tag.endswith("int"):
            np.testing.assert_array_equal(pred, ref[f"solve_{tag}_pred"])


def _int_graph(spec):
    g = pjt.load_graph(spec)
    return g.with_weights(np.round(g.weights))


# The hand routes on the CPU, integer weights: each f64 solve is bitwise
# its f32 solve (every path sum is exact in both types).
ROUTES = {
    "pallas-vm": ("rmat:scale=9,ef=8,seed=2", dict(source_batch_size=64), {}),
    "pallas-vm+pred": ("dag:n=120,p=0.05,neg=0.4,seed=3", {},
                       dict(predecessors=True)),
    "dense-squaring-pallas": ("er:n=96,p=0.2,seed=1", dict(fw=False), {}),
    "dense-iterate-pallas": ("er:n=96,p=0.2,seed=1", dict(fw=False),
                             dict(sources=np.arange(16))),
    "fw-tile": ("er:n=300,p=0.05,seed=2", dict(fw=True, fw_tile=128), {}),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_f64_rows_bitwise_f32_on_integer_weights(route):
    spec, cfg, kw = ROUTES[route]
    g = _int_graph(spec)
    sources = kw.get("sources")
    pred = kw.get("predecessors", False)
    f32 = _solver(mesh_shape=(1,), **cfg).solve(g, sources,
                                                predecessors=pred)
    f64 = _solver(mesh_shape=(1,), precision="f64", **cfg).solve(
        g, sources, predecessors=pred)
    assert f64.stats.routes_by_phase["fanout"] == route
    assert f32.stats.routes_by_phase == f64.stats.routes_by_phase
    assert f64.matrix.dtype == np.float64
    np.testing.assert_array_equal(f64.matrix, f32.matrix.astype(np.float64))
    if pred:
        np.testing.assert_array_equal(to_numpy(f64.predecessors),
                                      to_numpy(f32.predecessors))


def test_f64_batch_bitwise_f32_on_integer_weights():
    """``solve_batch`` (route ``batch-vmapped``) at f64 and f32 on integer
    weights, bitwise."""
    graphs = [_int_graph(f"dag:n=40,p=0.1,neg=0.3,seed={s}") for s in range(3)]
    f32 = _solver().solve_batch(graphs)
    f64 = _solver(precision="f64").solve_batch(graphs)
    for a, b in zip(f32, f64):
        assert b.matrix.dtype == np.float64
        np.testing.assert_array_equal(b.matrix, a.matrix.astype(np.float64))


@pytest.mark.parametrize("spec", ["dag:n=80,p=0.08,neg=0.4,seed=3",
                                  "grid:rows=10,cols=10,neg=0.2,seed=2"])
@pytest.mark.parametrize("integer", [True, False])
def test_f64_torch_equals_cpp_backend(spec, integer):
    """The torch backend at f64 against the C++/OpenMP backend at f64:
    bitwise on integer weights, ``rtol=1e-12`` on float weights (the two
    take their potentials by different sweep orders)."""
    g = _int_graph(spec) if integer else pjt.load_graph(spec)
    port = _solver(precision="f64", mesh_shape=(1,)).solve(g)
    cpp = pjt.ParallelJohnsonSolver(
        pjt.SolverConfig(backend="cpp", precision="f64")).solve(g)
    assert port.matrix.dtype == cpp.matrix.dtype == np.float64
    if integer:
        np.testing.assert_array_equal(port.matrix, cpp.matrix)
    else:
        np.testing.assert_array_equal(np.isinf(port.matrix),
                                      np.isinf(cpp.matrix))
        np.testing.assert_allclose(port.matrix, cpp.matrix, rtol=1e-12)


def test_f64_is_supported_on_cuda():
    assert pjt.SolverConfig(precision="f64").unsupported("cuda") == []
    assert pjt.SolverConfig(precision="f64").unsupported("cpu") == []


def test_roofline_reads_the_fp64_peak_at_f64():
    """At f64 the cuda roofline divides the operations by the H100's FP64
    peak (34 TFLOP/s), half the FP32 one; a cpu row has one peak."""
    kw = dict(flops=3.4e12, bytes_accessed=1e6, compute_s=1.0,
              platform="cuda")
    f32 = roofline.classify(**kw)
    f64 = roofline.classify(**kw, precision="f64")
    assert f32["t_mxu_s"] == pytest.approx(3.4e12 / 67e12)
    assert f64["t_mxu_s"] == pytest.approx(0.1)
    assert f64["bound"] == "mxu" and f64["roofline_frac"] == pytest.approx(0.1)
    assert roofline.peaks_for("cuda", "f64")["flops_gflops"] == 34000.0
    assert roofline.peaks_for("cpu", "f64") == roofline.peaks_for("cpu")

    class Stats:
        phase_seconds = {"fanout": 1.0}
        analytic_cost = {"flops": 3.4e12, "bytes_accessed": 1e6}

    got = roofline.attribute_stats(Stats(), platform="cuda", precision="f64")
    assert got["t_mxu_s"] == pytest.approx(0.1)


def test_f64_solve_records_the_fp64_roofline(monkeypatch):
    """A precision="f64" solve's ``stats.roofline`` is classified at f64
    (on the CPU the peaks are the cpu row's either way; the precision
    reaches the classifier)."""
    g = _int_graph("er:n=64,p=0.1,seed=4")
    calls = []
    real = roofline.classify

    def spy(**kw):
        calls.append(kw.get("precision"))
        return real(**kw)

    monkeypatch.setattr(roofline, "classify", spy)
    res = _solver(precision="f64").solve(g)
    assert calls == ["f64"] and res.stats.roofline["platform"] == "cpu"
