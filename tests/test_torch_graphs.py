"""PyTorch port: the graph layer, config and interop against the JAX
package. Generators and loaders are copies of the reference's numpy code,
so every array must be byte-identical for the same spec."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import paralleljohnson_tpu.graphs as ref_graphs
from paralleljohnson_tpu.config import SolverConfig as RefConfig
from paralleljohnson_tpu.utils.checkpoint import graph_digest as ref_digest

import paralleljohnson_tpu_torch as pjt
import paralleljohnson_tpu_torch.graphs as port_graphs
from paralleljohnson_tpu_torch import interop
from paralleljohnson_tpu_torch.graphs.csr import graph_digest

FIXTURES = Path(__file__).parent / "fixtures"


def _assert_same_graph(ref, port):
    for name in ("indptr", "indices", "weights"):
        a, b = getattr(ref, name), getattr(port, name)
        assert a.dtype == b.dtype, name
        assert a.tobytes() == b.tobytes(), name
    assert graph_digest(port) == ref_digest(ref)


@pytest.mark.parametrize("spec", [
    "rmat:scale=9,ef=8,seed=4",
    "rmat:scale=7,seed=0",
    "er:n=200,p=0.05,neg=0.2,seed=1",
    "er:n=1,p=0.5,seed=0",
    "dag:n=150,p=0.05,seed=4",
    "dag:n=60,p=0.2,neg=0.5,seed=9",
    "grid:rows=9,cols=13,neg=0.2,seed=3",
    "grid:rows=16,cols=16,seed=2",
])
def test_generator_specs_byte_identical(spec):
    _assert_same_graph(ref_graphs.load_graph(spec), pjt.load_graph(spec))


def test_permute_labels_and_batch_byte_identical():
    g_ref = ref_graphs.grid2d(7, 9, seed=1)
    g_port = port_graphs.grid2d(7, 9, seed=1)
    _assert_same_graph(ref_graphs.permute_labels(g_ref, seed=5),
                       port_graphs.permute_labels(g_port, seed=5))
    for a, b in zip(ref_graphs.random_graph_batch(3, 20, 0.2, seed=2),
                    port_graphs.random_graph_batch(3, 20, 0.2, seed=2)):
        _assert_same_graph(a, b)


@pytest.mark.parametrize("name", ["tiny_ny.gr", "tiny_ego.txt"])
def test_loaders_read_fixtures_identically(name):
    path = str(FIXTURES / name)
    ref, port = ref_graphs.load_graph(path), pjt.load_graph(path)
    _assert_same_graph(ref, port)
    if name.endswith(".txt"):
        np.testing.assert_array_equal(ref.node_ids, port.node_ids)


def test_pad_edges_and_dense_match_reference():
    ref = ref_graphs.rmat(6, 4, seed=3)
    port = pjt.load_graph("rmat:scale=6,ef=4,seed=3")
    _assert_same_graph(ref.pad_edges(128), port.pad_edges(128))
    np.testing.assert_array_equal(ref.to_dense(), port.to_dense())
    np.testing.assert_array_equal(ref.src, port.src)


def test_graph_from_arrays_round_trip():
    ref = ref_graphs.random_dag(40, 0.1, seed=2)
    port = interop.graph_from_arrays(ref.indptr, ref.indices, ref.weights)
    assert isinstance(port, port_graphs.CSRGraph)
    _assert_same_graph(ref, port)
    assert port.indices is not ref.indices  # copied, not shared


def test_config_from_dict_carries_every_field():
    ref = RefConfig(use_pallas=True, mesh_shape=(1,), fw=False,
                    frontier=False, dense_threshold=77, max_iterations=9)
    cfg = interop.config_from_dict(dataclasses.asdict(ref))
    assert cfg.backend == "torch"
    assert cfg.mesh_shape == (1,)
    for f in dataclasses.fields(RefConfig):
        if f.name != "backend":
            assert getattr(cfg, f.name) == getattr(ref, f.name), f.name
    # Every reference field exists in the port, and no other.
    assert ({f.name for f in dataclasses.fields(RefConfig)}
            == {f.name for f in dataclasses.fields(pjt.SolverConfig)})


def test_config_from_dict_rejects_unknown_and_objects():
    d = dataclasses.asdict(RefConfig())
    with pytest.raises(ValueError, match="unknown SolverConfig fields"):
        interop.config_from_dict({**d, "bogus": 1})
    with pytest.raises(ValueError, match="telemetry"):
        interop.config_from_dict({**d, "telemetry": object()})


@pytest.mark.parametrize("kw,match", [
    ({"backend": "jax"}, "backend"),
    ({"precision": "f16"}, "precision"),
    ({"use_pallas": "false"}, "use_pallas"),
    ({"frontier": True, "fw": True}, "mutually-exclusive"),
    ({"fw_tile": 100}, "fw_tile"),
    ({"pipeline_depth": 0}, "pipeline_depth"),
])
def test_config_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        pjt.SolverConfig(**kw)
