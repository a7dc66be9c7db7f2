"""Carry graphs and configs across from the JAX package.

Both functions take plain data (numpy arrays, a dict), so this module
imports nothing of the JAX package: the caller hands over
``graph.indptr, graph.indices, graph.weights`` of a JAX-package
``CSRGraph`` and ``dataclasses.asdict`` of its ``SolverConfig``, and both
packages then solve the same graph under the same config.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from paralleljohnson_tpu_torch.config import SolverConfig
from paralleljohnson_tpu_torch.graphs import CSRGraph

# Fields holding objects of the other package (hooks, sinks): they cannot
# cross, so only their unset value does.
_OBJECT_FIELDS = ("fault_plan", "telemetry", "metrics")


def graph_from_arrays(indptr, indices, weights) -> CSRGraph:
    """The port's ``CSRGraph`` over the same CSR arrays (copied, dtypes
    kept: int32 structure, f32/f64 weights)."""
    return CSRGraph(
        indptr=np.array(indptr, copy=True),
        indices=np.array(indices, copy=True),
        weights=np.array(weights, copy=True),
    )


def config_from_dict(d: dict) -> SolverConfig:
    """The port's ``SolverConfig`` from a ``dataclasses.asdict`` of the
    reference's. An unknown key raises ``ValueError``; the reference's
    device backend ``"jax"`` maps to ``"torch"``; ``mesh_shape`` lists
    become tuples; hook objects (``fault_plan``, ``telemetry``,
    ``metrics``) must be unset."""
    names = {f.name for f in dataclasses.fields(SolverConfig)}
    unknown = sorted(set(d) - names)
    if unknown:
        raise ValueError(f"unknown SolverConfig fields: {unknown}")
    kw = dict(d)
    if kw.get("backend") == "jax":
        kw["backend"] = "torch"
    if kw.get("mesh_shape") is not None:
        kw["mesh_shape"] = tuple(kw["mesh_shape"])
    for name in _OBJECT_FIELDS:
        if kw.get(name) is not None:
            raise ValueError(
                f"{name} holds an object of the other package and cannot "
                "be carried across; unset it"
            )
    return SolverConfig(**kw)
