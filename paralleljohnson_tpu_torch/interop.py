"""Carry graphs, configs, landmark indexes and hopsets across from the
JAX package.

Every function takes plain data (numpy arrays, a dict, scalars), so this
module imports nothing of the JAX package: the caller hands over
``graph.indptr, graph.indices, graph.weights`` of a JAX-package
``CSRGraph``, ``dataclasses.asdict`` of its ``SolverConfig``, or the
numpy fields of its ``LandmarkIndex`` / ``Hopset``, and both packages
then solve, serve or bound the same graph the same way.
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


def landmarks_from_arrays(sources, fwd, rev, *, nonnegative: bool,
                          digest: str | None = None):
    """The port's ``LandmarkIndex`` over a reference index's fields
    (``sources``, ``fwd``, ``rev``, ``nonnegative``, ``digest``)."""
    from paralleljohnson_tpu_torch.serve.landmarks import LandmarkIndex

    return LandmarkIndex(np.array(sources, copy=True),
                         np.array(fwd, copy=True), np.array(rev, copy=True),
                         nonnegative=bool(nonnegative), digest=digest)


def hopset_from_arrays(**fields):
    """The port's ``Hopset`` from a reference hopset's dataclass fields
    (``dataclasses.asdict`` of it, or the same names by hand): ``epsilon``,
    ``beta``, ``pivots``, ``fwd``, ``rev``, ``converged``,
    ``nonnegative`` and the optional provenance (``digest``, ``picker``,
    ``seed``, ``edges_examined``, ``construction_s``). An unknown field
    raises ``ValueError``."""
    from paralleljohnson_tpu_torch.ops.hopset import Hopset

    names = {f.name for f in dataclasses.fields(Hopset)}
    unknown = sorted(set(fields) - names)
    if unknown:
        raise ValueError(f"unknown Hopset fields: {unknown}")
    kw = {k: (np.array(v, copy=True) if isinstance(v, np.ndarray) else v)
          for k, v in fields.items()}
    return Hopset(**kw)
