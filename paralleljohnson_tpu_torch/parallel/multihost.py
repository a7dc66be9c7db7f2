"""Multi-process execution over ``torch.distributed``.

The mesh's sharded entry points run unchanged over a mesh whose ranks are
processes (one per card, or several sharing one): the fan-out's sweeps
stay collective-free, and the row gather and the count gathers run on the
default process group. This module owns the process bootstrap and the
global sources array.

Usage in each process (``torchrun`` / ``python -m torch.distributed.run``
sets the environment):

    from paralleljohnson_tpu_torch.parallel import multihost
    multihost.initialize()          # torch.distributed, env-driven
    mesh = multihost.global_mesh()  # 1-D "sources" mesh, a rank per process
    ...

The process group is NCCL when every process of this host has a card of
its own, else gloo (ranks that share a card stage their tensors through
host memory), as for the in-process mesh.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as tdist


def _env_int(name: str) -> int | None:
    value = os.environ.get(name)
    return int(value) if value else None


def _local_device(device=None) -> torch.device:
    """This process's rank device: ``cuda:LOCAL_RANK`` (wrapped to the
    cards visible) when a card is, else the CPU; ``device`` forces the
    type."""
    kind = (torch.device(device).type if device is not None else
            "cuda" if torch.cuda.is_available() else "cpu")
    if kind != "cuda":
        return torch.device(kind)
    count = max(1, torch.cuda.device_count())
    return torch.device("cuda", (_env_int("LOCAL_RANK") or 0) % count)


def _backend_for(device: torch.device) -> str:
    """NCCL when this host's processes each have a card of their own."""
    local = _env_int("LOCAL_WORLD_SIZE") or 1
    if (device.type == "cuda" and tdist.is_nccl_available()
            and torch.cuda.device_count() >= local):
        return "nccl"
    return "gloo"


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device=None,
    timeout_s: float | None = None,
) -> bool:
    """Initialize the default ``torch.distributed`` process group for a
    multi-process run.

    Arguments default to torch's launcher environment, as ``torchrun``
    sets it: ``MASTER_ADDR`` / ``MASTER_PORT`` (read by torch's ``env://``
    rendezvous), ``WORLD_SIZE`` and ``RANK``; arguments override it
    (``coordinator_address`` ``host:port`` rendezvous over ``tcp://``). No-op
    (returns False) when neither arguments nor environment indicate a
    multi-process run, so single-process code can call this
    unconditionally. ``device`` picks the rank device type (default: the
    card when one is visible)."""
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if not (coordinator_address or os.environ.get("MASTER_ADDR")
            or num_processes):
        return False
    kwargs = {
        "backend": _backend_for(_local_device(device)),
        # None: torch's env:// rendezvous over MASTER_ADDR / MASTER_PORT
        # (under torchrun, the launcher's own store).
        "init_method": (f"tcp://{coordinator_address}"
                        if coordinator_address else None),
        "world_size": num_processes if num_processes is not None else -1,
        "rank": process_id if process_id is not None else -1,
    }
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    tdist.init_process_group(**kwargs)
    return True


def global_mesh(device=None):
    """1-D ``("sources",)`` mesh with one rank per process of the default
    group, this process's rank on ``cuda:LOCAL_RANK`` (or the CPU when
    ``device="cpu"`` or no card is visible). Without an initialized group
    it is every rank device of this process (``mesh.make_mesh(None)``)."""
    from paralleljohnson_tpu_torch.parallel.mesh import Mesh, make_mesh

    if not tdist.is_initialized():
        return make_mesh(None, device=device)
    dev = _local_device(device)
    n = tdist.get_world_size()
    return Mesh([dev] * n, ("sources",), (n,), world=tdist.get_rank())


def global_sources(mesh, sources) -> np.ndarray:
    """The global sources array: every process passes the SAME full
    ``sources`` (cheap, int32[B]); off-multiple batches are padded here,
    on the host copy, to a multiple of the mesh's rank count (duplicating
    ``sources[0]``, the convention of ``sharded_fanout``), and the sharded
    entry points hand each rank its contiguous slice. Callers slice result
    rows back to their own batch length and pass ``n_real_rows=<their B>``
    to ``sharded_fanout`` so the duplicate tail rows stay out of the
    row-sweep accounting."""
    sources = np.asarray(sources, np.int32).reshape(-1)
    pad = (-sources.shape[0]) % mesh.size
    if pad and sources.shape[0]:
        sources = np.concatenate([sources, np.full(pad, sources[0], np.int32)])
    return sources


def process_info() -> dict:
    """Process and topology summary for logs and debugging."""
    from paralleljohnson_tpu_torch.parallel.mesh import visible_devices

    if tdist.is_initialized():
        count = tdist.get_world_size()
        return {"process_index": tdist.get_rank(), "process_count": count,
                "local_devices": 1, "global_devices": count}
    local = len(visible_devices())
    return {"process_index": 0, "process_count": 1,
            "local_devices": local, "global_devices": local}
