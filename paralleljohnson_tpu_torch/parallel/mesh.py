"""Source parallelism over a mesh of ranks.

The attested multi-chip design (``BASELINE.json:5``): source batches
sharded across the ranks, the CSR replicated on each, and one
``all_gather`` of per-source distance rows assembling the distance
matrix. Each rank relaxes its own rows against the whole edge list on its
own device (on the card, the hand ``fanout_sweep`` kernel), so the sweeps
need no traffic between ranks; the collectives are the row gather and
small integer gathers of the per-rank sweep counts and flags.

``edge_shard`` and a 2-D ``("sources", "edges")`` mesh shard the edge
list too: every sweep relaxes a rank's edge slice and one ``MIN``
all-reduce over its ``"edges"`` group merges the partial relaxations
(exact: relaxation is monotone, so the minimum of the per-slice Jacobi
sweeps is the full Jacobi sweep).

At f64 every rank on a card hands the sweep and the tree pass the hub
flags of its own block by one rule (:func:`rank_hub_flags`: the L2
budget divided among the ranks that share the card).

A :class:`Mesh` lists one ``torch.device`` per rank. In one process,
every rank is a thread of the caller (:meth:`Mesh.run`) with, on a card,
its own stream, and the ranks trade tensors through one in-process
exchange per collective group (:class:`_Exchange`), as the JAX package's
collectives are ops inside one program: no process group. Each
collective posts the rank's tensor and a CUDA event marking it ready,
meets the group at a barrier, copies each peer's tensor onto the rank's
own device on its own stream once that event has passed (a MIN
all-reduce folds ``torch.minimum`` over them in rank order), records
that it has read and meets the group again; the rank's stream then waits
until every peer has read its tensor, so no source tensor is reused while
a peer's copy of it is in flight. Ranks on CPU tensors do the same
without events. Before the first run over several cards, the caller's
thread makes the first copy between each ordered pair of them
(:meth:`Mesh.peer_access`). After ``multihost.initialize()`` a mesh from
``multihost.global_mesh()`` has one rank per process and runs its
collectives on the default process group.

Rank devices: ``mesh_shape=None`` takes every rank device, as the JAX
package's ``make_mesh(None)`` takes every device, at either precision:
on cuda every card ``CUDA_VISIBLE_DEVICES`` leaves visible (a rank per
card), on cpu one rank (torch sees one CPU device). A mesh of an
explicit shape takes the first of them. ``PJ_MESH_DEVICES`` lists the
rank devices instead, e.g. ``cuda:0,cuda:0,cuda:0,cuda:0``, ``cuda:0*4``
or ``cpu*8`` (ranks may share a device; the counterpart of the JAX
package's ``--xla_force_host_platform_device_count``).

``DEFAULT_TIMEOUT_S``, read when a run starts, bounds every barrier of
the run, and the run's ranks together by ``JOIN_GRACE_S`` more: past that
limit the caller breaks the run's barriers and raises ``TimeoutError``. A
rank that raises breaks them too: the others leave at their next
collective with :class:`MeshAborted`, and the first error surfaces in
the caller. Every run makes its barriers afresh, so the next run on the
same mesh starts clean. :meth:`Mesh.close` drops the ranks' streams.
"""

from __future__ import annotations

import math
import os
import threading
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as tdist

from paralleljohnson_tpu_torch.ops import relax
from paralleljohnson_tpu_torch.ops.dia import dia_fixpoint
from paralleljohnson_tpu_torch.ops.fanout_sweep import (
    HUB_L2_BYTES,
    build_in_edge_layout,
    fanout_fixpoint,
    fanout_sweep,
    hub_flags,
)
from paralleljohnson_tpu_torch.ops.gauss_seidel import fanout_gs_body
from paralleljohnson_tpu_torch.ops.pred import certify_pred, tight_pred_pass
from paralleljohnson_tpu_torch.utils.metrics import warn_if_counter_wrapped
# Gives every sharded entry point a keyword-only ``telemetry=`` argument
# wrapping the call in a flight-recorder span.
from paralleljohnson_tpu_torch.utils.telemetry import traced

MESH_DEVICES_ENV = "PJ_MESH_DEVICES"
# Seconds any collective may wait for its peers (tests lower it).
DEFAULT_TIMEOUT_S = 300.0
# Seconds a rank thread may outlive the collective timeout before the
# caller gives up on it.
JOIN_GRACE_S = 30.0


class MeshAborted(RuntimeError):
    """Raised in a rank whose mesh run was abandoned by another rank's
    failure (the caller sees that failure, not this)."""


def _parse_devices(spec: str) -> list[torch.device]:
    out = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        name, _, times = item.partition("*")
        out += [torch.device(name.strip())] * (int(times) if times else 1)
    return out


def _listed_devices(device_type: str) -> list[torch.device]:
    """``PJ_MESH_DEVICES`` when it lists devices of ``device_type``, else
    nothing."""
    spec = os.environ.get(MESH_DEVICES_ENV, "")
    listed = _parse_devices(spec) if spec.strip() else []
    types = {d.type for d in listed}
    if len(types) > 1:
        raise ValueError(f"{MESH_DEVICES_ENV}={spec!r} mixes device types")
    return listed if types == {device_type} else []


def _resolve_type(device_type: str | None) -> str:
    if device_type is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    return device_type


def visible_devices(device_type: str | None = None) -> list[torch.device]:
    """The rank devices a mesh on ``device_type`` may use (``None``: cuda
    when a card is visible, else cpu): ``PJ_MESH_DEVICES`` when it lists
    devices of that type, else every card on cuda and one rank on cpu."""
    device_type = _resolve_type(device_type)
    listed = _listed_devices(device_type)
    if listed:
        return listed
    if device_type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(device_type)]


def default_devices(device_type: str | None = None) -> list[torch.device]:
    """The ranks of ``mesh_shape=None``: every rank device
    :func:`visible_devices` gives, as the JAX package's ``make_mesh(None)``
    takes every device, at f32 and f64 alike: on cuda every card
    ``CUDA_VISIBLE_DEVICES`` leaves visible, on cpu one rank
    (``PJ_MESH_DEVICES`` may list more on either)."""
    return visible_devices(device_type)


def _device_type(device) -> str | None:
    return None if device is None else torch.device(device).type


class Mesh:
    """Ranks over named axes: ``devices`` holds one ``torch.device`` per
    rank in row-major order of ``shape`` (an ordered axis -> size dict,
    as the JAX package's ``mesh.shape``); ``size`` is the rank count.

    ``world`` (set by ``multihost.global_mesh``) is this process's rank
    on a mesh whose ranks are the processes of the default group; the
    other ranks' entries of ``devices`` then only stand for them.

    ``collective_s`` sums, over the runs, the host seconds the slowest
    local rank spent in collectives (barrier waits included)."""

    def __init__(self, devices, axis_names, dims, *, world: int | None = None):
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in dims)))
        self.size = math.prod(self.shape.values())
        if len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"shape {self.shape}")
        self.world = world
        self._lock = threading.Lock()
        self._streams: dict = {}
        self._peers = None
        self._sources_mesh = None
        self.collective_s = 0.0

    # -- topology -------------------------------------------------------------

    @property
    def multiprocess(self) -> bool:
        return self.world is not None

    @property
    def local_ranks(self) -> list[int]:
        return [self.world] if self.multiprocess else list(range(self.size))

    def coords(self, rank: int) -> dict:
        """Rank -> {axis: index}, row-major."""
        out = {}
        for name in reversed(self.axis_names):
            rank, out[name] = divmod(rank, self.shape[name])
        return {name: out[name] for name in self.axis_names}

    def members(self, rank: int, axes: tuple) -> list[int]:
        """The ranks that share every coordinate of ``rank`` outside
        ``axes``: its group for a collective over ``axes``."""
        c = self.coords(rank)
        return [r for r in range(self.size)
                if all(self.coords(r)[a] == c[a]
                       for a in self.axis_names if a not in axes)]

    def group_keys(self) -> list[tuple]:
        """The collective axes the entry points use: the whole mesh, and
        on a 2-D mesh each source row's ``"edges"`` group."""
        keys = [self.axis_names]
        if len(self.axis_names) > 1:
            keys.insert(0, ("edges",))
        return keys

    def backends(self) -> list[str]:
        """What carries the mesh's collectives: ``["threads"]`` (the
        in-process exchange between rank threads), the default process
        group's backend on a multi-process mesh, none on one rank."""
        if self.size == 1:
            return []
        if self.multiprocess:
            return [tdist.get_backend()] if tdist.is_initialized() else []
        return ["threads"]

    def describe(self) -> str:
        """What runs: e.g. ``4-rank sources mesh on cuda:0 x4 (threads:
        ranks share a card)``."""
        dims = "x".join(str(n) for n in self.shape.values())
        head = (f"{self.size}-rank {' x '.join(self.axis_names)} mesh"
                if len(self.axis_names) == 1 else
                f"{dims} {' x '.join(self.axis_names)} mesh")
        if self.multiprocess:
            return (f"{head}, one rank per process "
                    f"({', '.join(self.backends()) or 'uninitialized'})")
        devs = [str(d) for d in self.devices]
        distinct = len(set(devs))
        on = f"{devs[0]} x{len(devs)}" if distinct == 1 else ", ".join(devs)
        if self.size == 1:
            return f"{head} on {on}"
        if self.devices[0].type != "cuda":
            why = "threads: CPU ranks"
        elif distinct == len(devs):
            why = "threads: a card per rank, device copies"
        elif distinct == 1:
            why = "threads: ranks share a card"
        else:
            why = "threads: ranks share cards, device copies"
        return f"{head} on {on} ({why})"

    def sharing(self, rank: int) -> int:
        """The ranks of this process's mesh on ``rank``'s device, itself
        included (1 on a multi-process mesh: one rank per process, each on
        a card of its own)."""
        if self.multiprocess:
            return 1
        return self.devices.count(self.devices[rank])

    def as_sources_mesh(self) -> "Mesh":
        """A 1-D ``"sources"`` mesh over the same ranks (what the
        predecessor sweep runs on under a 2-D mesh)."""
        if self.axis_names == ("sources",):
            return self
        if self._sources_mesh is None:
            self._sources_mesh = Mesh(self.devices, ("sources",),
                                      (self.size,), world=self.world)
        return self._sources_mesh

    # -- groups, streams and peer access ------------------------------------

    def _group_of(self, rank: int, key: tuple) -> tuple[int, list[int]]:
        members = self.members(rank, key)
        return members[0], members

    def peer_access(self) -> dict:
        """{(src, dst): peer access} for each ordered pair of distinct
        cards among this process's ranks. The first time, a copy is made
        between each pair (which sets up peer access where the pair has
        it), in the caller's thread: :meth:`run` calls this before its
        rank threads start, so no rank thread's first copy sets it up
        while its peers run kernels. A pair without peer access still
        copies card to card (``cudaMemcpyAsync`` stages the copy)."""
        with self._lock:
            if self._peers is None:
                cards = sorted({self.devices[r].index for r in
                                self.local_ranks
                                if self.devices[r].type == "cuda"})
                peers = {}
                for a in cards:
                    for b in cards:
                        if a != b:
                            torch.zeros(1, device=torch.device("cuda", a)).to(
                                torch.device("cuda", b))
                            torch.cuda.synchronize(a)
                            torch.cuda.synchronize(b)
                            peers[(a, b)] = (
                                torch.cuda.can_device_access_peer(a, b))
                self._peers = peers
            return dict(self._peers)

    def close(self) -> None:
        """Drop what this mesh keeps between runs, its ranks' streams (and
        those of its 1-D view); a later run makes them again."""
        with self._lock:
            self._streams.clear()
        if self._sources_mesh is not None:
            self._sources_mesh.close()

    def stream(self, rank: int):
        with self._lock:
            s = self._streams.get(rank)
            if s is None:
                s = self._streams[rank] = torch.cuda.Stream(self.devices[rank])
            return s

    # -- running one function on every local rank -----------------------------

    def run(self, fn: Callable, *, label: str = "mesh") -> list:
        """``fn(comm)`` on every local rank (a :class:`RankComm`), each in
        a thread of its own with its device set and, on a card, its own
        stream (which waits for the caller's stream first, and is synced
        before the thread returns). Returns the results by local rank.
        The first error of a rank raises here, after every rank has left;
        a rank that does not finish within the collective timeout plus
        ``JOIN_GRACE_S`` raises ``TimeoutError``, after the run's barriers
        are broken (which releases the ranks waiting at them)."""
        ranks = self.local_ranks
        caller = {d: torch.cuda.current_stream(d)
                  for d in {self.devices[r] for r in ranks}
                  if d.type == "cuda"}
        state = _RunState()
        results: dict = {}
        errors: dict = {}
        comms = {r: RankComm(self, r, state) for r in ranks}
        threaded = len(ranks) > 1
        if threaded:
            self.peer_access()

        def main(rank):
            dev = self.devices[rank]
            comm = comms[rank]
            try:
                if dev.type == "cuda":
                    torch.cuda.set_device(dev)
                    s = self.stream(rank)
                    s.wait_stream(caller[dev])
                    with torch.cuda.stream(s):
                        results[rank] = fn(comm)
                    s.synchronize()
                else:
                    results[rank] = fn(comm)
            except BaseException as e:  # noqa: BLE001 — surfaced by run()
                errors[rank] = e
                state.fail()

        if not threaded:
            main(ranks[0])
        else:
            threads = [threading.Thread(target=main, args=(r,), daemon=True,
                                        name=f"{label}-rank{r}")
                       for r in ranks]
            for t in threads:
                t.start()
            limit = state.timeout + JOIN_GRACE_S
            deadline = time.monotonic() + limit
            for t in threads:
                t.join(max(0.0, deadline - time.monotonic()))
            stuck = [t.name for t in threads if t.is_alive()]
            if stuck:
                state.fail()
                raise TimeoutError(f"{label}: ranks {stuck} still running "
                                   f"after {limit:.0f} s")
        if errors:
            root = [e for e in errors.values()
                    if not isinstance(e, MeshAborted)]
            raise (root or list(errors.values()))[0]
        self.collective_s += max(c.seconds for c in comms.values())
        out = [results[r] for r in ranks]
        for d, s in caller.items():
            _record_stream(out, s)
        return out


def _record_stream(obj, stream) -> None:
    """Tell the caching allocator that the caller's stream uses the
    rank's tensors in ``obj`` (they were made on the rank's stream)."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda and obj.device == stream.device:
            obj.record_stream(stream)
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            _record_stream(x, stream)
    elif isinstance(obj, dict):
        for x in obj.values():
            _record_stream(x, stream)


class _Fence:
    """A reusable barrier over a group's members, as ``threading.Barrier``
    but for one rule: a passage every member has reached stands. Breaking
    the fence (a failed rank, a timeout) ends the waits of passages still
    open and every later wait with ``threading.BrokenBarrierError``, never
    the wait of a member whose passage is complete (a ``threading.Barrier``
    broken by a fast member right after it released the others raises in
    those still waking up)."""

    def __init__(self, parties: int, timeout: float):
        self._cond = threading.Condition()
        self._parties = parties
        self._timeout = timeout
        self._count = 0
        self._passed = 0  # passages complete
        self._broken = False

    def wait(self) -> None:
        with self._cond:
            if self._broken:
                raise threading.BrokenBarrierError
            mine = self._passed
            self._count += 1
            if self._count == self._parties:
                self._count = 0
                self._passed += 1
                self._cond.notify_all()
                return
            if not self._cond.wait_for(
                    lambda: self._passed != mine or self._broken,
                    self._timeout):
                self._broken = True
                self._cond.notify_all()
            if self._passed == mine:
                raise threading.BrokenBarrierError

    def abort(self) -> None:
        with self._cond:
            self._broken = True
            self._cond.notify_all()


class _Exchange:
    """One collective group of one in-process run: a slot per member for
    what it posts (its spec ``(kind, shape, dtype)``, its tensor and, on a
    card, the event marking the tensor ready), a slot per member for the
    event marking its read done, and the two barriers a collective meets
    at (after the posts, after the reads)."""

    def __init__(self, n: int, timeout: float):
        self.posts: list = [None] * n
        self.reads: list = [None] * n
        self.posted = _Fence(n, timeout)
        self.read = _Fence(n, timeout)


class _RunState:
    """What the ranks of one in-process run share: an exchange per
    collective group, the barriers the ranks may wait at, whether a rank
    failed, and the collective timeout (``DEFAULT_TIMEOUT_S`` when the run
    started)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.failed = False
        self.timeout = DEFAULT_TIMEOUT_S
        self.exchanges: dict = {}  # (key, gid) -> _Exchange
        self.fences: list = []  # barriers the ranks may wait at

    def fail(self) -> None:
        """Mark the run failed and break its barriers: every rank leaves
        the barrier it waits at, or its next collective."""
        with self.lock:
            self.failed = True
            fences = list(self.fences)
        for fence in fences:
            fence.abort()

    def exchange(self, key: tuple, gid: int, n: int) -> _Exchange:
        """Group ``(key, gid)``'s exchange of ``n`` members, made at the
        group's first collective of the run."""
        with self.lock:
            if self.failed:
                raise MeshAborted("another rank of the mesh failed")
            ex = self.exchanges.get((key, gid))
            if ex is None:
                ex = self.exchanges[(key, gid)] = _Exchange(n, self.timeout)
                self.fences += [ex.posted, ex.read]
            return ex


def _event(stream):
    """An event recorded on ``stream`` now (None off the card)."""
    if stream is None:
        return None
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev


def _stacked(xs: list, dev: torch.device) -> torch.Tensor:
    """``xs`` copied in order into one [len(xs), ...] tensor on ``dev``."""
    out = torch.empty((len(xs), *xs[0].shape), dtype=xs[0].dtype,
                      device=dev)
    for row, x in zip(out, xs):
        row.copy_(x)
    return out


def _min_fold(xs: list, dev: torch.device) -> torch.Tensor:
    """The elementwise minimum of ``xs``, folded in order into a new
    tensor on ``dev`` (a tensor on another device is copied here first)."""
    acc = xs[0].to(dev, copy=True)
    for x in xs[1:]:
        torch.minimum(acc, x.to(dev), out=acc)
    return acc


def _for_group(t: torch.Tensor) -> torch.Tensor:
    """The tensor the default process group takes: a card tensor's host
    copy under gloo."""
    return t.cpu() if t.is_cuda and tdist.get_backend() != "nccl" else t


class RankComm:
    """One rank's view of a :meth:`Mesh.run`: its index, device and
    coordinates, and the collectives over mesh axes (the JAX package's
    ``all_gather`` / ``pmin``; the maxima of ``pmax`` are taken on the
    host from :meth:`gather_ints`). Every member of a group must make the
    same sequence of collective calls, with the same shapes and dtypes."""

    def __init__(self, mesh: Mesh, rank: int, state: _RunState):
        self.mesh = mesh
        self.rank = rank
        self.device = mesh.devices[rank]
        self.coords = mesh.coords(rank)
        self.seconds = 0.0  # in collectives, barrier waits included
        self._state = state

    def _key(self, axes) -> tuple:
        mesh = self.mesh
        key = mesh.axis_names if axes is None else tuple(axes)
        if not mesh.multiprocess and key not in mesh.group_keys():
            raise ValueError(f"no collective group over {key} on {mesh}")
        return key

    def _meet(self, barrier, what: str) -> None:
        try:
            barrier.wait()
        except threading.BrokenBarrierError:
            if self._state.failed:
                raise MeshAborted("another rank of the mesh failed") from None
            raise TimeoutError(f"{what}: rank {self.rank} waited "
                               f"{self._state.timeout:.0f} s for its "
                               "peers") from None

    def _trade(self, key: tuple, kind: str, t: torch.Tensor,
               read: Callable) -> object:
        """One collective of the in-process exchange over ``key``'s group:
        post ``t`` (with the event marking it ready on this rank's stream),
        meet; raise ``ValueError`` in every member if the members' specs
        differ; make this rank's stream wait each peer's event and return
        ``read(the members' tensors, in rank order)``, run on that stream;
        record the read, meet again, and make the stream wait every
        peer's read, so ``t`` is not reused before the peers' copies of it
        are done."""
        gid, members = self.mesh._group_of(self.rank, key)
        ex = self._state.exchange(key, gid, len(members))
        me = members.index(self.rank)
        what = f"{kind} over {key}"
        spec = (kind, tuple(t.shape), t.dtype)
        stream = torch.cuda.current_stream(t.device) if t.is_cuda else None
        ex.posts[me] = (spec, t, _event(stream))
        self._meet(ex.posted, what)
        for r, (other, _, _) in zip(members, ex.posts):
            if other != spec:
                raise ValueError(f"{what}: rank {self.rank} posted {spec}, "
                                 f"rank {r} posted {other}")
        if stream is not None:
            for j, (_, _, ready) in enumerate(ex.posts):
                if j != me:
                    stream.wait_event(ready)
        out = read([x for _, x, _ in ex.posts])
        ex.reads[me] = _event(stream)
        self._meet(ex.read, what)
        if stream is not None:
            for j, done in enumerate(ex.reads):
                if j != me:
                    stream.wait_event(done)
        return out

    def all_reduce_min_(self, t: torch.Tensor, axes=None):
        """``t`` replaced in place by its elementwise minimum over the
        group of ``axes`` (None: the whole mesh). Returns ``t``."""
        if self.mesh.size == 1:
            return t
        key = self._key(axes)
        t0 = time.perf_counter()
        x = t.contiguous()
        if self.mesh.multiprocess:
            x = _for_group(x)
            tdist.all_reduce(x, op=tdist.ReduceOp.MIN)
        else:
            dev = x.device
            x = self._trade(key, "all_reduce_min", x,
                            lambda xs: _min_fold(xs, dev))
        if x is not t:
            t.copy_(x)
        self.seconds += time.perf_counter() - t0
        return t

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``t`` (same shape on all), in rank order, on this
        rank's device."""
        if self.mesh.size == 1:
            return [t]
        key = self._key(None)
        t = t.contiguous()
        t0 = time.perf_counter()
        if self.mesh.multiprocess:
            x = _for_group(t)
            outs = [torch.empty_like(x) for _ in range(self.mesh.size)]
            tdist.all_gather(outs, x)
            outs = [o.to(self.device) for o in outs]
        else:
            outs = list(self._trade(
                key, "all_gather", t,
                lambda xs: _stacked(xs, self.device)).unbind(0))
        self.seconds += time.perf_counter() - t0
        return outs

    def gather_ints(self, values) -> np.ndarray:
        """Small integers of every rank (the per-rank sweep counts and
        flags): int64 [ranks, len(values)] on the host."""
        row = torch.tensor([int(v) for v in values], dtype=torch.int64)
        if self.mesh.size == 1:
            return row.numpy()[None]
        if self.mesh.multiprocess:
            if tdist.get_backend() == "nccl":
                row = row.to(self.device)
            return torch.stack(self.all_gather(row)).cpu().numpy()
        t0 = time.perf_counter()
        out = self._trade(self._key(None), "gather_ints", row,
                          lambda xs: torch.stack(xs).numpy())
        self.seconds += time.perf_counter() - t0
        return out


# -- mesh construction --------------------------------------------------------


def make_mesh(mesh_shape: tuple[int, ...] | None = None,
              axis_name: str = "sources", *, device=None) -> Mesh:
    """1-D mesh over ``axis_name`` (``"sources"`` for the fan-out,
    ``"edges"`` for edge-sharded Bellman-Ford) on ``device``'s type.
    ``mesh_shape=None`` takes every device :func:`visible_devices` gives
    (:func:`default_devices`); ``(n,)`` the first n of them."""
    devices = visible_devices(_device_type(device))
    if mesh_shape is not None:
        n = int(np.prod(mesh_shape))
        if n > len(devices):
            raise ValueError(
                f"mesh_shape {mesh_shape} needs {n} devices; "
                f"only {len(devices)} visible"
            )
        devices = devices[:n]
    return Mesh(devices, (axis_name,), (len(devices),))


def make_edge_mesh(mesh_shape: tuple[int, ...] | None = None, *,
                   device=None) -> Mesh:
    """1-D mesh over an ``"edges"`` axis (edge-sharded kernels)."""
    return make_mesh(mesh_shape, axis_name="edges", device=device)


def make_mesh_2d(mesh_shape: tuple[int, int], *, device=None) -> Mesh:
    """2-D ``("sources", "edges")`` mesh: rows on "sources", edge slices
    on "edges"."""
    ns, ne = int(mesh_shape[0]), int(mesh_shape[1])
    devices = visible_devices(_device_type(device))
    if ns * ne > len(devices):
        raise ValueError(
            f"mesh_shape {mesh_shape} needs {ns * ne} devices; "
            f"only {len(devices)} visible"
        )
    return Mesh(devices[:ns * ne], ("sources", "edges"), (ns, ne))


# -- helpers of the entry points ----------------------------------------------


def _fire_fault_hook(fault_hook) -> None:
    """Run the caller's fault-injection hook (``TorchBackend.
    _shard_fault_hook``) at the top of a sharded entry point, so an
    injected collective failure takes the except blocks a real one would.
    No-op when None."""
    if fault_hook is not None:
        fault_hook()


def _host_sources(sources) -> np.ndarray:
    if isinstance(sources, torch.Tensor):
        sources = sources.cpu().numpy()
    return np.asarray(sources, dtype=np.int64).reshape(-1)


def _pad_sources(sources: np.ndarray, n: int):
    """Pad a host source batch to a multiple of ``n`` shards, duplicating
    ``sources[0]``: padding rows take part in the still-improving flag,
    and an arbitrary vertex-0 row could need more sweeps than every
    requested source. Returns (padded, pad)."""
    b = sources.shape[0]
    pad = (-b) % n
    if pad:
        sources = np.concatenate([sources, np.full(pad, sources[0],
                                                   sources.dtype)])
    return sources, pad


def _fetch_shard_vec(iters_vec) -> np.ndarray:
    """Host copy of a per-rank count vector (gathered by every rank)."""
    if isinstance(iters_vec, torch.Tensor):
        iters_vec = iters_vec.cpu()
    return np.asarray(iters_vec)


def _row_sweeps_exact(vec: np.ndarray, stride: int, n_groups: int,
                      per_group: int, b_real: int) -> int:
    """Exact accounting in Python ints: each source group's sweep count x
    its REAL row count. ``vec`` holds one entry per rank; source group g
    reads entry g*stride (on a 2-D mesh every edges rank of a group
    reports the same lockstep count). Padding rows sit at the tail and may
    span several groups (11 rows on 8 groups: per_group 2, pad 5 across
    groups 5-7), so clip per group."""
    return sum(
        int(vec[g * stride])
        * max(0, min(per_group, b_real - g * per_group))
        for g in range(n_groups)
    )


def in_edge_layout(src, dst, w, num_nodes: int):
    """The fan-out sweep's in-edge CSC of a COO edge list, its +inf
    (padding) edges dropped: (indptr_in, src_in, w_in, work items)."""
    keep = w < float("inf")
    if not bool(keep.all()):
        src, dst, w = src[keep], dst[keep], w[keep]
    lay = build_in_edge_layout(src, dst, num_nodes)
    return (lay["indptr_in"], lay["src_in"], w[lay["order"]].contiguous(),
            lay["work_items"])


class _Placer:
    """Copies of the caller's tensors on each rank device, made once per
    device for a whole run (ranks that share a device share the copy).
    Given a mesh, the copies of ``objs`` (by key) are made at once, in the
    caller's thread, before the run: no rank thread copies the caller's
    tensors, so no such copy runs beside the ranks' kernels and
    collectives (on four H100s, when the mesh's collectives ran on NCCL
    groups, a rank that copied the in-edge CSC from the caller's card
    while the other ranks waited in an all-gather never returned from the
    copy)."""

    def __init__(self, mesh: Mesh | None = None, **objs):
        self._lock = threading.Lock()
        self._memo: dict = {}
        if mesh is not None:
            for r in mesh.local_ranks:
                for key, obj in objs.items():
                    self(obj, mesh.devices[r], key)

    def __call__(self, obj, dev: torch.device, key: str):
        return self.made(key, dev, lambda: _to(obj, dev))

    def made(self, key: str, dev: torch.device, make: Callable):
        """``make()``'s result, made once per (``key``, device)."""
        with self._lock:
            got = self._memo.get((key, dev))
            if got is None:
                got = self._memo[(key, dev)] = make()
            return got


def rank_hub_flags(comm, src_in, num_nodes: int, b: int, dtype):
    """The f64 sweep's hub flags (``fanout_sweep.hub_flags``) for one
    rank's [V, ``b``] block over the in-edge CSC it sweeps, the rule of
    every sharded route: built on a card, with the L2 budget
    ``HUB_L2_BYTES`` divided among the ranks that share it (four ranks on
    one card claim a quarter each, as ``suggested_source_batch`` divides
    the card's memory); None on the CPU and at f32, where no kernel reads
    them. The flags change no bit of the rows."""
    if comm.device.type != "cuda":
        return None
    return hub_flags(src_in, num_nodes, b, dtype,
                     budget=HUB_L2_BYTES // comm.mesh.sharing(comm.rank))


def _to(obj, dev):
    if isinstance(obj, torch.Tensor):
        return obj if obj.device == dev else obj.to(dev)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):  # a NamedTuple
        return type(obj)(*(_to(x, dev) for x in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to(x, dev) for x in obj)
    return obj


def _caller_device(*tensors) -> torch.device:
    for t in tensors:
        if isinstance(t, torch.Tensor):
            return t.device
    return torch.device("cpu")


def _assemble(blocks, dev: torch.device) -> torch.Tensor:
    """The ranks' row blocks in rank order, concatenated on ``dev``."""
    return torch.cat([blk.to(dev) for blk in blocks])


def _gather_rows(mesh: Mesh, outs, index: int, dev, *, stride: int = 1):
    """The full [B_padded, V] rows from the ranks' results (element
    ``index`` of each): concatenated on the caller's device in one
    process (every ``stride``-th rank: a 2-D mesh's "edges" ranks hold
    the same rows), or the block already gathered on every rank of a
    multi-process mesh."""
    if mesh.multiprocess:
        return outs[0][index].to(dev)
    return _assemble([o[index] for o in outs[::stride]], dev)


def _gathered(comm, block, gather: bool):
    """``block`` as the caller receives it: the whole rows gathered on
    every rank when ``gather`` (or on a multi-process mesh, where the
    caller holds only its own rank), else the rank's own block."""
    if gather or comm.mesh.multiprocess:
        return torch.cat(comm.all_gather(block))
    return block


def _dist0_vm(sources: torch.Tensor, num_nodes: int, dtype):
    b = sources.shape[0]
    d = torch.full((num_nodes, b), float("inf"), dtype=dtype,
                   device=sources.device)
    d[sources.long(), torch.arange(b, device=sources.device)] = 0.0
    return d


# -- the sharded entry points -------------------------------------------------


@traced("edge_sharded_bellman_ford")
def edge_sharded_bellman_ford(
    mesh: Mesh,
    dist0,
    src,
    dst,
    w,
    *,
    max_iter: int,
    edge_chunk: int = 1 << 20,
    fault_hook=None,
):
    """Bellman-Ford with the EDGE LIST sharded across ``mesh`` (a mesh
    from :func:`make_edge_mesh`). ``dist0`` is replicated ([V] or [B, V]);
    edges are padded to a rank multiple with (0, 0, +inf) no-ops. Each
    sweep relaxes the rank's edge slice (``relax.relax_sweep``), then one
    MIN all-reduce merges the slices; the still-improving flag is read
    after it, so every rank leaves the loop on the same sweep. Returns
    (dist, iterations, still_improving)."""
    _fire_fault_hook(fault_hook)
    n = mesh.size
    e = src.shape[0]
    pad = (-e) % n
    if pad:
        src = torch.cat([src, src.new_zeros(pad)])
        dst = torch.cat([dst, dst.new_zeros(pad)])
        w = torch.cat([w, w.new_full((pad,), float("inf"))])
    per = (e + pad) // n
    place = _Placer(mesh, dist0=dist0)
    # Each rank's edge slice on its device, copied before the run (see
    # _Placer).
    slices = {r: tuple(x[r * per:(r + 1) * per].to(mesh.devices[r])
                       for x in (src, dst, w)) for r in mesh.local_ranks}

    def body(comm):
        dev = comm.device
        s, t, wt = slices[comm.rank]
        d = place(dist0, dev, "dist0").clone()
        improving = bool(torch.isfinite(d).any())
        i = 0
        while improving and i < max_iter:
            nd = comm.all_reduce_min_(
                relax.relax_sweep(d, s, t, wt, edge_chunk=edge_chunk))
            improving = bool((nd < d).any())
            d = nd
            i += 1
        flags = comm.gather_ints([i, improving])
        return d, flags

    outs = mesh.run(body, label="edge_sharded_bellman_ford")
    d, flags = outs[0]
    return (d.to(_caller_device(dist0)), int(flags[:, 0].max()),
            bool(flags[:, 1].max()))


@traced("sharded_gs_fanout")
def sharded_gs_fanout(
    mesh: Mesh,
    sources,
    src_blk,
    dstl_blk,
    w_blk,
    rank,
    *,
    v_pad: int,
    vb: int,
    halo: int,
    max_outer: int,
    inner_cap: int,
    real_edges_host: np.ndarray,
    fault_hook=None,
):
    """N-source blocked Gauss-Seidel fan-out with sources sharded over
    ``mesh`` (1-D "sources" axis): the sequential block schedule runs per
    rank on its batch slice (``gauss_seidel.fanout_gs_body``), the layout
    and the relabeling ``rank`` replicated, no per-round collectives.
    Pads the batch to a rank multiple (duplicating ``sources[0]``; rows
    dropped from the output AND the work accounting).

    Returns (dist[B, V], rounds, still_improving, examined): ``examined``
    the exact Python-int candidate count, per rank sum(iters_blk x real
    edges) x that rank's REAL row count."""
    _fire_fault_hook(fault_hook)
    n = mesh.size
    srcs = _host_sources(sources)
    b = srcs.shape[0]
    srcs, pad = _pad_sources(srcs, n)
    per = (b + pad) // n
    place = _Placer(mesh, gs=(src_blk, dstl_blk, w_blk, rank))

    def body(comm):
        dev = comm.device
        mine = torch.as_tensor(srcs[comm.rank * per:(comm.rank + 1) * per],
                               device=dev)
        sb, db, wb, rk = place((src_blk, dstl_blk, w_blk, rank), dev, "gs")
        dist, rounds, improving, iters_blk = fanout_gs_body(
            mine, sb, db, wb, rk, v_pad=v_pad, vb=vb, halo=halo,
            max_outer=max_outer, inner_cap=inner_cap)[:4]
        vec = comm.gather_ints([rounds, improving,
                                *np.asarray(iters_blk).reshape(-1)])
        return dist, vec

    outs = mesh.run(body, label="sharded_gs_fanout")
    vec = _fetch_shard_vec(outs[0][1])
    rounds, improving = int(vec[:, 0].max()), bool(vec[:, 1].max())
    iters_mat = vec[:, 2:].astype(np.int64)  # [n, NB]
    warn_if_counter_wrapped(rounds, inner_cap, where="gs-sharded")
    edges = np.asarray(real_edges_host).astype(np.int64)
    examined = sum(
        int(np.dot(iters_mat[g], edges)) * max(0, min(per, b - g * per))
        for g in range(n)
    )
    dist = _gather_rows(mesh, outs, 0, _caller_device(w_blk))
    return dist[:b], rounds, improving, examined


@traced("sharded_dia_fanout")
def sharded_dia_fanout(
    mesh: Mesh,
    sources,
    w_diag,
    *,
    num_nodes: int,
    offsets: tuple,
    max_iter: int,
    num_entries: int,
    fault_hook=None,
):
    """N-source DIA stencil fan-out with sources sharded over ``mesh``
    (1-D "sources" axis): the chained roll sweeps (``ops.dia``) run per
    rank on its [b/n, V] row slice with the [K, V] diagonal weights
    replicated, no per-round collectives. Pads the batch to a rank
    multiple (duplicating ``sources[0]``).

    Returns (dist[B, V], iterations, still_improving, examined):
    ``examined`` per rank sweeps x stored diagonal entries x REAL rows."""
    _fire_fault_hook(fault_hook)
    n = mesh.size
    srcs = _host_sources(sources)
    b = srcs.shape[0]
    srcs, pad = _pad_sources(srcs, n)
    per = (b + pad) // n
    offsets = tuple(offsets)
    place = _Placer(mesh, w_diag=w_diag)

    def body(comm):
        dev = comm.device
        mine = torch.as_tensor(srcs[comm.rank * per:(comm.rank + 1) * per],
                               device=dev)
        wd = place(w_diag, dev, "w_diag")
        dist, iters, improving = dia_fixpoint(
            relax.multi_source_init(mine, num_nodes, wd.dtype), wd,
            offsets=offsets, max_iter=max_iter)
        return dist, comm.gather_ints([iters, improving])

    outs = mesh.run(body, label="sharded_dia_fanout")
    vec = _fetch_shard_vec(outs[0][1])
    examined = int(num_entries) * _row_sweeps_exact(
        vec[:, 0], stride=1, n_groups=n, per_group=per, b_real=b)
    dist = _gather_rows(mesh, outs, 0, _caller_device(w_diag))
    return dist[:b], int(vec[:, 0].max()), bool(vec[:, 1].max()), examined


@traced("sharded_tight_pred")
def sharded_tight_pred(
    mesh: Mesh,
    dist,
    sources,
    src,
    dst,
    w,
    *,
    num_nodes: int,
    edge_chunk: int = 1 << 20,
    in_edges=None,
):
    """Predecessor extraction with the distance rows sharded over
    ``mesh``'s "sources" axis (the mesh the fan-out ran on; on a 2-D mesh
    the first "edges" rank of each source group extracts, the others
    hold the same rows). Each rank runs the tight-edge pass
    (``ops.pred.tight_pred_pass``: the hand ``tight_pred`` kernel on the
    card) on its rows, vertex-major, against the replicated in-edge CSC
    ``in_edges`` (built from the COO ``src``/``dst``/``w`` when None),
    then the tree check (``edge_chunk``, the reference's argument, is
    unused: the pass over the CSC has no edge chunks). Pads
    ``dist``/``sources`` to a rank multiple by duplicating row 0
    (dropped from the output).

    Returns (pred[B, V] int32, ok): ``ok`` is the AND of the ranks' tree
    checks; False means a zero-weight tight cycle defeated the one-pass
    rule and the caller must fall back to the argmin sweep."""
    ns = int(mesh.shape.get("sources", mesh.size))
    stride = mesh.size // ns
    srcs = _host_sources(sources)
    b = srcs.shape[0]
    srcs, pad = _pad_sources(srcs, ns)
    if pad:
        dist = torch.cat([dist, dist[:1].expand(pad, -1)])
    per = (b + pad) // ns
    if in_edges is None:
        in_edges = in_edge_layout(src, dst, w, num_nodes)
    place = _Placer(mesh, in_edges=in_edges)

    def extracts(r):
        return not (mesh.coords(r).get("edges", 0)
                    and "sources" in mesh.axis_names)

    # Each extracting rank's rows on its device, copied before the run
    # (see _Placer).
    rows_of = {}
    for r in mesh.local_ranks:
        if extracts(r):
            g = mesh.coords(r).get("sources", r)
            rows_of[r] = dist[g * per:(g + 1) * per].to(mesh.devices[r])

    def body(comm):
        g = comm.coords.get("sources", comm.rank)
        if not extracts(comm.rank):
            return None, comm.gather_ints([1])
        dev = comm.device
        rows = rows_of[comm.rank]
        mine = torch.as_tensor(srcs[g * per:(g + 1) * per], device=dev)
        ip, s_in, w_in, items = place(in_edges, dev, "in_edges")
        hubs = place.made("hubs", dev, lambda: rank_hub_flags(
            comm, s_in, num_nodes, per, rows.dtype))
        pred_vm, flags = tight_pred_pass(rows.t().contiguous(), ip, s_in,
                                         w_in, items=items, sources=mine,
                                         hubs=hubs)
        pred, ok = certify_pred(pred_vm.t().contiguous(), rows, mine,
                                flags=flags)
        block = _gathered(comm, pred, False)
        return block, comm.gather_ints([bool(ok)])

    outs = mesh.run(body, label="sharded_tight_pred")
    ok = bool(np.all(_fetch_shard_vec(outs[0][1])))
    pred = _gather_rows(mesh, outs, 0, dist.device, stride=stride)
    return pred[:b], ok


@traced("sharded_fanout_2d")
def sharded_fanout_2d(
    mesh: Mesh,
    sources,
    src,
    dst,
    w,
    *,
    num_nodes: int,
    max_iter: int,
    edge_chunk: int = 1 << 20,
    layout: str = "source_major",
    with_row_sweeps: bool = False,
    fault_hook=None,
):
    """N-source fan-out with sources AND edges sharded over a 2-D mesh
    (from :func:`make_mesh_2d`): each rank holds a [B/n_s, V] row block
    and an E/n_e edge slice. Per sweep: relax the local edges, then one
    MIN all-reduce over the rank's "edges" group merges the partial
    relaxations; the improving flag is read after it, so a group's ranks
    stay in lockstep. Source groups run their fixpoints independently.
    Pads sources to a multiple of the "sources" axis (duplicating
    ``sources[0]``) and edges to a multiple of the "edges" axis.

    ``layout="vertex_major"``: the caller passes dst-sorted edges; each
    rank builds the fan-out sweep's in-edge CSC of its contiguous slice
    and runs ONE hand ``fanout_sweep`` launch per sweep on its [V, B/n_s]
    block (tail pad edges are (0, V-1, +inf), keeping the order). Source-
    major: ``relax.relax_sweep`` on the slice.

    Returns (dist[B, V], iterations, still_improving[, row_sweeps])."""
    _fire_fault_hook(fault_hook)
    ns, ne = mesh.shape["sources"], mesh.shape["edges"]
    srcs = _host_sources(sources)
    b = srcs.shape[0]
    srcs, spad = _pad_sources(srcs, ns)
    per = (b + spad) // ns
    e = src.shape[0]
    epad = (-e) % ne
    if epad:
        pad_dst = num_nodes - 1 if layout == "vertex_major" else 0
        src = torch.cat([src, src.new_zeros(epad)])
        dst = torch.cat([dst, dst.new_full((epad,), pad_dst)])
        w = torch.cat([w, w.new_full((epad,), float("inf"))])
    eper = (e + epad) // ne
    vm = layout == "vertex_major"
    # Each rank's edge slice on its device, copied before the run (see
    # _Placer).
    slices = {}
    for r in mesh.local_ranks:
        k = mesh.coords(r)["edges"]
        slices[r] = tuple(x[k * eper:(k + 1) * eper].to(mesh.devices[r])
                          for x in (src, dst, w))

    def body(comm):
        g, k = comm.coords["sources"], comm.coords["edges"]
        dev = comm.device
        mine = torch.as_tensor(srcs[g * per:(g + 1) * per], device=dev)
        s, t, wt = slices[comm.rank]
        if vm:
            lay = build_in_edge_layout(s, t, num_nodes)
            ip, s_in = lay["indptr_in"], lay["src_in"]
            w_in, items = wt[lay["order"]].contiguous(), lay["work_items"]
            d = _dist0_vm(mine, num_nodes, w.dtype)
            buf = torch.empty_like(d)
            hubs = rank_hub_flags(comm, s_in, num_nodes, per, d.dtype)
        else:
            d = relax.multi_source_init(mine, num_nodes, w.dtype)
        improving = bool(torch.isfinite(d).any())
        i = 0
        while improving and i < max_iter:
            if vm:
                nd, _ = fanout_sweep(d, ip, s_in, w_in, items=items, out=buf,
                                     hubs=hubs)
            else:
                nd = relax.relax_sweep(d, s, t, wt, edge_chunk=edge_chunk)
            comm.all_reduce_min_(nd, ("edges",))
            improving = bool((nd < d).any())
            if vm:
                buf = d
            d = nd
            i += 1
        if vm:
            d = d.t().contiguous()
        vec = comm.gather_ints([i, improving])
        return (d if k == 0 else None), vec

    outs = mesh.run(body, label="sharded_fanout_2d")
    vec = _fetch_shard_vec(outs[0][1])
    dist = _gather_rows(mesh, outs, 0, _caller_device(w), stride=ne)
    out = (dist[:b], int(vec[:, 0].max()), bool(vec[:, 1].max()))
    if with_row_sweeps:
        # Per source group g every edges rank reports the same sweep count
        # (lockstep): read entry g*ne.
        out = out + (_row_sweeps_exact(vec[:, 0], stride=ne, n_groups=ns,
                                       per_group=per, b_real=b),)
    return out


@traced("sharded_fanout")
def sharded_fanout(
    mesh: Mesh,
    sources,
    src,
    dst,
    w,
    *,
    num_nodes: int,
    max_iter: int,
    edge_chunk: int = 1 << 20,
    replicate: bool = False,
    with_pred: bool = False,
    layout: str = "source_major",
    with_row_sweeps: bool = False,
    n_real_rows: int | None = None,
    fault_hook=None,
    in_edges=None,
):
    """N-source fan-out with sources sharded over ``mesh``.

    Pads the source batch to a multiple of the rank count (padding rows
    duplicate ``sources[0]`` and are dropped) and runs each rank's rows
    against the whole edge list on its own device:

      - ``layout="vertex_major"``: the hand fan-out sweep to its fixpoint
        (``fanout_sweep.fanout_fixpoint``: the CUDA kernel on the card) on
        the rank's [V, B/n] block over the in-edge CSC ``in_edges``
        (``(indptr_in, src_in, w_in, items)``, built from the dst-sorted
        ``src``/``dst``/``w`` when None);
      - source-major: ``relax.bellman_ford_sweeps``;
      - ``with_pred=True``: ``relax.bellman_ford_sweeps_pred`` (the argmin
        sweep; source-major only).

    Rows come back assembled once on the caller's device (the device of
    ``w``); ``replicate=True`` runs the explicit ``all_gather`` so every
    rank holds the whole matrix (the returned tensor's ``replicas`` lists
    each local rank's copy). Returns (dist[B, V], iterations,
    still_improving), plus pred[B, V] when ``with_pred=True``, plus the
    exact row-sweep total (per rank sweeps x real rows) when
    ``with_row_sweeps=True``.

    ``n_real_rows``: when the caller already padded the batch
    (:func:`multihost.global_sources`), the number of genuine rows at the
    front; the duplicate tail rows stay out of the row-sweep accounting.
    """
    if with_pred and layout == "vertex_major":
        raise ValueError("with_pred requires the source_major layout")
    _fire_fault_hook(fault_hook)
    n = mesh.size
    srcs = _host_sources(sources)
    b = srcs.shape[0]
    srcs, pad = _pad_sources(srcs, n)
    acct_pad = pad + (b - n_real_rows if n_real_rows is not None else 0)
    per = (b + pad) // n
    vm = layout == "vertex_major" and not with_pred
    if vm and in_edges is None:
        in_edges = in_edge_layout(src, dst, w, num_nodes)
    place = (_Placer(mesh, in_edges=in_edges) if vm
             else _Placer(mesh, coo=(src, dst, w)))

    def body(comm):
        dev = comm.device
        mine = torch.as_tensor(srcs[comm.rank * per:(comm.rank + 1) * per],
                               device=dev)
        pred = None
        if vm:
            ip, s_in, w_in, items = place(in_edges, dev, "in_edges")
            hubs = place.made("hubs", dev, lambda: rank_hub_flags(
                comm, s_in, num_nodes, per, w_in.dtype))
            d_vm, iters, improving = fanout_fixpoint(
                _dist0_vm(mine, num_nodes, w_in.dtype), ip, s_in, w_in,
                max_iter=max_iter, items=items, hubs=hubs)
            d = d_vm.t().contiguous()
            del d_vm
        else:
            s, t, wt = place((src, dst, w), dev, "coo")
            d0 = relax.multi_source_init(mine, num_nodes, wt.dtype)
            if with_pred:
                d, pred, iters, improving = relax.bellman_ford_sweeps_pred(
                    d0, s, t, wt, max_iter=max_iter, edge_chunk=edge_chunk)
            else:
                d, iters, improving = relax.bellman_ford_sweeps(
                    d0, s, t, wt, max_iter=max_iter, edge_chunk=edge_chunk)
        vec = comm.gather_ints([iters, improving])
        d = _gathered(comm, d, replicate)
        if pred is not None:
            pred = _gathered(comm, pred, False)
        return d, vec, pred

    outs = mesh.run(body, label="sharded_fanout")
    vec = _fetch_shard_vec(outs[0][1])
    caller = _caller_device(w)
    if replicate:
        dist = outs[0][0].to(caller)[:b]
        dist.replicas = [o[0][:b] for o in outs]
    else:
        dist = _gather_rows(mesh, outs, 0, caller)[:b]
    out = (dist, int(vec[:, 0].max()), bool(vec[:, 1].max()))
    if with_pred:
        out = out + (_gather_rows(mesh, outs, 2, caller)[:b],)
    if with_row_sweeps:
        out = out + (_row_sweeps_exact(
            vec[:, 0], stride=1, n_groups=n, per_group=per,
            b_real=b + pad - acct_pad),)
    return out
