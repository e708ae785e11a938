"""Bootstrap, the world of ranks and synchronization — the port's copy
of ``tpu_p2p/parallel/runtime.py``.

One process per rank, as in the reference program (``mpirun -n N``,
``p2p_matrix.cc:105-122``), here as ``torchrun --nproc-per-node N`` or
``python -m tpu_p2p_torch --cpu-mesh N``:

- :func:`init_distributed` joins the launcher's world from its
  environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``PORT``);
  without one the process is a world of 1, as ``jax.distributed`` is
  off-cluster.
- :class:`Runtime` holds the rank, the world, the device, the validated
  placement (the reference's host-hash all-gather and contiguous-block
  check, ``p2p_matrix.cc:68-100``), a **host group** (gloo) for barriers,
  all-gathers and the IPC handle exchange, and a **device group** (NCCL)
  only when every rank has a card of its own.
- :class:`Mesh` is the port's counterpart of a ``jax.sharding.Mesh``:
  1-D over axis ``"d"`` (the whole world, ``rt.mesh``, or the pair of
  ``rt.submesh([a, b])``), 2-D over axes ``("x", "y")`` when
  ``make_runtime(mesh_shape=(A, B))`` lays the world out row-major
  (rank ``r`` at ``(r // B, r % B)``), or n-D over named axes
  (``mesh_shape=(dp, pp, sp, tp, ep), axis_names=AXES``, the flagship's
  five). Each line of a mesh along an axis (the ranks that differ only
  in that coordinate) is a 1-D mesh of its own, with its own groups and
  peer-push windows (:meth:`Mesh.line`): a collective along an axis runs
  on the lines. A plane over a set of axes (:meth:`Mesh.plane`, e.g.
  the flagship's data axes) is the same over several coordinates. An
  axis of size 1 gets no group: its lines are one-rank meshes, on which
  every collective is the identity.
- :meth:`Mesh.barrier` is a stream sync on the card, then a barrier of
  the host group: ``MPI_Barrier`` (``p2p_matrix.cc:146,201``).
- :class:`LocalMesh` is the in-process counterpart of a
  ``jax.sharding.Mesh`` that one controller drives whole, as the
  reference's disaggregated engine drives its ``mig`` mesh: each rank is
  a (device, stream) pair of this process, the same card may repeat, and
  a collective over the whole mesh takes one tensor per rank and returns
  one per rank. It may have several named axes (the serve mesh's
  ``("dp", "tp", "ep")``, row-major as a :class:`Mesh`): then
  :meth:`LocalMesh.run` drives one thread a rank, each on the rank's
  stream, through a per-rank body written for a process mesh, one rank
  issuing at a time, from one rendezvous to the next. The body sees its
  rank as a :class:`LocalRank` (``shape``, ``coords``, ``device``,
  ``line(axis)``), and a collective along a line (:class:`LocalLine`: a
  sum, an all-to-all, an all-gather) meets the line's other ranks at a
  rendezvous with a timeout, so a rank that fails or never arrives fails
  the run instead of hanging it.
"""

from __future__ import annotations

import contextlib
import datetime
import math
import os
import threading
from dataclasses import dataclass, field
from typing import ClassVar, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from tpu_p2p_torch.obs import ledger as _ledger
from tpu_p2p_torch.parallel import pallas_dma, topology
from tpu_p2p_torch.utils.errors import PlacementError, check

MESH_AXIS = "d"  # the one axis of the benchmark's 1-D meshes
MESH_AXES_2D = ("x", "y")  # the axes of a 2-D mesh (--mesh-shape AxB)
PG_TIMEOUT = datetime.timedelta(seconds=600)  # a collective waits this
# long for a peer before failing, instead of gloo's half hour
RENDEZVOUS_TIMEOUT_S = 120.0  # a LocalMesh rank waits this long at a
# collective for the other ranks of its line


def init_distributed() -> bool:
    """Join the launcher's world; → True when there is one. Without the
    launcher's environment this is a world of 1 (an in-memory store),
    so barriers and gathers work the same everywhere."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group("gloo", init_method="env://",
                                timeout=PG_TIMEOUT)
        return True
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1, timeout=PG_TIMEOUT)
    return False


@dataclass(eq=False)
class Mesh:
    """A group of ranks, in mesh order (``ranks[i]`` is the global rank
    at mesh index ``i``, row-major over ``dims``), seen from one rank of
    the world. Only members may use its groups."""

    ranks: Tuple[int, ...]
    rank: int                      # this process's global rank
    device: torch.device
    host_group: object             # gloo, over the members
    device_group: object = None    # NCCL, when every member has a card
    # of its own (None: the members share a card, or run on the CPU)
    windows: Dict = field(default_factory=dict)  # pallas_dma windows of
    # this set of ranks, by capacity (shared by both orders of a pair)
    axis_names: Tuple[str, ...] = (MESH_AXIS,)
    dims: Tuple[int, ...] = ()     # extent per axis; () = (size,)
    runtime: Optional["Runtime"] = None  # whose groups the lines and
    # planes of a multi-axis mesh use
    planes: Dict[Tuple[str, ...], "Mesh"] = field(default_factory=dict)
    # of a multi-axis mesh: this rank's plane over each axis set made so
    # far (a line is the plane over one axis)
    side: Optional[object] = field(default=None, repr=False)  # the
    # fused ship's push stream on the card, made at its first use

    def __post_init__(self) -> None:
        if not self.dims:
            self.dims = (len(self.ranks),)

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's coordinate along each axis (row-major layout)."""
        grid = torch.arange(self.size).reshape(self.dims)
        where = (grid == self.index).nonzero()[0].tolist()
        return dict(zip(self.axis_names, where))

    def line(self, axis: str) -> "Mesh":
        """This rank's line along ``axis``: the 1-D mesh of the members
        that differ from it only in that coordinate (the mesh itself when
        it is 1-D)."""
        if axis not in self.axis_names:
            raise ValueError(f"axis {axis!r} not in {self.axis_names}")
        if len(self.axis_names) == 1:
            return self
        return self.plane((axis,))

    def plane(self, axes: Sequence[str]) -> "Mesh":
        """This rank's plane over ``axes``: the members that differ from
        it only in those coordinates, as a 1-D mesh in row-major order
        over them (mesh order of the axes), named by the joined axis
        names. A plane of one rank (every axis of size 1) has no groups.
        Made on first use and cached; every rank of the world must ask
        for a new axis set at the same point (``new_group`` is collective
        over the world), as :meth:`Runtime.groups` says."""
        for a in axes:
            if a not in self.axis_names:
                raise ValueError(f"axis {a!r} not in {self.axis_names}")
        key = tuple(a for a in self.axis_names if a in axes)
        plane = self.planes.get(key)
        if plane is not None:
            return plane
        idx = [self.axis_names.index(a) for a in key]
        ranks = next(p for p in _planes(self.dims, idx)
                     if self.index in p)
        ranks = tuple(self.ranks[i] for i in ranks)
        if len(ranks) == 1:
            # No group for one rank; a world of one has the world's.
            made = self.runtime._groups if self.runtime else {}
            host, dev, windows = made.get(ranks, (None, None, {}))
        else:
            host, dev, windows = self.runtime.plane_groups(
                self.ranks, self.dims, idx)
        plane = Mesh(ranks=ranks, rank=self.rank, device=self.device,
                     host_group=host, device_group=dev, windows=windows,
                     axis_names=("+".join(key),) if len(key) > 1 else key)
        self.planes[key] = plane
        return plane

    @property
    def is_member(self) -> bool:
        return self.rank in self.ranks

    @property
    def index(self) -> int:
        """This rank's mesh index (its payload row)."""
        return self.ranks.index(self.rank)

    # The mesh-kind interface shared with :class:`LocalMesh`: what a
    # collective needs to take either kind. Here this process drives its
    # own rank alone, on its current stream.
    in_process: ClassVar[bool] = False

    @property
    def local_ranks(self) -> Tuple[int, ...]:
        """The mesh indices this process drives: its own."""
        return (self.index,)

    def rows(self, x, what: str = "x") -> list:
        """A collective's argument as per-rank tensors: this rank's."""
        return [x]

    def unrows(self, rows: list):
        """A collective's result from per-rank tensors: this rank's."""
        return rows[0]

    def on(self, i: int):
        """Work of this rank is issued on the current stream."""
        return contextlib.nullcontext()

    def stream(self, i: int):
        """The stream this rank's kernels launch on: the current one."""
        return torch.cuda.current_stream(self.device)

    def side_stream(self, i: int):
        """The stream the fused ship's push launches on, beside the
        caller's: one a mesh, made at first use."""
        if self.side is None:
            self.side = torch.cuda.Stream(device=self.device)
        return self.side

    def share(self, i: int, fused: bool = False) -> int:
        """Divisor of a spinning kernel's resident grid: 1 for a hop,
        since ranks of separate processes time-slice a shared card; 4
        for the fused ship's push and arrival (``fused``), which run in
        this process beside the rank's own compute: each takes at most a
        quarter of the resident CTAs, so they fit at once and half the
        card stays free for the compute."""
        return 4 if fused else 1

    def enter(self) -> None:
        """Nothing to join: this rank's work is on the caller's stream."""

    def exit(self) -> None:
        """Nothing to join: this rank's work is on the caller's stream."""

    def barrier(self) -> None:
        """Drain this rank's stream on the card, surface a fault of the
        peer-push kernel, then meet the other members."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
            pallas_dma.check_faults()
        dist.barrier(group=self.host_group)

    def all_true(self, flag: bool) -> bool:
        """True on every member when ``flag`` is true on every member."""
        t = torch.tensor([0 if flag else 1], dtype=torch.int32)
        dist.all_reduce(t, group=self.host_group)
        return int(t.item()) == 0


class RendezvousError(RuntimeError):
    """A :class:`LocalMesh` rank gave up at a collective: another rank of
    its line failed, or did not arrive within the timeout."""


class _Turns:
    """Whose turn it is to issue: one rank thread of a
    :class:`LocalMesh` runs at a time, from its start or a rendezvous to
    the next, while the others sleep on this lock or at a rendezvous.
    Every torch op drops and retakes the GIL; with the other ranks
    asleep it is never contended, where ranks racing for it hand it back
    and forth at every op (on an H100, a tp 4 serving step's host issue
    took about twice as long that way as with the ranks in turns)."""

    def __init__(self, timeout: float) -> None:
        self.timeout = timeout
        self.lock = threading.Lock()
        self.mine = threading.local()

    def take(self) -> None:
        if not self.lock.acquire(timeout=self.timeout):
            raise RendezvousError(f"a rank waited {self.timeout:g} s for "
                                  "its turn to issue")
        self.mine.held = True

    def give(self) -> bool:
        """Release this thread's turn; → whether it held one."""
        if not getattr(self.mine, "held", False):
            return False
        self.mine.held = False
        self.lock.release()
        return True


class _Rendezvous:
    """Where the ranks of one line of a :class:`LocalMesh` meet: each
    deposits its value, and after all have, each reads every value. The
    slots alternate between two buffers by exchange: a rank's next
    deposit goes to the other buffer, and the one after that waits at
    the next meeting until every rank has read this one. A rank gives up
    its turn to issue while it waits."""

    def __init__(self, members: Tuple[int, ...], name: str,
                 timeout: float, turns: _Turns) -> None:
        self.members, self.name, self.timeout = members, name, timeout
        self.turns = turns
        self.barrier = threading.Barrier(len(members), timeout=timeout)
        self.slots: list = [[None] * len(members) for _ in range(2)]
        self.count: list = [0] * len(members)   # exchanges made, a rank

    def reset(self) -> None:
        self.barrier.reset()
        self.count = [0] * len(self.members)

    def exchange(self, i: int, value) -> list:
        slots = self.slots[self.count[i] % 2]
        self.count[i] += 1
        slots[i] = value
        held = self.turns.give()
        try:
            self.barrier.wait()
        except threading.BrokenBarrierError:
            raise RendezvousError(
                f"rank {self.members[i]} at a collective of line "
                f"{self.name} {self.members}: another rank failed or did "
                f"not arrive within {self.timeout:g} s") from None
        finally:
            if held:
                self.turns.take()
        return list(slots)


@dataclass(eq=False)
class LocalLine:
    """One rank's line of a :class:`LocalMesh` along an axis, the
    in-process counterpart of a process mesh's ``line(axis)``: the
    collectives of :mod:`tpu_p2p_torch.parallel.collectives` take it
    wherever they take a line. Each collective is a rendezvous of the
    line's ranks: on a card every rank's stream waits for the event its
    peers recorded after making their inputs, and reads them (a copy
    across cards); sums run in line order, so every rank's sum is
    bitwise the same."""

    rendezvous: _Rendezvous
    index: int                     # this rank's index within the line
    device: torch.device
    in_process: ClassVar[bool] = True

    @property
    def size(self) -> int:
        return len(self.rendezvous.members)

    def _exchange(self, tensors: list) -> list:
        """Deposit this rank's tensors; → every member's, in line order,
        each readable on this rank's device and current stream."""
        cuda = self.device.type == "cuda"
        event = (torch.cuda.current_stream(self.device).record_event()
                 if cuda else None)
        got = self.rendezvous.exchange(self.index, (tensors, event))
        if not cuda:
            return [ts for ts, _ in got]
        here = torch.cuda.current_stream(self.device)
        out = []
        for ts, ev in got:
            mine = []
            for t in ts:
                here.wait_event(ev)
                if t.device != self.device:
                    # The copy orders after the source card's current
                    # stream in this thread: it waits for the peer too.
                    torch.cuda.current_stream(t.device).wait_event(ev)
                    t = t.to(self.device)
                else:
                    t.record_stream(here)
                mine.append(t)
            out.append(mine)
        return out

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the line, in line order, in ``x``'s dtype."""
        parts = [p for (p,) in self._exchange([x.contiguous()])]
        acc = parts[0].clone()
        for p in parts[1:]:
            acc.add_(p)
        return acc

    def all_to_all(self, x: torch.Tensor, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """Tiled all-to-all: chunk ``j`` of ``x`` along ``split_dim`` to
        member ``j``; the chunks received concatenated along
        ``concat_dim`` in line order."""
        chunks = list(x.chunk(self.size, dim=split_dim))
        got = self._exchange(chunks)
        return torch.cat([ts[self.index] for ts in got], dim=concat_dim)

    def all_gather(self, x: torch.Tensor) -> list:
        """Every member's ``x``, in line order."""
        return [p for (p,) in self._exchange([x])]


@dataclass(eq=False)
class LocalRank:
    """Rank ``index`` of a :class:`LocalMesh` as its per-rank body sees
    it: the face of a process :class:`Mesh` seen from one rank
    (``axis_names``, ``shape``, ``coords``, ``device``, ``line``), so
    the placement helpers and the per-rank model code take either."""

    mesh: "LocalMesh"
    index: int
    in_process: ClassVar[bool] = True

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return self.mesh.axis_names

    @property
    def shape(self) -> Dict[str, int]:
        return self.mesh.shape

    @property
    def device(self) -> torch.device:
        return self.mesh.devices[self.index]

    @property
    def coords(self) -> Dict[str, int]:
        return self.mesh.coords(self.index)

    def line(self, axis: str) -> LocalLine:
        return self.mesh.line(axis, self.index)


@dataclass(eq=False)
class LocalMesh:
    """A mesh whose ranks all live in this process: rank ``i`` is
    ``devices[i]`` with its own CUDA stream (and a side stream for the
    fused ship's push), or a CPU rank with neither. Ranks may share a
    card; their kernels then run concurrently. Collectives over the
    whole mesh take and return one tensor per rank
    (``tpu_p2p_torch.parallel.pallas_dma`` and ``collectives``).

    ``dims`` lays the ranks out row-major over ``axis_names`` (default:
    one axis over all of them). :meth:`run` drives a per-rank body on
    every rank at once, a thread a rank; a body's collectives along an
    axis run on :meth:`line`, a rendezvous of the ranks that differ only
    in that coordinate."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (MESH_AXIS,)
    dims: Tuple[int, ...] = ()     # extent per axis; () = (size,)
    windows: Dict = field(default_factory=dict)  # pallas_dma windows,
    # by capacity, one slab per rank
    timeout: float = RENDEZVOUS_TIMEOUT_S
    streams: Tuple = ()            # one a rank on cards; () = new ones
    side_streams: Tuple = ()
    in_process: ClassVar[bool] = True

    def __post_init__(self) -> None:
        devs = []
        for d in self.devices:
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", 0)
            check(d.type in ("cpu", "cuda"),
                  f"LocalMesh ranks live on cpu or cuda, not {d}")
            devs.append(d)
        check(len(devs) >= 1, "a LocalMesh needs at least one rank")
        check(len({d.type for d in devs}) == 1,
              f"LocalMesh ranks on mixed device types {devs}")
        self.devices = tuple(devs)
        self.axis_names = tuple(self.axis_names)
        self.dims = tuple(int(d) for d in self.dims) or (len(devs),)
        check(len(self.dims) == len(self.axis_names)
              and len(set(self.axis_names)) == len(self.axis_names),
              f"LocalMesh shape {self.dims} over axes {self.axis_names}: "
              "one distinct name per axis")
        check(math.prod(self.dims) == len(devs),
              f"LocalMesh shape {self.dims} != {len(devs)} ranks")
        cuda = devs[0].type == "cuda"
        if not self.streams:
            self.streams = tuple(
                torch.cuda.Stream(device=d) if cuda else None for d in devs)
        if not self.side_streams:
            self.side_streams = tuple(
                torch.cuda.Stream(device=d) if cuda else None for d in devs)
        check(len(self.streams) == len(self.side_streams) == len(devs),
              "a LocalMesh takes one stream and one side stream a rank")
        self._lines: Dict[Tuple[str, Tuple[int, ...]], _Rendezvous] = {}
        self._lines_lock = threading.Lock()
        self._turns = _Turns(self.timeout)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def ranks(self) -> Tuple[int, ...]:
        """Mesh indices double as ranks: the edge numbering."""
        return tuple(range(self.size))

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    def coords(self, i: int) -> Dict[str, int]:
        """Rank ``i``'s coordinate along each axis (row-major)."""
        out = {}
        for a, d in zip(reversed(self.axis_names), reversed(self.dims)):
            out[a] = i % d
            i //= d
        return {a: out[a] for a in self.axis_names}

    def index_of(self, coords: Dict[str, int]) -> int:
        """The rank at ``coords`` (axes left out: coordinate 0)."""
        i = 0
        for a, d in zip(self.axis_names, self.dims):
            i = i * d + int(coords.get(a, 0))
        return i

    def line_members(self, axis: str, i: int) -> Tuple[int, ...]:
        """The ranks that differ from rank ``i`` only along ``axis``, in
        order of that coordinate."""
        if axis not in self.axis_names:
            raise ValueError(f"axis {axis!r} not in {self.axis_names}")
        c = self.coords(i)
        return tuple(self.index_of({**c, axis: k})
                     for k in range(self.shape[axis]))

    def line(self, axis: str, i: int) -> LocalLine:
        """Rank ``i``'s line along ``axis``; its rendezvous is made once
        and shared by the line's ranks."""
        members = self.line_members(axis, i)
        key = (axis, members)
        with self._lines_lock:
            rv = self._lines.get(key)
            if rv is None:
                rv = _Rendezvous(members, axis, self.timeout, self._turns)
                self._lines[key] = rv
        return LocalLine(rv, members.index(i), self.devices[i])

    def submesh(self, ranks: Sequence[int],
                axis_names: Tuple[str, ...] = (MESH_AXIS,),
                dims: Tuple[int, ...] = ()) -> "LocalMesh":
        """The mesh of ``ranks`` of this one, laid out over
        ``axis_names``/``dims``, each rank keeping its streams, so work
        issued through either mesh as that rank is ordered on one
        stream."""
        ranks = list(ranks)
        return LocalMesh(tuple(self.devices[r] for r in ranks),
                         axis_names, dims, timeout=self.timeout,
                         streams=tuple(self.streams[r] for r in ranks),
                         side_streams=tuple(self.side_streams[r]
                                            for r in ranks))

    def rank(self, i: int) -> LocalRank:
        """Rank ``i`` as its per-rank body sees it."""
        if not 0 <= i < self.size:
            raise ValueError(f"rank {i} of a LocalMesh of {self.size}")
        return LocalRank(self, i)

    def run(self, fn, *rows, ranks: Optional[Sequence[int]] = None,
            threads: bool = True, sync: bool = True) -> list:
        """``fn(self.rank(i), rows[0][i], rows[1][i], ...)`` for each
        rank ``i`` of ``ranks`` (default: all), each issued on the rank's
        stream (:meth:`on`) under the caller's grad mode, one rank issuing
        at a time (``_Turns``); → the results in ``ranks`` order. With
        ``sync`` the ranks' streams wait for the
        caller's first and the caller's for theirs after (:meth:`enter`,
        :meth:`exit`); without, the caller orders the inputs and reads
        the results on the ranks' streams itself, so the ranks' work
        does not wait for other work on the caller's stream. With
        ``threads`` (and more than one rank) each
        rank runs in a thread of its own, so the bodies meet at their
        collectives; the ranks that take part in a collective must all be
        in ``ranks``. A rank that raises breaks its peers' rendezvous,
        and the first error that is not a :class:`RendezvousError` is
        raised. Without ``threads`` the bodies run one after another
        here, which is for bodies without a collective."""
        ranks = list(range(self.size)) if ranks is None else list(ranks)
        for r in rows:
            self.rows(r, "LocalMesh.run")
        grad = torch.is_grad_enabled()
        out: list = [None] * len(ranks)

        def body(k: int, i: int) -> None:
            # One per-rank body, recorded once: the collective ledger
            # hears rank ranks[0]'s collectives, as shard_map traces its
            # body once (tpu_p2p_torch.obs.ledger).
            with torch.set_grad_enabled(grad), self.on(i), \
                    _ledger.muted(k > 0):
                out[k] = fn(self.rank(i), *(r[i] for r in rows))

        if sync:
            self.enter()
        if not threads or len(ranks) <= 1:
            for k, i in enumerate(ranks):
                body(k, i)
            if sync:
                self.exit()
            return out
        errors: list = [None] * len(ranks)

        def target(k: int, i: int) -> None:
            try:
                self._turns.take()
                body(k, i)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors[k] = e
                with self._lines_lock:
                    for rv in self._lines.values():
                        rv.barrier.abort()
            finally:
                self._turns.give()

        workers = [threading.Thread(target=target, args=(k, i),
                                    name=f"local-rank-{i}", daemon=True)
                   for k, i in enumerate(ranks)]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        failed = [e for e in errors if e is not None]
        if failed:
            with self._lines_lock:
                for rv in self._lines.values():
                    rv.reset()
            raise next((e for e in failed
                        if not isinstance(e, RendezvousError)), failed[0])
        if sync:
            self.exit()
        return out

    @property
    def local_ranks(self) -> Tuple[int, ...]:
        """The mesh indices this process drives: all of them."""
        return self.ranks

    def rows(self, x, what: str = "x") -> list:
        """A collective's argument as per-rank tensors: one a rank."""
        rows = list(x)
        if len(rows) != self.size:
            raise ValueError(f"{what}: a LocalMesh of {self.size} ranks "
                             f"takes {self.size} per-rank tensors, got "
                             f"{len(rows)}")
        return rows

    def unrows(self, rows: list) -> list:
        """A collective's result: the per-rank list."""
        return list(rows)

    def on(self, i: int):
        """Context in which work is issued as rank ``i``: its card's
        stream (nothing on the CPU)."""
        s = self.streams[i]
        return torch.cuda.stream(s) if s is not None \
            else contextlib.nullcontext()

    def stream(self, i: int):
        """The stream rank ``i``'s kernels launch on: its own."""
        return self.streams[i]

    def side_stream(self, i: int):
        """Rank ``i``'s stream for the fused ship's push."""
        return self.side_streams[i]

    def share(self, i: int, fused: bool = False) -> int:
        """Divisor of a spinning kernel's resident grid for rank ``i``,
        a hop or the fused ship alike: twice the ranks on its card, so
        every rank's push and arrival fit on the card at once with room
        for the compute beside them."""
        return 2 * sum(1 for d in self.devices if d == self.devices[i])

    def enter(self) -> None:
        """On cards, each rank's stream waits for the caller's: a
        collective's inputs and outputs are made there."""
        if self.streams[0] is not None:
            for s, d in zip(self.streams, self.devices):
                s.wait_stream(torch.cuda.current_stream(d))

    def exit(self) -> None:
        """On cards, the caller's stream waits for every rank's, so what
        it issues next sees a collective's results (and the caching
        allocator may reuse what the ranks read)."""
        if self.streams[0] is not None:
            for s, d in zip(self.streams, self.devices):
                torch.cuda.current_stream(d).wait_stream(s)

    def synchronize(self) -> None:
        """Drain every rank's streams, then surface a fault of the
        peer-push kernels."""
        for s in self.streams + self.side_streams:
            if s is not None:
                s.synchronize()
        if self.devices[0].type == "cuda":
            pallas_dma.check_faults()

    def close(self) -> None:
        """Drain, then release the peer-push windows."""
        self.synchronize()
        pallas_dma.close_windows(self.windows)


@dataclass(eq=False)
class Runtime:
    """A validated world of ranks — the framework's ``ncclComm_t``."""

    rank: int
    world: int
    device: torch.device
    placement: topology.Placement
    mesh: Mesh
    _groups: Dict = field(default_factory=dict)
    _meshes: Dict = field(default_factory=dict)
    members: Optional[Tuple[int, ...]] = None  # a restricted runtime's
    # ranks (:meth:`restrict`); None: the whole world

    @property
    def num_devices(self) -> int:
        return self.world

    @property
    def host_group(self):
        return self.mesh.host_group

    def groups(self, ranks: Sequence[int]) -> tuple:
        """(host group, device group or None, windows) of a set of
        ranks, made once per set and cached, so two meshes over the same
        ranks share their groups and peer-push windows. Every rank of the
        world must call it, members or not, in the same order:
        ``new_group`` is collective over the world."""
        key = tuple(sorted(set(int(r) for r in ranks)))
        pool = self.members if self.members is not None \
            else range(self.world)
        check(len(key) == len(ranks) and all(r in pool for r in key),
              f"submesh ranks {tuple(ranks)} are not distinct ranks of "
              f"{tuple(pool)}")
        groups = self._groups.get(key)
        if groups is None:
            # A restricted runtime makes its groups among its members
            # alone: the ranks outside it do not take part.
            local = self.members is not None
            host = dist.new_group(list(key),
                                  use_local_synchronization=local)
            dev = None
            if self.mesh.device_group is not None:
                dev = dist.new_group(list(key), backend="nccl",
                                     use_local_synchronization=local)
            groups = (host, dev, {})
            self._groups[key] = groups
        return groups

    def plane_groups(self, ranks: Sequence[int], dims: Sequence[int],
                     axes: Sequence[int]) -> tuple:
        """:meth:`groups` of every plane over axis indices ``axes`` of
        the mesh of ``ranks`` laid out row-major over ``dims``, made in
        plane order (so every rank makes them in one order); → this
        rank's."""
        mine = None
        for plane in _planes(tuple(dims), list(axes)):
            members = tuple(ranks[i] for i in plane)
            groups = self.groups(members)
            if self.rank in members:
                mine = groups
        return mine

    def axis_mesh(self, dims: Sequence[int],
                  axis_names: Sequence[str],
                  ranks: Optional[Sequence[int]] = None) -> Mesh:
        """A mesh of the whole world over named axes, row-major over
        ``ranks`` (the global rank at each mesh position; default rank
        order — a ring order relabels the positions, never a value), with
        the groups of every line of every axis of size > 1 made axis by
        axis, line by line (:meth:`groups`: every rank calls this, in the
        same order; a rank set made before shares its groups). On cards
        each new line's communicator is formed here, so a step's first
        collective is not its first call."""
        dims = tuple(int(d) for d in dims)
        names = tuple(axis_names)
        check(math.prod(dims) == self.mesh.size,
              f"mesh shape {dims} != {self.mesh.size} devices")
        check(len(names) == len(dims) and len(set(names)) == len(names),
              f"mesh shape {dims} over axes {names}: one distinct name "
              "per axis (the default names cover 1-D or 2-D meshes)")
        world = self.mesh
        ranks = tuple(sorted(world.ranks)) if ranks is None \
            else tuple(int(r) for r in ranks)
        check(sorted(ranks) == sorted(world.ranks),
              f"mesh ranks {ranks} are not a permutation of the world's "
              f"{tuple(sorted(world.ranks))}")
        mesh = Mesh(ranks=ranks, rank=self.rank, device=self.device,
                    host_group=world.host_group,
                    device_group=world.device_group, windows=world.windows,
                    axis_names=names, dims=dims, runtime=self)
        if len(dims) > 1:
            lines = [mesh.line(name) for name in names]
            if world.device_group is not None:
                for line in lines:  # every rank: its lines in axis order
                    if line.device_group is not None and line.size > 1:
                        dist.all_reduce(torch.zeros(1, device=self.device),
                                        group=line.device_group)
        return mesh

    def restrict(self, ranks: Sequence[int]) -> "Runtime":
        """A runtime over ``ranks``, a subset of this world (the heal's
        surviving ranks): its mesh is 1-D over them in rank order, and
        it makes every group among them alone (``new_group(...,
        use_local_synchronization=True)``), so only the members call
        this and what they build on it, in the same order; the other
        ranks of the world go on without them."""
        ranks = tuple(sorted(set(int(r) for r in ranks)))
        check(self.rank in ranks and all(0 <= r < self.world
                                         for r in ranks),
              f"rank {self.rank} restricting the world to {ranks}")
        host = dist.new_group(list(ranks), use_local_synchronization=True)
        dev = None
        if self.mesh.device_group is not None:
            dev = dist.new_group(list(ranks), backend="nccl",
                                 use_local_synchronization=True)
            dist.all_reduce(torch.zeros(1, device=self.device), group=dev)
        flat = Mesh(ranks=ranks, rank=self.rank, device=self.device,
                    host_group=host, device_group=dev)
        rt = Runtime(rank=self.rank, world=self.world, device=self.device,
                     placement=self.placement, mesh=flat, members=ranks)
        flat.runtime = rt
        rt._groups[ranks] = (host, dev, flat.windows)
        return rt

    def submesh(self, device_ids: Sequence[int]) -> Mesh:
        """The 1-D mesh over ``device_ids`` (pair isolation), made with
        :meth:`groups` (so every rank calls it, in the same order)."""
        ranks = tuple(int(i) for i in device_ids)
        mesh = self._meshes.get(ranks)
        if mesh is not None:
            return mesh
        host, dev, windows = self.groups(ranks)
        mesh = Mesh(ranks=ranks, rank=self.rank, device=self.device,
                    host_group=host, device_group=dev, windows=windows)
        self._meshes[ranks] = mesh
        return mesh

    def barrier(self) -> None:
        """World barrier (``MPI_Barrier(MPI_COMM_WORLD)``)."""
        self.mesh.barrier()

    def broadcast(self, obj, src: int):
        """``obj`` as rank ``src`` holds it, on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=src, group=self.host_group)
        return box[0]

    def all_true(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on every rank."""
        return self.mesh.all_true(flag)

    def gather(self, obj) -> list:
        """Every rank's ``obj``, in rank order, on every rank."""
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.host_group)
        return out

    def close(self) -> None:
        """Wait for every rank's card and peers, release the peer-push
        windows and leave the world."""
        self.barrier()
        if self.device.type == "cuda":
            for windows in [self.mesh.windows] + [
                    g[2] for g in self._groups.values()]:
                pallas_dma.close_windows(windows)  # idempotent
        dist.destroy_process_group()


def _dim_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def local_shard(x, mesh, spec: Sequence):
    """This rank's block of the global array or tensor ``x`` under
    ``spec`` on ``mesh``: each split dim cut into equal blocks, the
    rank's block by its coordinates (row-major over a joint split).
    ``mesh=None``: ``x`` itself."""
    if mesh is None:
        return x
    shape, coords = mesh.shape, mesh.coords
    for dim, entry in enumerate(spec):
        axes = _dim_axes(entry)
        parts = math.prod(shape[a] for a in axes)
        if parts == 1:
            continue
        if x.shape[dim] % parts:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                             f"split over {axes} ({parts} parts)")
        block = 0
        for a in axes:
            block = block * shape[a] + coords[a]
        size = x.shape[dim] // parts
        index = [slice(None)] * x.ndim
        index[dim] = slice(block * size, (block + 1) * size)
        x = x[tuple(index)]
    return x


def pick_device(device=None) -> torch.device:
    """The rank's device: ``device`` when given (sharing a card is then
    the caller's choice), else ``cuda:{LOCAL_RANK}``, which must exist:
    more ranks on a host than it has cards is oversubscription."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", 0)
        return device
    local = int(os.environ.get("LOCAL_RANK", "0"))
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if local >= count:
        raise PlacementError(
            f"local rank {local} needs cuda:{local}, but this host has "
            f"{count} CUDA device(s): run one rank per card, or pass "
            "--cpu-mesh N for a world of CPU ranks"
        )
    return torch.device("cuda", local)


def _nccl_possible(keys: Sequence[Tuple[int, str]]) -> bool:
    """Every rank on a card of its own: ``keys`` are (host hash,
    device) per rank."""
    return all(d.startswith("cuda") for _, d in keys) \
        and len(set(keys)) == len(keys)


def _planes(dims: Tuple[int, ...], axes: Sequence[int]):
    """The planes of a row-major mesh of ``dims`` over the axis indices
    ``axes`` (a line when there is one): for each setting of the other
    coordinates (row-major), the mesh indices that vary along ``axes``,
    row-major over them."""
    grid = torch.arange(math.prod(dims)).reshape(dims)
    grid = grid.movedim(list(axes), list(range(-len(axes), 0)))
    size = math.prod(dims[a] for a in axes)
    return [tuple(p.tolist()) for p in grid.reshape(-1, size)]


def _ring_ordered(world: int, ring_topology) -> Tuple[int, ...]:
    """The 1-D mesh's ranks in the measured topology's ring order.

    ``ring_topology`` is a :class:`tpu_p2p_torch.topo.model.Topology`, or
    ``"history"`` to read the ``MULTICHIP_r*.json`` history in the working
    directory. A relabelling of which rank sits at which mesh position:
    the logical shift-by-1 ring rides the links the matrix recommends,
    and every transfer's payload is unchanged; a sum over more than 2
    ranks adds in a different order (see :func:`make_runtime`). → rank
    order when no usable topology exists or its size is not the
    world's."""
    identity = tuple(range(world))
    try:
        from tpu_p2p_torch.topo.model import Topology
        from tpu_p2p_torch.topo.place import ordered_devices, ring_order

        topo = ring_topology
        if isinstance(topo, str):
            topo = Topology.from_history(".", n=world)
        if topo is None or topo.n != world:
            return identity
        return tuple(ordered_devices(list(identity), ring_order(topo)))
    except Exception:  # noqa: BLE001 — placement advice must never break
        # bootstrap (a missing or corrupt history file): rank order
        return identity


def make_runtime(num_devices: Optional[int] = None,
                 device=None,
                 mesh_shape: Optional[Sequence[int]] = None,
                 axis_names: Optional[Sequence[str]] = None,
                 ring_topology=None,
                 apply_ring_order: bool = True) -> Runtime:
    """Bootstrap → device → placement check → groups (the setup block
    of ``p2p_matrix.cc:105-122``).

    ``num_devices`` must equal the world size when given: a launcher
    starts one rank per device, so the way to use N devices is a world
    of N (``--cpu-mesh N`` spawns exactly that many).

    ``mesh_shape`` (e.g. ``(4, 2)``) lays the world out as a mesh over
    ``axis_names`` (default ``("x", "y")`` for 2-D; a mesh of more axes
    names them, as the flagship's ``(dp, pp, sp, tp, ep)``) in row-major
    rank order, and makes the groups of every line of every axis of
    size > 1, axis by axis, line by line (the same order on every rank).
    Without it the mesh is 1-D over ``("d",)``, in rank order unless
    ``ring_topology`` is given for a world of more than 2 ranks: then in
    its ring order (:func:`_ring_ordered`; ``"history"`` reads the
    ``MULTICHIP_r*.json`` history in the working directory), so mesh
    index ``i`` is global rank ``ranks[i]``; first rank's choice,
    broadcast. ``apply_ring_order=False`` keeps rank order whatever the
    topology. The order permutes the ranks' positions: payloads move
    unchanged, but the library's sums add in group-rank order, so a sum
    over more than 2 ranks of a reordered mesh is reassociated (equal to
    float32 rounding, not bitwise). Hence no history is read unless
    asked: the reference reads it by default, its relabelling being
    bitwise. A multi-axis mesh (``mesh_shape``) stays in rank order: its
    axes encode structure the ring objective would scramble."""
    device = pick_device(device)
    init_distributed()
    rank, world = dist.get_rank(), dist.get_world_size()
    if num_devices is not None:
        check(num_devices <= world,
              f"requested {num_devices} devices but only {world} visible")
        check(num_devices == world,
              f"requested {num_devices} devices in a world of {world} "
              f"ranks: launch {num_devices} ranks instead")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    keys = [None] * world
    dist.all_gather_object(keys, (topology.host_hash(), str(device)))
    placement = topology.validate_placement([k[0] for k in keys])
    device_group = None
    if _nccl_possible(keys):
        device_group = dist.new_group(list(range(world)), backend="nccl")
        # Form the communicator with every rank now: a later
        # batch_isend_irecv over a pair must not be its first call.
        dist.all_reduce(torch.zeros(1, device=device), group=device_group)
    ranks = tuple(range(world))
    if (apply_ring_order and ring_topology is not None
            and mesh_shape is None and world > 2):
        box = [_ring_ordered(world, ring_topology) if rank == 0 else None]
        dist.broadcast_object_list(box, src=0)
        ranks = box[0]
    flat = Mesh(ranks=ranks, rank=rank, device=device,
                host_group=dist.group.WORLD, device_group=device_group)
    rt = Runtime(rank=rank, world=world, device=device,
                 placement=placement, mesh=flat)
    rt._groups[tuple(range(world))] = (flat.host_group, device_group,
                                       flat.windows)
    if mesh_shape is not None:
        rt.mesh = rt.axis_mesh(
            mesh_shape, axis_names or MESH_AXES_2D[:len(mesh_shape)])
    elif axis_names:
        rt.mesh = rt.axis_mesh((world,), axis_names, ranks=flat.ranks)
    return rt
