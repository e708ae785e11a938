"""The peer-push transport behind ``--transport pallas_dma``.

Port of ``tpu_p2p/parallel/pallas_dma.py`` (same module name, so a
reader finds the counterpart). On the TPU it is a Pallas kernel of raw
remote DMAs; here it is a hand-written CUDA kernel
(``tpu_p2p_torch/csrc/p2p_dma.cu``, built by
:mod:`tpu_p2p_torch.utils.cuda_build`) that stores into peer-mapped
windows. Two functions, each in three forms side by side, as for every
kernel of the port:

- :func:`dma_ppermute` — the ``ppermute(x, edges)`` contract (unique
  sources and destinations, rows with no real arrival become zeros),
  differentiable, its gradient the same hop over the reversed edges
  (the reference's custom_vjp, :220-242). Kernel:
  :func:`_dma_transport_permute_call`; plain version:
  :func:`_dma_ppermute_plain` (gloo on a process mesh, in-process copies
  on a :class:`~tpu_p2p_torch.parallel.runtime.LocalMesh`).
- :func:`dma_ship_compute` — the fused per-chunk unit of the chunk
  waves and the gather ring: the push of ``ship`` is in flight while
  ``compute_fn`` runs, then the arrival lands (the reference's :364,
  custom_vjp :331-356). Kernel: :func:`_dma_transport_ship_call`, whose
  push and arrival (a wait for the peer's flag, or the copy out of the
  slab) are two launches on two streams of the rank (the ``.cu`` file
  says why); plain version: the compute, then
  :func:`_dma_ppermute_plain`.

Where each rank's push lands is decided per hop by :func:`plan_hop`:
straight into the receiver's output wherever this process can address
it (every edge of a ``LocalMesh``, a self-edge on any mesh), else into
the receiver's IPC-mapped slab; a push toward a dummy arrival moves no
bytes, and that receiver zero-fills its own output.

A wrapper takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises.

Two kinds of mesh. A process mesh (``runtime.Mesh``) is one rank per
process: a function takes and returns this rank's tensor. A
``LocalMesh`` is every rank in this process, each a (device, stream)
pair: a function takes a list of per-rank tensors and returns one, the
rows a ``shard_map`` body sees on each device. Both meshes answer the
same questions (``rows``/``unrows``, ``local_ranks``, ``on``,
``stream``, ``share``, ``enter``/``exit``), so the code here does not
ask which kind it has, apart from the windows and the plain copies. A
``LocalMesh``'s ranks' kernels run concurrently, so their grids are
capped to leave room for each other (``share``), as are the fused
ship's push and arrival beside the compute of a process mesh's rank.
The fused ship runs on both kinds: on a ``LocalMesh`` (the
disaggregated engine's KV migration) and on a process mesh (one line of
the flagship's mesh, under ``ring_allgather_matmul(transport=
"pallas_dma")`` and the chunk waves).

Edge sets are completed to a total permutation first
(:func:`complete_permutation`, copied from the reference with equal
tables): every rank pushes exactly one buffer and receives exactly one,
ranks without a real edge over dummy edges whose arrivals are zeroed.
Every rank of the mesh takes part in every call.

Windows: one per set of ranks and capacity (``mesh.windows``), made the
first time a payload needs it. On a process mesh every member allocates
a slab and flags with ``cudaMalloc``, the 64-byte IPC handles are
all-gathered over the host group, and each member maps the others'. On
a ``LocalMesh`` this process allocates one header of flags per rank on
the rank's card (no slab: every push lands in an output) and enables
peer access between cards. They live until :func:`close_windows`.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpu_p2p_torch.obs import ledger as _obs
from tpu_p2p_torch.utils.errors import BackendError, TransferTimeout

Edge = Tuple[int, int]

# Kernel launches since the last reset — a plain count, so a run can
# show that its main path went through the kernel. Only a launch counts:
# the plain version (CPU) adds nothing. ``dma_ship`` counts push
# launches of the fused ship, one per rank per call.
launches = {"dma_permute": 0, "dma_ship": 0}

SPIN_TIMEOUT_S = 10.0  # how long the kernel waits for a peer's flag
MIN_WINDOW = 1 << 20   # smallest slab a window gets


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def complete_permutation(edges: Sequence[Edge], n: int):
    """Complete a partial permutation to a total one.

    → ``(dst_table, src_table, has_in)`` as numpy arrays of length
    ``n``: ``dst_table[r]`` is where rank ``r``'s push lands (a dummy
    target for ranks with no real outgoing edge), ``src_table[r]`` is
    who pushes into rank ``r``, and ``has_in[r]`` says whether that
    arrival is a real edge (False → the row zeroes). Unmatched senders
    pair with unmatched receivers in sorted order, so the completion is
    deterministic.
    """
    edges = tuple((int(s), int(d)) for s, d in edges)
    dsts = [d for _, d in edges]
    srcs = [s for s, _ in edges]
    if len(set(dsts)) != len(dsts) or len(set(srcs)) != len(srcs):
        raise ValueError(f"edge set {edges} is not a partial "
                         "permutation (duplicate source or destination)")
    for s, d in edges:
        if not (0 <= s < n and 0 <= d < n):
            raise ValueError(f"edge ({s}, {d}) out of range for axis "
                             f"of size {n}")
    dst_table = np.full(n, -1, np.int32)
    has_in = np.zeros(n, bool)
    for s, d in edges:
        dst_table[s] = d
        has_in[d] = True
    free_dst = [r for r in range(n) if not has_in[r]]
    free_src = [r for r in range(n) if dst_table[r] < 0]
    for s, d in zip(free_src, free_dst):
        dst_table[s] = d
    src_table = np.empty(n, np.int32)
    src_table[dst_table] = np.arange(n, dtype=np.int32)
    return dst_table, src_table, has_in


# Codes of the kernel's Push and Arrival enums (csrc/p2p_dma.cu).
PUSH = {"none": 0, "out": 1, "slab": 2}
ARRIVAL = {"none": 0, "wait": 1, "copy": 2, "zero": 3}


class Hop(NamedTuple):
    """What one rank's launch of a hop does.

    ``push``: ``"out"`` stores straight into the receiver's output,
    ``"slab"`` into the receiver's receive slab, ``"none"`` moves no
    bytes (the receiver's arrival is a dummy edge). ``arrival``:
    ``"none"`` (the rank's own push wrote its output: a self-edge),
    ``"wait"`` (a peer stores into the output: wait for its flag),
    ``"copy"`` (copy each slab segment out as it lands), ``"zero"`` (a
    dummy arrival: zero-fill). ``dest``: the address the push stores to,
    None when it moves no bytes."""

    push: str
    arrival: str
    dest: Optional[int]


def plan_hop(in_process: bool, i: int, tables, outs: Dict[int, int],
             slabs: Dict[int, int]) -> Hop:
    """The launch of mesh index ``i`` for one hop of
    :func:`complete_permutation`'s ``tables``. ``outs`` maps the mesh
    indices whose outputs this process holds to their addresses (every
    rank on a ``LocalMesh``, its own on a process mesh), ``slabs`` every
    mesh index to its window's slab address. A push goes straight into
    the receiver's output wherever this process holds it, into its slab
    otherwise, and nowhere when the receiver's arrival is a dummy."""
    dst_t, src_t, has_in = tables
    d, s = int(dst_t[i]), int(src_t[i])
    if not has_in[d]:
        push, dest = "none", None
    elif in_process or d == i:
        push, dest = "out", outs[d]
    else:
        push, dest = "slab", slabs[d]
    if not has_in[i]:
        arrival = "zero"
    elif s == i:
        arrival = "none"
    else:
        arrival = "wait" if in_process else "copy"
    return Hop(push, arrival, dest)


# ------------------------------------------------------------ meshes


def _device_type(rows) -> str:
    kinds = {r.device.type for r in rows}
    if len(kinds) != 1:
        raise ValueError(f"per-rank tensors on mixed device types {kinds}")
    kind = kinds.pop()
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {kind}")
    return kind


def check_rows(rows) -> None:
    """Every rank's tensor of one call has one shape and dtype."""
    shapes = {(tuple(r.shape), r.dtype) for r in rows}
    if len(shapes) != 1:
        raise ValueError(f"per-rank tensors differ in shape or dtype: "
                         f"{sorted(map(str, shapes))}")


# ------------------------------------------------------------ plain


def _dma_ppermute_plain(x, mesh, edges: Sequence[Edge], tables=None):
    """Plain version: the completed permutation as copies. On a process
    mesh, send/recv over its host group (gloo), a local copy for a
    self-edge; on a ``LocalMesh``, one copy per rank onto the rank's
    device. Zeros for a dummy arrival. Same arguments and result as
    :func:`dma_ppermute`."""
    if tables is None:
        tables = complete_permutation(edges, mesh.size)
    dst_t, src_t, has_in = tables
    if mesh.in_process:
        rows = [r.contiguous() for r in mesh.rows(x)]
        return [rows[src_t[i]].to(mesh.devices[i], copy=True)
                if has_in[i] else torch.zeros_like(rows[i])
                for i in range(mesh.size)]
    i = mesh.index
    x = x.contiguous()
    if dst_t[i] == i:
        arrived = x.clone()
    else:
        arrived = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, mesh.ranks[dst_t[i]],
                          mesh.host_group),
               dist.P2POp(dist.irecv, arrived, mesh.ranks[src_t[i]],
                          mesh.host_group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return arrived if has_in[i] else torch.zeros_like(x)


# ------------------------------------------------------------ kernel

_LIB = None
_FAULT = None  # (host address, device address) of the fault record


class _FaultRecord(ctypes.Structure):
    _fields_ = [("phase", ctypes.c_int), ("rank", ctypes.c_int),
                ("peer", ctypes.c_int), ("pad", ctypes.c_int),
                ("epoch", ctypes.c_ulonglong)]


_LAUNCHES = ("tp_dma_permute", "tp_dma_ship_push", "tp_dma_ship_arrive")


def _lib():
    """The built kernel library, with its C signatures declared."""
    global _LIB
    if _LIB is None:
        from tpu_p2p_torch.utils.cuda_build import load

        lib = load("p2p_dma")
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong
        hop = [p, p, p, u, p, p, p, i, i, i, i, i, i, i, i, i, u, u, p, i,
               p]
        for name, args in (
                ("tp_dma_window_alloc", [u, ctypes.POINTER(p), p]),
                ("tp_dma_window_open", [p, ctypes.POINTER(p)]),
                ("tp_dma_window_close", [p]),
                ("tp_dma_window_free", [p]),
                ("tp_dma_enable_peer", [i, i]),
                ("tp_dma_fault_alloc", [ctypes.POINTER(p),
                                        ctypes.POINTER(p)]),
                *((name, hop) for name in _LAUNCHES)):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = i
        for name in ("tp_dma_max_ranks", "tp_dma_fault_bytes",
                     "tp_dma_header_bytes"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i
        if lib.tp_dma_fault_bytes() != ctypes.sizeof(_FaultRecord):
            raise BackendError("p2p_dma fault record layout mismatch")
        _LIB = lib
    return _LIB


def _cuda_check(err: int, what: str) -> None:
    if err:
        raise BackendError(f"{what} failed: CUDA error {err}")


def _fault_record():
    global _FAULT
    if _FAULT is None:
        host, dev = ctypes.c_void_p(), ctypes.c_void_p()
        _cuda_check(_lib().tp_dma_fault_alloc(ctypes.byref(host),
                                              ctypes.byref(dev)),
                    "cudaHostAlloc of the fault record")
        _FAULT = (host.value, dev.value)
    return _FAULT


def check_faults() -> None:
    """Raise :class:`TransferTimeout` when a kernel launched by this
    process gave up waiting for a peer. The record is host-mapped, so
    read it after a drain to see every launch before the drain."""
    if _FAULT is None:
        return
    f = _FaultRecord.from_address(_FAULT[0])
    if f.phase:
        what = "ready signal" if f.phase == 1 else "arrival"
        msg = (f"pallas_dma kernel on rank {f.rank} gave up waiting for "
               f"rank {f.peer}'s {what} at epoch {f.epoch}")
        ctypes.memset(_FAULT[0], 0, ctypes.sizeof(_FaultRecord))
        raise TransferTimeout(msg)


def _check_members(n: int) -> None:
    if n > _lib().tp_dma_max_ranks():
        raise BackendError(
            f"pallas_dma windows hold at most {_lib().tp_dma_max_ranks()}"
            f" ranks, the mesh has {n}")


class _Window:
    """One symmetric window of a process mesh: a slab of ``capacity``
    bytes and its flags on every member, mapped into every other
    member."""

    def __init__(self, mesh, capacity: int) -> None:
        lib = _lib()
        members = sorted(mesh.ranks)
        _check_members(len(members))
        self.slot = {r: k for k, r in enumerate(members)}
        self.capacity = capacity
        self.epoch = 0
        base, handle = ctypes.c_void_p(), ctypes.create_string_buffer(64)
        _cuda_check(lib.tp_dma_window_alloc(
            capacity, ctypes.byref(base), ctypes.cast(handle,
                                                      ctypes.c_void_p)),
                    f"window of {capacity} bytes")
        self.own = base.value
        handles = [None] * len(members)
        dist.all_gather_object(handles, handle.raw, group=mesh.host_group)
        self.bases = {}
        for r in members:
            if r == mesh.rank:
                self.bases[r] = self.own
                continue
            peer = ctypes.c_void_p()
            raw = ctypes.create_string_buffer(handles[self.slot[r]], 64)
            err = lib.tp_dma_window_open(ctypes.cast(raw, ctypes.c_void_p),
                                         ctypes.byref(peer))
            if err:
                raise BackendError(
                    f"cudaIpcOpenMemHandle of rank {r}'s window failed "
                    f"(CUDA error {err}): the pallas_dma transport needs "
                    "every rank of the mesh on one host")
            self.bases[r] = peer.value
        header = lib.tp_dma_header_bytes()
        # By global rank: both orders of a pair share the window.
        self.slabs = {r: b + header for r, b in self.bases.items()}

    sys_scope = True  # peers are other processes

    def close(self) -> None:
        lib = _lib()
        for r, b in self.bases.items():
            if b != self.own:
                lib.tp_dma_window_close(b)
        lib.tp_dma_window_free(self.own)
        self.bases = {}


class _LocalWindow:
    """The windows of a ``LocalMesh``: a header of flags per rank, all
    allocated by this process on the ranks' own cards (no slab: every
    push lands in an output this process holds); ranks on different
    cards reach each other by peer access."""

    def __init__(self, mesh) -> None:
        lib = _lib()
        _check_members(mesh.size)
        cards = sorted({d.index for d in mesh.devices})
        self.sys_scope = len(cards) > 1  # else flags at the card's scope
        self.slabs = {}
        for a in cards:
            for b in cards:
                if a != b:
                    _cuda_check(lib.tp_dma_enable_peer(a, b),
                                f"peer access cuda:{a} -> cuda:{b}")
        self.slot = {r: r for r in range(mesh.size)}
        self.epoch = 0
        self.bases = {}
        handle = ctypes.create_string_buffer(64)  # unused in-process
        for r, dev in enumerate(mesh.devices):
            base = ctypes.c_void_p()
            with torch.cuda.device(dev):
                _cuda_check(lib.tp_dma_window_alloc(
                    0, ctypes.byref(base),
                    ctypes.cast(handle, ctypes.c_void_p)),
                    f"rank {r}'s flags on {dev}")
            self.bases[r] = base.value

    def close(self) -> None:
        lib = _lib()
        for b in self.bases.values():
            lib.tp_dma_window_free(b)
        self.bases = {}


def _window(mesh, nbytes: int):
    """The window of ``mesh``'s rank set for a payload of ``nbytes``: a
    ``LocalMesh``'s one set of flags, or a process mesh's smallest
    window that holds ``nbytes``, made (collectively) when none does."""
    if mesh.in_process:
        if 0 not in mesh.windows:
            mesh.windows[0] = _LocalWindow(mesh)
        return mesh.windows[0]
    fits = [c for c in mesh.windows if c >= nbytes]
    if fits:
        return mesh.windows[min(fits)]
    cap = max(MIN_WINDOW, 1 << max(0, nbytes - 1).bit_length())
    with torch.cuda.device(mesh.device):
        win = _Window(mesh, cap)
    mesh.windows[cap] = win
    return win


def close_windows(windows: dict) -> None:
    """Release a mesh's windows (after a drain: no kernel may still be
    pushing)."""
    for win in windows.values():
        win.close()
    windows.clear()


def _plan(mesh, win, tables, outs) -> Dict[int, Hop]:
    """:func:`plan_hop` for every rank this process drives, ``outs``
    being their outputs in ``mesh.local_ranks`` order."""
    held = {i: o.data_ptr() for i, o in zip(mesh.local_ranks, outs)}
    slabs = {k: win.slabs[r] for k, r in enumerate(mesh.ranks)
             if r in win.slabs}
    return {i: plan_hop(mesh.in_process, i, tables, held, slabs)
            for i in mesh.local_ranks}


def _launch(entry: str, hop: Hop, x, out, mesh, win, i: int, tables,
            timeout_s, stream) -> None:
    """One launch of the library's ``entry`` for mesh index ``i`` on
    ``stream``: ``x`` is what the rank pushes (None for the ship's
    arrival), ``out`` where its arrival lands, ``hop`` what
    :func:`plan_hop` decided; the fused ship's launches take the mesh's
    ``share`` for a kernel beside the rank's compute. Raises when the
    launch is refused."""
    dst_t, src_t, _ = tables
    me, d, s = mesh.ranks[i], mesh.ranks[dst_t[i]], mesh.ranks[src_t[i]]
    with torch.cuda.device(out.device):
        err = getattr(_lib(), entry)(
            x.data_ptr() if x is not None else None, out.data_ptr(),
            hop.dest if x is not None else None,
            out.numel() * out.element_size(), win.bases[me], win.bases[d],
            win.bases[s], win.slot[me], win.slot[d], win.slot[s], me, d, s,
            PUSH[hop.push], ARRIVAL[hop.arrival], int(win.sys_scope),
            win.epoch,
            int(timeout_s * 1e9), _fault_record()[1],
            mesh.share(i, fused=entry != "tp_dma_permute"),
            stream.cuda_stream)
    if err:
        raise BackendError(
            f"{entry} kernel launch failed: CUDA error {err} "
            f"({torch.cuda.get_device_name(out.device)})")


def _begin(mesh, rows):
    """A fresh epoch on the window that holds ``rows``, after surfacing
    any earlier fault; the ranks' streams then join the caller's."""
    win = _window(mesh, rows[0].numel() * rows[0].element_size())
    check_faults()
    win.epoch += 1
    mesh.enter()
    return win


def _dma_transport_permute_call(x, mesh, tables, *,
                                timeout_s: float = SPIN_TIMEOUT_S):
    """One total-permutation push on the card: each rank's ``x`` into
    its destination's output (or slab, :func:`plan_hop`), then its
    arrival (a wait, a segment-wise copy out of the slab, or zeros).
    ``x`` is this rank's tensor (process mesh) or the per-rank list
    (``LocalMesh``), and so is the result. ``tables`` are
    :func:`complete_permutation`'s for the hop's edges.

    Replaces ``tpu_p2p/parallel/pallas_dma.py::_dma_transport_permute_call``
    (:146). Launches on the rank's stream, allocates only the output,
    and raises when the launch is refused; a peer that never comes
    surfaces as :class:`TransferTimeout` from :func:`check_faults`."""
    rows = [r.contiguous() for r in mesh.rows(x)]
    check_rows(rows)
    outs = [torch.empty_like(r) for r in rows]
    if rows[0].numel():
        win = _begin(mesh, rows)
        hops = _plan(mesh, win, tables, outs)
        for k, i in enumerate(mesh.local_ranks):
            _launch("tp_dma_permute", hops[i], rows[k], outs[k], mesh, win,
                    i, tables, timeout_s, mesh.stream(i))
            launches["dma_permute"] += 1
        mesh.exit()
    return mesh.unrows(outs)


def _dma_transport_ship_call(rows, mesh, tables, compute: Callable,
                             timeout_s: float = SPIN_TIMEOUT_S):
    """The fused ship on the card: every rank this process drives starts
    the push of its row of ``rows`` on its side stream, then
    ``compute(k)`` runs on the rank's own stream while the pushes are in
    flight, then, where a peer writes the rank's arrival, the arrival
    kernel runs after the compute on the same stream. → ``(arrived,
    ys)``, lists over ``mesh.local_ranks``, ``ys[k] = compute(k)``.

    On a ``LocalMesh`` every push stores straight into its destination's
    output and the arrival is one warp that waits for the peer's flag.
    On a process mesh a push to another rank goes into that rank's slab
    (:func:`plan_hop`), and the arrival copies each slab segment out as
    soon as it has landed (the permute's segment arrival), so the copy
    waits for the compute, not the push. A dummy arrival's zeros come
    with the push, on the side stream.

    Replaces ``tpu_p2p/parallel/pallas_dma.py::_dma_transport_ship_call``
    (:280; kernel body ``dma_transport_ship_compute`` :289). Every push
    of this process is launched before any of its arrivals, so an
    arrival never holds the card while a push waits to start; on a
    process mesh both grids are capped (``share``) to fit beside each
    other and the compute."""
    caller = [torch.cuda.current_stream(r.device) for r in rows]
    outs = [torch.empty_like(r) for r in rows]
    win = _begin(mesh, rows)
    hops = _plan(mesh, win, tables, outs)
    for k, i in enumerate(mesh.local_ranks):
        own, side = mesh.stream(i), mesh.side_stream(i)
        with torch.cuda.stream(own):
            x = rows[k].contiguous()
        # The push follows what the rank's own stream issued before: the
        # ship's producer, and the previous epoch's arrival that its
        # ready signal vouches for.
        side.wait_stream(own)
        _launch("tp_dma_ship_push", hops[i], x, outs[k], mesh, win, i,
                tables, timeout_s, side)
        launches["dma_ship"] += 1
        if x.is_cuda:
            x.record_stream(side)  # the allocator's reuse waits for it
    ys = []
    for k, i in enumerate(mesh.local_ranks):
        own = mesh.stream(i)
        with torch.cuda.stream(own):
            y = compute(k)
        for t in _tensors(y):
            if t.is_cuda and t.device == rows[k].device:
                t.record_stream(caller[k])
        ys.append(y)
        if hops[i].arrival in ("wait", "copy"):
            _launch("tp_dma_ship_arrive", hops[i], None, outs[k], mesh,
                    win, i, tables, timeout_s, own)
    mesh.exit()
    # The caller joins each push itself, beside its arrival: a push wrote
    # an output (a peer's, or a dummy arrival's zeros), which is the
    # caller's to free.
    for k, i in enumerate(mesh.local_ranks):
        caller[k].wait_stream(mesh.side_stream(i))
    return outs, ys


def _tensors(y):
    if isinstance(y, torch.Tensor):
        return (y,)
    if isinstance(y, (tuple, list)):
        return tuple(t for t in y if isinstance(t, torch.Tensor))
    return ()


# ----------------------------------------------------------- wrapper


def _dma_ppermute(x, mesh, edges, tables, timeout_s):
    """:func:`dma_ppermute` without autograd: the plain version for CPU
    tensors, else the kernel; raises for any other device."""
    rows = mesh.rows(x)
    if mesh.size == 1 and not edges:
        return mesh.unrows([torch.zeros_like(r) for r in rows])
    if _device_type(rows) == "cpu":
        return _dma_ppermute_plain(x, mesh, edges, tables)
    return _dma_transport_permute_call(x, mesh, tables, timeout_s=timeout_s)


def _permute_rows(rows, mesh, edges, tables, timeout_s) -> list:
    return mesh.rows(_dma_ppermute(mesh.unrows(rows), mesh, edges, tables,
                                   timeout_s))


def _reverse_rows(ctx, grads) -> tuple:
    """The backward of a hop: the same transport over the reversed
    edges (a permutation's transpose), zeros for an absent cotangent,
    labelled as the forward site's transpose while a ledger records
    (:func:`tpu_p2p_torch.obs.ledger.backward_issue`)."""
    rev = tuple((d, s) for s, d in ctx.edges)
    tables = complete_permutation(rev, ctx.mesh.size)
    g = [gi if gi is not None else torch.zeros(shape, dtype=dt, device=dev)
         for gi, (shape, dt, dev) in zip(grads, ctx.meta)]
    with _obs.backward_issue(ctx.site):
        return tuple(_permute_rows(g, ctx.mesh, rev, tables,
                                   ctx.timeout_s))


def _save(ctx, mesh, edges, timeout_s, rows) -> None:
    ctx.mesh, ctx.edges, ctx.timeout_s = mesh, edges, timeout_s
    ctx.meta = [(r.shape, r.dtype, r.device) for r in rows]
    ctx.site = _obs.current_site()


class _DmaPPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, edges, tables, timeout_s, *rows):
        _save(ctx, mesh, edges, timeout_s, rows)
        return tuple(_permute_rows(list(rows), mesh, edges, tables,
                                   timeout_s))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None, None, *_reverse_rows(ctx, grads))


class _ShipArrival(torch.autograd.Function):
    """The arrival half of :func:`dma_ship_compute` as an autograd node:
    its input is the ship (so the gradient reaches it), its forward
    hands back the arrivals the kernel already produced (or makes them
    with the plain version), its backward is the reverse hop."""

    @staticmethod
    def forward(ctx, mesh, edges, tables, timeout_s, arrived, *rows):
        _save(ctx, mesh, edges, timeout_s, rows)
        if arrived is None:
            arrived = _permute_rows(list(rows), mesh, edges, tables,
                                    timeout_s)
        return tuple(arrived)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None, None, None, *_reverse_rows(ctx, grads))


def dma_ppermute(x, mesh, edges: Sequence[Edge], *, tables=None,
                 timeout_s: float = SPIN_TIMEOUT_S):
    """``ppermute(x, edges)`` over the peer-push kernel: each rank's
    arrival over ``edges`` of ``mesh`` (mesh indices), zeros where no
    real edge arrives. ``x`` is this rank's tensor on a process mesh
    (every member calls with the same edges and a tensor of the same
    shape and dtype), or the list of every rank's on a ``LocalMesh``;
    the result has the same form. ``tables``, when given, are
    ``complete_permutation(edges, mesh.size)`` made once by the caller (a
    cached hop); else they are made, and the edges validated, here
    before any traffic."""
    edges = tuple((int(s), int(d)) for s, d in edges)
    if tables is None:
        tables = complete_permutation(edges, mesh.size)
    rows = mesh.rows(x)
    check_rows(rows)
    _device_type(rows)
    return mesh.unrows(_DmaPPermute.apply(mesh, edges, tables, timeout_s,
                                          *rows))


def dma_ship_compute(ship, mesh, edges: Sequence[Edge],
                     compute_fn: Callable, *operands, tables=None,
                     timeout_s: float = SPIN_TIMEOUT_S):
    """Start the push of ``ship`` over ``edges``, run
    ``compute_fn(*operands)`` while it is in flight, and return
    ``(arrived, y)``: ``arrived`` is :func:`dma_ppermute`'s result for
    ``ship``, ``y`` the compute's.

    On a ``LocalMesh``, ``ship`` and every operand are per-rank lists,
    ``compute_fn`` runs once per rank on that rank's operands and
    stream, and both results are per-rank lists; on a process mesh they
    are this rank's. Differentiable: the ship's cotangent is the
    reverse-edge :func:`dma_ppermute`, the compute's is its own autograd
    graph (the reference's custom_vjp, :345-356). For CUDA tensors the
    push and the compute overlap on the card (the kernel path); for CPU
    tensors the plain version runs the compute, then the copies."""
    edges = tuple((int(s), int(d)) for s, d in edges)
    if tables is None:
        tables = complete_permutation(edges, mesh.size)
    rows = mesh.rows(ship, "ship")
    check_rows(rows)
    ops = [mesh.rows(op, "operand") for op in operands]
    ranks = mesh.local_ranks

    def compute(k):
        return compute_fn(*(op[k] for op in ops))

    arrived = None
    if _device_type(rows) == "cuda" and not (mesh.size == 1 and not edges):
        arrived, ys = _dma_transport_ship_call(
            [r.detach() for r in rows], mesh, tables, compute, timeout_s)
    else:
        ys = []
        for k, i in enumerate(ranks):
            with mesh.on(i):
                ys.append(compute(k))
    out = _ShipArrival.apply(mesh, edges, tables, timeout_s, arrived, *rows)
    return mesh.unrows(out), mesh.unrows(ys)
