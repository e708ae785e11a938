"""Collectives over a mesh — the port's copy of the benchmark half of
``tpu_p2p/parallel/collectives.py``.

- ``ncclSend``/``ncclRecv`` of ``ncclInt8`` (``p2p_matrix.cc:156-171``)
  → :func:`ppermute`: an ordered-edge list applied with
  ``batch_isend_irecv``, over the mesh's device group (NCCL) for CUDA
  tensors and its host group (gloo) for CPU tensors. A uni-directional
  pair transfer is the single edge ``[(src, dst)]``, the full-duplex
  exchange (``p2p_matrix.cc:211-251``) both directed edges. A self-edge
  is a local copy (gloo and NCCL refuse a send to oneself); rows with no
  arrival are zeros, as XLA's CollectivePermute leaves them. This is the
  ``xla`` transport: the library collective.
- ``pallas_dma`` → :func:`dma_ppermute`, the hand-written peer-push
  kernel (:mod:`tpu_p2p_torch.parallel.pallas_dma`).
- The reductions and the all-to-all (the reference's ``psum`` :748,
  ``all_to_all`` :846 and the :class:`CollectiveCache` builders
  :1080-1290) → NCCL's ``all_reduce``, ``reduce_scatter_tensor``,
  ``all_gather_into_tensor`` and ``all_to_all_single`` over the device
  group, gloo's over the host group on the CPU. They are library calls
  on every transport, as the reference's are XLA collectives. On ranks
  that share a card there is no device group, and they raise
  :class:`BackendError` before any traffic: NCCL needs a card a rank,
  and gloo never runs on card tensors.
- Along an axis of a 2-D mesh every collective runs on this rank's
  line (``mesh.line(axis)``): an axis edge set is the same edges in
  every line of the other axis, as a ``ppermute`` over one axis of a
  2-D ``shard_map`` is (:func:`expected_permute` with ``axis=``).
- The flagship step's collectives along one axis of its mesh, as
  autograd functions whose backward is the reference's transpose:
  :func:`psum_join` (all-reduce forward, identity backward),
  :func:`psum_conjugate` (its conjugate), :func:`axis_ppermute` and the
  tiled :func:`axis_all_to_all`; :func:`all_reduce_flat` sums a step's
  gradients over the data axes in one collective a dtype;
  :func:`bucketed_all_gather` (and :func:`start_bucketed_all_gather`,
  the same issued without waiting) gathers ZeRO shards in one
  collective a dtype bucket, its backward the summing reduce-scatter.
- the chunk wave :func:`chunked_ppermute_compute` (reference :627): a
  computed buffer shipped as ``chunks`` hops, each chunk's ship in flight
  while the next chunk computes, over either transport;
- the ring collective-matmuls of the overlap knobs along one line
  (reference :344-600): :func:`ring_allgather_matmul` (over either
  transport), :func:`matmul_ring_reducescatter`,
  :func:`ring_all_to_all_matmul` and :func:`matmul_ring_all_to_all`,
  each hop issued (:func:`axis_ppermute_start`) before the chunk in hand
  is computed, and their :class:`CollectiveCache` twins
  ``tp_ring_chain``, ``ep_ring_chain`` and ``pp_wave_chain``.
- On a :class:`~tpu_p2p_torch.parallel.runtime.LocalMesh` (every rank in
  this process) the permutes take and return one tensor per rank; the
  ``xla`` transport there is a ``Tensor.copy_`` into the destination
  rank's buffer, on the destination's stream. Along one line of a
  multi-axis ``LocalMesh`` (a
  :class:`~tpu_p2p_torch.parallel.runtime.LocalLine`, inside
  ``LocalMesh.run``) :func:`psum`, :func:`psum_join`,
  :func:`axis_all_to_all`, :func:`axis_all_gather` and the bucketed
  ZeRO gather run as rendezvous of the line's rank threads, the sum in
  line order; the ring collective-matmuls and the reductions over a
  whole ``LocalMesh`` run on process meshes only.
- ``cudaMalloc`` + ``cudaMemset`` buffers (``p2p_matrix.cc:124-130``) →
  :func:`make_payload`, each rank's row of a rank-tagged payload whose
  bytes equal the reference's ``_payload_np`` bit for bit, so transfers
  are verifiable against the host oracles (:func:`expected_permute`,
  :func:`expected_all_reduce` and the rest).

Each function works on the calling rank's own row ``[1, elems]`` (a
``shard_map`` block in the reference); the host-side oracles
(:func:`host_payload`, the ``expected_*`` functions) hold the whole
mesh. :class:`CollectiveCache` keeps what the reference caches —
canonical edge sets and one callable per (mesh, axis, edges, chain
length, transport), with a ``pallas_dma`` hop's completed permutation
made once; there is nothing to compile. A chain is ``k`` data-dependent
calls launched back to back and drained once, and each cached callable
is a ledger program (:func:`tpu_p2p_torch.obs.ledger.program`).

Every collective records itself into the active collective ledger
(:mod:`tpu_p2p_torch.obs.ledger`) where the reference records it
(``_record_issue``): kind, axis, payload bytes, edges, count, label.
A chain records once with its count, as the reference's traced scan.
The model-layer permutes (:func:`axis_ppermute_start`, the chunk wave)
are the fault-injection point of a degraded link
(:func:`_fault_throttle`, reference :761). Ranks that share a card have
no NCCL; inside :func:`host_staged` their library collectives run on
the host group over host copies (the obs layer's runs there), and
outside it they raise :class:`BackendError` as before.
"""

from __future__ import annotations

import contextlib
import math
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpu_p2p_torch.config import TRANSPORTS
from tpu_p2p_torch.obs import ledger as _obs
from tpu_p2p_torch.parallel import pallas_dma as PD
from tpu_p2p_torch.parallel.runtime import LocalLine
from tpu_p2p_torch.utils.errors import BackendError

Edge = Tuple[int, int]

# Multiplicative rank tag; coprime with 256 so per-rank patterns are
# distinct in int8.
_TAG_STRIDE = 131


def _check_transport(transport: str) -> str:
    if transport not in TRANSPORTS:
        raise ValueError(
            f"unknown transport {transport!r}; expected one of "
            f"{TRANSPORTS}"
        )
    return transport


# ------------------------------------------- ledger hooks, host staging

_HOST_STAGED = [False]


@contextmanager
def host_staged(on: bool = True):
    """Inside the block, the library collectives of ranks that share a
    card (a mesh with no device group) run on the host group (gloo)
    over host copies of the card tensors, instead of raising
    :class:`BackendError`: the obs layer's captures and smoke run there.
    Those collectives leave no device event. ``on=False``: a no-op."""
    prev = _HOST_STAGED[0]
    _HOST_STAGED[0] = prev or bool(on)
    try:
        yield
    finally:
        _HOST_STAGED[0] = prev


def _on_host(t: torch.Tensor, group) -> bool:
    """Whether a collective over ``group`` must see host copies of the
    card tensor ``t`` (gloo never runs on card tensors)."""
    return t.is_cuda and group is not None \
        and dist.get_backend(group) == "gloo"


def _dist(fn, out: torch.Tensor, *ins: torch.Tensor, group, **kw):
    """``fn(out, *ins, group=group)``, through host copies where
    :func:`_on_host` (synchronously: no work handle is returned then)."""
    if not _on_host(out, group):
        return fn(out, *ins, group=group, **kw)
    kw.pop("async_op", None)
    h_out = out.cpu()
    fn(h_out, *(t.cpu() for t in ins), group=group, **kw)
    out.copy_(h_out)
    return None


def _axis_of(mesh) -> str:
    """The axis name a collective over ``mesh`` records under: a line's
    or a plane's own name (``"pp"``, ``"dp+sp"``), a LocalMesh line's
    axis."""
    if isinstance(mesh, LocalLine):
        return mesh.rendezvous.name
    return "+".join(mesh.axis_names)


def _record(kind: str, mesh, x_or_bytes, *, label: str, edges=None,
            count: int = 1, axis=None, axis_size=None):
    """One ledger entry for a collective over ``mesh`` (a line, a plane,
    or a LocalMesh line) → a context manager to issue the collective's
    launches in, so a profiled window labels them with the entry
    (:func:`tpu_p2p_torch.obs.ledger.issue`)."""
    if not _obs._STACK:
        return contextlib.nullcontext()
    nbytes = (x_or_bytes if isinstance(x_or_bytes, int)
              else _obs.tensor_bytes(x_or_bytes))
    return _obs.issue(kind, axis or _axis_of(mesh), nbytes=nbytes,
                      axis_size=axis_size or mesh.size, edges=edges,
                      count=count, label=label)


def elems_for(msg_bytes: int, dtype) -> int:
    """Element count for a payload of ``msg_bytes`` bytes."""
    itemsize = np.dtype(dtype).itemsize
    if msg_bytes % itemsize:
        raise ValueError(
            f"msg size {msg_bytes}B not divisible by {dtype} itemsize")
    return max(1, msg_bytes // itemsize)


def _payload_np(mesh_shape: Tuple[int, ...], elems: int,
                dtype) -> np.ndarray:
    """Rank-tagged host payload: device ``r``'s row is
    ``(r * 131 + iota) mod 256`` reinterpreted in ``dtype``."""
    n = int(np.prod(mesh_shape))
    nbytes = elems * np.dtype(dtype).itemsize
    rows = np.empty((n, nbytes), dtype=np.uint8)
    iota = np.arange(nbytes, dtype=np.uint64)
    for r in range(n):
        rows[r] = ((r * _TAG_STRIDE + iota) % 256).astype(np.uint8)
    return rows.view(dtype).reshape(mesh_shape + (elems,))


def _payload_row(r: int, elems: int, dtype) -> np.ndarray:
    """Row ``r`` of :func:`_payload_np` alone, ``[1, elems]``: the
    pattern has period 256, so one period tiled."""
    nbytes = elems * np.dtype(dtype).itemsize
    period = ((r * _TAG_STRIDE + np.arange(256)) % 256).astype(np.uint8)
    return np.resize(period, nbytes).view(dtype).reshape(1, elems)


def host_payload(mesh, msg_bytes: int, dtype=np.int8) -> np.ndarray:
    """The whole mesh's payload ``[*dims, elems]`` on the host (``[n,
    elems]`` on a 1-D mesh): the oracle every rank can rebuild without a
    gather."""
    dims = tuple(getattr(mesh, "dims", ()) or (mesh.size,))
    return _payload_np(dims, elems_for(msg_bytes, dtype), dtype)


def make_payload(mesh, msg_bytes: int, dtype=np.int8) -> torch.Tensor:
    """This rank's send buffer ``[1, elems]`` on the mesh's device."""
    row = _payload_row(mesh.index, elems_for(msg_bytes, dtype), dtype)
    return torch.from_numpy(row).to(mesh.device)


def verify_against(got: torch.Tensor, want: np.ndarray, mesh) -> bool:
    """This rank's row of a collective against the host oracle's (rows
    in mesh order, whatever the oracle's leading dims)."""
    rows = want.reshape(mesh.size, -1)
    return bool(np.array_equal(got.cpu().numpy(),
                               rows[mesh.index:mesh.index + 1]))


def expected_permute(x: np.ndarray, edges: Sequence[Edge],
                     axis: int = 0) -> np.ndarray:
    """Reference semantics of one ``ppermute`` on the host: row ``dst``
    receives row ``src`` for each edge, every other row is zeros."""
    out = np.zeros_like(x)
    idx = [slice(None)] * x.ndim
    for src, dst in edges:
        dst_idx, src_idx = list(idx), list(idx)
        dst_idx[axis], src_idx[axis] = dst, src
        out[tuple(dst_idx)] = x[tuple(src_idx)]
    return out


def _canon_edges(edges: Sequence[Edge], axis_size: int) -> Tuple[Edge, ...]:
    canon = tuple((int(s), int(d)) for s, d in edges)
    dsts = [d for _, d in canon]
    if len(set(dsts)) != len(dsts):
        raise ValueError(f"duplicate destination in edge set {canon}")
    srcs = [s for s, _ in canon]
    if len(set(srcs)) != len(srcs):
        raise ValueError(f"duplicate source in edge set {canon}")
    for s, d in canon:
        if not (0 <= s < axis_size and 0 <= d < axis_size):
            raise ValueError(
                f"edge ({s}, {d}) out of range for axis of size "
                f"{axis_size}")
    return canon


def _library_group(mesh, device: torch.device, what: str = ""):
    """The group the library collective runs over on ``device``: the
    host group (gloo) on the CPU, the device group (NCCL) on a card;
    raises when the card has none (its ranks share it). ``what`` names a
    collective that no other transport runs (a reduction); without it
    the error points at the peer-push transport."""
    if device.type == "cpu":
        return mesh.host_group
    if mesh.device_group is None and _HOST_STAGED[0]:
        return mesh.host_group
    if mesh.device_group is None:
        if what:
            raise BackendError(
                f"{what} is an NCCL collective, which needs one card per "
                f"rank; the ranks of this mesh share {mesh.device}")
        raise BackendError(
            "transport 'xla' is NCCL send/recv, which needs one card per "
            f"rank; the ranks of this mesh share {mesh.device} — use "
            "--transport pallas_dma")
    return mesh.device_group


def _reduction_group(mesh, what: str):
    """:func:`_library_group` of a process mesh, in any rank order: the
    callers move the chunks of a gather, a scatter and an all-to-all
    between group order and mesh order (:func:`_group_order`)."""
    if mesh.in_process:
        raise ValueError(f"{what} runs on a process mesh, not a LocalMesh")
    return _library_group(mesh, mesh.device, what)


def _group_order(mesh) -> Optional[List[int]]:
    """Where the member at each mesh position sits in its process group's
    rank order: None where the mesh lists its ranks ascending, else
    ``g`` with
    ``g[i]`` the group index of position ``i``. A library gather,
    all-to-all or reduce-scatter orders its parts by group rank; a mesh
    laid over a ring order (:func:`~tpu_p2p_torch.parallel.runtime.
    make_runtime`) takes them by position, so the parts are permuted
    between the two orders (:func:`_to_positions`, :func:`_to_groups`)."""
    ranks = list(getattr(mesh, "ranks", ()) or ())
    if not ranks or ranks == sorted(ranks):
        return None
    srt = sorted(ranks)
    return [srt.index(r) for r in ranks]


def _to_positions(rows: torch.Tensor, order) -> torch.Tensor:
    """``rows`` ``[n, ...]`` in group order → in mesh-position order."""
    if order is None:
        return rows
    return rows[torch.tensor(order, device=rows.device)]


def _to_groups(rows: torch.Tensor, order) -> torch.Tensor:
    """``rows`` ``[n, ...]`` in mesh-position order → in group order."""
    if order is None:
        return rows
    inv = sorted(range(len(order)), key=order.__getitem__)
    return rows[torch.tensor(inv, device=rows.device)].contiguous()


def psum(x: torch.Tensor, mesh, *, group=None, inplace: bool = False):
    """The sum of every member's ``x`` (reference :748): a new tensor
    unless ``inplace``; integers wrap in two's complement, as XLA's and
    numpy's do. ``mesh`` may be a ``LocalMesh`` line (the sum in line
    order)."""
    if hasattr(mesh, "all_reduce"):
        y = mesh.all_reduce(x)
        return x.copy_(y) if inplace else y
    group = group or _reduction_group(mesh, "all_reduce")
    y = x if inplace else x.clone()
    _dist(dist.all_reduce, y, group=group)
    return y


def all_to_all(x: torch.Tensor, mesh, *, group=None) -> torch.Tensor:
    """Tiled all-to-all along the payload dim (reference :846): the last
    dim splits into ``mesh.size`` chunks and chunk ``j`` goes to member
    ``j``, whose result holds the chunks in member order."""
    group = group or _reduction_group(mesh, "all_to_all")
    order = _group_order(mesh)
    n = mesh.size
    x = _to_groups(x.contiguous().view(n, -1), order).view(x.shape)
    out = torch.empty_like(x)
    _dist(dist.all_to_all_single, out.view(-1), x.view(-1), group=group)
    return _to_positions(out.view(n, -1), order).view(out.shape)


def reduce_scatter(x: torch.Tensor, mesh, *, group=None) -> torch.Tensor:
    """Tiled reduce-scatter along the payload dim: member ``j`` keeps
    chunk ``j`` of the sum, ``[..., elems / n]``."""
    group = group or _reduction_group(mesh, "reduce_scatter")
    x = _to_groups(x.contiguous().view(mesh.size, -1),
                   _group_order(mesh)).view(x.shape)
    out = x.new_empty(x.shape[:-1] + (x.shape[-1] // mesh.size,))
    _dist(dist.reduce_scatter_tensor, out.view(-1), x.view(-1),
          group=group)
    return out


def all_gather_own(x: torch.Tensor, mesh, *, group=None) -> torch.Tensor:
    """The reference's slice-own-chunk + tiled all-gather: member ``i``
    contributes chunk ``i`` of its ``x`` (``[..., i*c:(i+1)*c]``,
    contiguous), and every member gets the chunks in member order."""
    group = group or _reduction_group(mesh, "all_gather")
    c = x.shape[-1] // mesh.size
    own = x[..., mesh.index * c:(mesh.index + 1) * c].contiguous()
    out = x.new_empty(x.shape[:-1] + (c * mesh.size,))
    _dist(dist.all_gather_into_tensor, out.view(-1), own.view(-1),
          group=group)
    return _to_positions(out.view(mesh.size, -1),
                         _group_order(mesh)).view(out.shape)


def _local_ppermute(xs, mesh, edges: Sequence[Edge]) -> list:
    """:func:`ppermute` on a ``LocalMesh``: for each edge a copy of the
    source rank's tensor into the destination rank's buffer, issued on
    the destination's stream after the source's work; zeros elsewhere.
    Differentiable (the copy's own backward)."""
    rows = mesh.rows(xs)
    PD.check_rows(rows)
    outs = [torch.zeros_like(r) for r in rows]
    cuda = mesh.streams[0] is not None
    mesh.enter()
    for s, d in _canon_edges(edges, mesh.size):
        with mesh.on(d):
            if cuda:
                mesh.streams[d].wait_stream(mesh.streams[s])
                rows[s].record_stream(mesh.streams[d])
            outs[d].copy_(rows[s])
    mesh.exit()
    return outs


def ppermute(x: torch.Tensor, mesh, edges: Sequence[Edge], *,
             what: str = "") -> torch.Tensor:
    """This rank's arrival of one edge-set transfer over the library
    collective: row ``dst`` gets row ``src`` per edge, zeros where no
    edge arrives. Members without an edge send nothing. On a
    ``LocalMesh``, ``x`` and the result are per-rank lists. ``what``
    names the caller in the error on ranks that share a card (as
    :func:`_library_group`)."""
    if mesh.in_process:
        return _local_ppermute(x, mesh, edges)
    out, pending = ppermute_start(x, mesh, edges, what=what)
    return ppermute_wait(out, pending)


def ppermute_start(x: torch.Tensor, mesh, edges: Sequence[Edge], *,
                   what: str = ""):
    """Issue :func:`ppermute` on a process mesh without waiting for it:
    → ``(out, pending)``; ``out`` holds the arrival after
    :func:`ppermute_wait`. Work issued in between on the card's stream
    runs while the transfer is in flight (NCCL's own stream); ``x`` must
    stay unchanged until then."""
    i = mesh.index
    x = x.contiguous()
    out = torch.zeros_like(x)
    group = _library_group(mesh, x.device, what)
    staged = _on_host(x, group)
    src, dst = (x.cpu(), torch.zeros_like(x, device="cpu")) if staged \
        else (x, out)
    ops = []
    for s, d in edges:
        if s == i and d == i:
            dst.copy_(src)
        elif s == i:
            ops.append(dist.P2POp(dist.isend, src, mesh.ranks[d], group))
        elif d == i:
            ops.append(dist.P2POp(dist.irecv, dst, mesh.ranks[s], group))
    pending = dist.batch_isend_irecv(ops) if ops else []
    if staged:
        for req in pending:
            req.wait()
        out.copy_(dst)
        pending = []
    return out, pending


def ppermute_wait(out: torch.Tensor, pending) -> torch.Tensor:
    """Wait for a :func:`ppermute_start` (on the card: the current
    stream waits for the transfer) → its arrival."""
    for req in pending:
        req.wait()
    return out


def dma_ppermute(x: torch.Tensor, mesh, edges: Sequence[Edge], *,
                 label: str = "dma_ppermute", kind: str = "dma"):
    """:func:`ppermute` over the peer-push kernel (``pallas_dma``): the
    same contract, every member of the mesh taking part. Ledger-recorded
    (reference :826) as ``kind`` (``"dma"``, or ``"kv_migrate"``)."""
    edges = tuple((int(s), int(d)) for s, d in edges)
    with _record(kind, mesh, mesh.rows(x)[0], edges=edges, label=label):
        return PD.dma_ppermute(x, mesh, edges)


def chunked_ppermute_compute(compute_chunk: Callable, x, mesh,
                             edges: Sequence[Edge], chunk_dim: int,
                             chunks: int, *, transport: str = "xla",
                             label: str = "chunked_ppermute_compute",
                             kind=None):
    """Ship ``compute_chunk(x)`` over ``edges`` as a wave of chunk hops
    (reference ``collectives.py:627``): ``x`` splits along ``chunk_dim``
    into ``chunks`` equal chunks, zero-padded when the dim does not
    divide (padded rows ride the wave and are sliced off after
    reassembly, so the compute must be zero-inert there);
    ``compute_chunk(x_c, c)`` must keep ``chunk_dim``'s extent and one
    shape across chunks. The result is exactly ``ppermute(concat_c(
    compute_chunk(x_c, c)), edges)``: the same bytes, no extra hops.

    ``transport="xla"`` ships each chunk the moment its compute is
    issued: on a process mesh (one line of a mesh) with
    :func:`axis_ppermute_start`, every chunk's hop in flight before the
    first wait, on a ``LocalMesh`` with :func:`ppermute`. ``"pallas_dma"``
    makes ``chunks - 1`` calls to :func:`pallas_dma.dma_ship_compute`
    (chunk ``c``'s push in flight while chunk ``c + 1`` computes) and
    ships the last chunk with :func:`dma_ppermute`. ``chunks <= 1``
    degrades to one ship of ``compute_chunk(x, 0)``. ``x`` and the
    result are this rank's tensor on a process mesh and per-rank lists on
    a ``LocalMesh``, where each rank's compute runs on the rank's own
    stream. On a process mesh the wave is differentiable over either
    transport: each hop's backward is the same hop over the reversed
    edges (the reference's transpose), run when autograd reaches it.

    Ledger rows (reference :711): one a chunk hop under ``kind``
    (default the transport's own, ``"ppermute"`` or ``"dma"``; the
    serving migration passes ``"kv_migrate"``), the fused ships as one
    row of ``chunks - 1``; a library chunk hop is the degraded-link
    injection point, as the reference's ``ppermute`` wrapper is.
    """
    _check_transport(transport)
    edges = _canon_edges(edges, mesh.size)
    rows = mesh.rows(x)
    pallas = transport == "pallas_dma"
    rec_kind = kind or ("dma" if pallas else "ppermute")

    def ship(per_rank):
        """Issue one chunk's hop → a callable that returns its arrivals:
        on a process mesh over the library collective, the differentiable
        hop left in flight until the caller waits (every chunk's is
        issued before the first wait); else the finished hop."""
        if not pallas and not mesh.in_process:
            wait = axis_ppermute_start(per_rank[0], mesh, edges,
                                       label=label, kind=rec_kind)
            return lambda: [wait()]
        hop = PD.dma_ppermute if pallas else ppermute
        with _record(rec_kind, mesh, per_rank[0], edges=edges,
                     label=label):
            got = mesh.rows(hop(mesh.unrows(per_rank), mesh, edges))
        return lambda: got

    def computed(parts, c):
        out = []
        for k, i in enumerate(mesh.local_ranks):
            with mesh.on(i):
                out.append(compute_chunk(parts[k], c))
        return out

    size = rows[0].shape[chunk_dim]
    chunks = max(1, min(int(chunks), max(1, size)))
    if chunks <= 1:
        mesh.enter()
        return mesh.unrows(ship(computed(rows, 0))())
    ct = -(-size // chunks)
    pad = ct * chunks - size
    if pad:
        widths = [0, 0] * (rows[0].dim() - chunk_dim - 1) + [0, pad]
        rows = [torch.nn.functional.pad(r, widths) for r in rows]

    def chunk_of(c):
        return [r.narrow(chunk_dim, c * ct, ct) for r in rows]

    mesh.enter()  # the ranks' computes read the padded rows
    arrivals = []
    if pallas:
        y_prev = computed(chunk_of(0), 0)
        with _record(rec_kind, mesh, y_prev[0], edges=edges,
                     count=chunks - 1, label=label):
            for c in range(1, chunks):
                arr, y = PD.dma_ship_compute(
                    mesh.unrows(y_prev), mesh, edges,
                    lambda xc, cc=c: compute_chunk(xc, cc),
                    mesh.unrows(chunk_of(c)))
                arrivals.append(mesh.rows(arr))
                y_prev = mesh.rows(y)
        arrivals.append(ship(y_prev)())
    else:
        waits = [ship(computed(chunk_of(c), c)) for c in range(chunks)]
        arrivals = [wait() for wait in waits]
    out = []
    for k in range(len(rows)):
        o = torch.cat([a[k] for a in arrivals], dim=chunk_dim)
        out.append(o.narrow(chunk_dim, 0, size) if pad else o)
    return mesh.unrows(out)


# ------------------------------------------- differentiable, along an axis
#
# The collectives of the flagship step, on one line of a mesh (a 1-D
# process mesh, ``mesh.line(axis)``), as autograd functions: the
# backward of each is the reference's transpose of the same collective
# under ``shard_map``. On a line of one rank each is the identity and
# launches nothing. They run over the group of the line's device: gloo
# for a CPU mesh, NCCL for a mesh on cards, and on ranks that share a
# card they raise BackendError before any traffic (NCCL needs a card a
# rank).


def axis_group(line, what: str):
    """The library group of ``line`` on its own device (raises
    :class:`BackendError` where its ranks share a card, ValueError on a
    ``LocalMesh`` line, which has no group)."""
    if line.in_process:
        raise ValueError(f"{what} runs on a line of a process mesh, not "
                         "of a LocalMesh")
    return _library_group(line, line.device, what)


def _all_reduce_copy(x: torch.Tensor, line, what: str) -> torch.Tensor:
    if line.in_process:
        return line.all_reduce(x)
    group = axis_group(line, what)
    y = x.contiguous().clone()
    _dist(dist.all_reduce, y, group=group)
    return y


class _PsumJoin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line):
        ctx.line = line
        return _all_reduce_copy(x, line, "psum_join")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PsumConjugate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line):
        ctx.line = line
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_copy(g, ctx.line, "psum_conjugate"), None


def _a2a(x: torch.Tensor, line, split_dim: int, concat_dim: int):
    if line.in_process:
        return line.all_to_all(x, split_dim, concat_dim)
    group = axis_group(line, "all_to_all")
    order = _group_order(line)
    parts = _to_groups(
        torch.stack(x.chunk(line.size, dim=split_dim)).contiguous(), order)
    out = torch.empty_like(parts)
    _dist(dist.all_to_all_single, out, parts, group=group)
    return torch.cat(_to_positions(out, order).unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line, split_dim, concat_dim):
        ctx.args = line, split_dim, concat_dim
        return _a2a(x, line, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        line, split_dim, concat_dim = ctx.args
        return _a2a(g, line, concat_dim, split_dim), None, None, None


def psum_join(x: torch.Tensor, line, *, label: str = "psum"
              ) -> torch.Tensor:
    """The sum of ``x`` over the line, replicated (the reference's
    ``psum`` of a varying value, :748): all-reduce forward, identity
    backward, since the replicated sum's cotangent reaches every member
    once. The Megatron joins after ``wo`` and ``wf2``, the pipeline's
    output replication. ``line=None`` (no such axis): the identity.
    Ledger-recorded as an ``all_reduce`` under ``label``."""
    if line is None or line.size == 1:
        return x
    with _record("all_reduce", line, x, label=label):
        return _PsumJoin.apply(x, line)


def psum_conjugate(x: torch.Tensor, line) -> torch.Tensor:
    """The identity forward, a sum over the line backward: where a value
    replicated over the line enters work that differs by member (a
    column-split product, the pipeline's first stage), each member's
    cotangent is a part of the whole, as the transpose of ``shard_map``'s
    implicit broadcast sums them. ``line=None``: the identity."""
    if line is None or line.size == 1:
        return x
    return _PsumConjugate.apply(x, line)


def axis_ppermute(x: torch.Tensor, line, edges: Sequence[Edge], *,
                  label: str = "ppermute", kind: str = "ppermute"):
    """:func:`ppermute` along the line, differentiable: the backward is
    the same hop over the reversed edges (the reference's transpose).
    :func:`axis_ppermute_start`, waited for at once."""
    return axis_ppermute_start(x, line, edges, label=label, kind=kind)()


def axis_all_to_all(x: torch.Tensor, line, split_dim: int,
                    concat_dim: int, *, label: str = "all_to_all"
                    ) -> torch.Tensor:
    """Tiled all-to-all along the line (reference :846): ``x`` splits
    into ``line.size`` chunks along ``split_dim``, chunk ``j`` goes to
    member ``j``, and the chunks received concatenate along
    ``concat_dim`` in member order. Differentiable: the backward is the
    inverse reshard."""
    if line.size == 1:
        return x
    if x.shape[split_dim] % line.size:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not "
                         f"split into {line.size} chunks")
    with _record("all_to_all", line, x, label=label):
        return _AllToAll.apply(x, line, split_dim, concat_dim)


def axis_all_gather(x: torch.Tensor, line, dim: int) -> torch.Tensor:
    """Tiled all-gather along the line: every member's ``x``
    concatenated along ``dim`` in member order (the inverse of a split
    of ``dim`` over the line). Not differentiable; ``line=None`` or a
    line of one: ``x``."""
    if line is None or line.size == 1:
        return x
    if line.in_process:
        parts = line.all_gather(x.contiguous())
    else:
        group = axis_group(line, "all_gather")
        x = x.contiguous()
        if _on_host(x, group):
            parts = [torch.empty_like(x, device="cpu")
                     for _ in range(line.size)]
            dist.all_gather(parts, x.cpu(), group=group)
            parts = [p.to(x.device) for p in parts]
        else:
            parts = [torch.empty_like(x) for _ in range(line.size)]
            dist.all_gather(parts, x, group=group)
        order = _group_order(line)
        if order is not None:
            parts = [parts[g] for g in order]
    return torch.cat(parts, dim=dim)


class _HopInFlight:
    """One :func:`ppermute` along a line, issued from ``x``'s value (no
    autograd) and not yet waited on; ``x`` and the landing buffer stay
    referenced here until :class:`_HopArrival` has waited."""

    def __init__(self, x: torch.Tensor, line, edges) -> None:
        axis_group(line, "ppermute")  # ranks sharing a card: no traffic
        self.line, self.edges = line, tuple(edges)
        self.x = x.detach().contiguous()
        self.out, self.pending = ppermute_start(self.x, line, self.edges,
                                                what="ppermute")


class _HopArrival(torch.autograd.Function):
    """Wait for a :class:`_HopInFlight` → its arrival. The backward is
    the same hop over the reversed edges (the reference's transpose)."""

    @staticmethod
    def forward(ctx, inflight, x):
        ctx.line, ctx.edges = inflight.line, inflight.edges
        out = ppermute_wait(inflight.out, inflight.pending)
        inflight.x = inflight.out = inflight.pending = None
        return out

    @staticmethod
    def backward(ctx, g):
        back = [(d, s) for s, d in ctx.edges]
        return None, ppermute(g, ctx.line, back, what="ppermute")


def axis_ppermute_start(x: torch.Tensor, line, edges: Sequence[Edge], *,
                        label: str = "ppermute", kind: str = "ppermute"
                        ) -> Callable[[], torch.Tensor]:
    """Issue :func:`axis_ppermute` without waiting → a function that
    waits and returns the arrival. Work issued in between runs while the
    hop is in flight (on a card: NCCL's stream; on the CPU: gloo's
    thread); the arrival is differentiable, its backward the blocking
    reverse hop. ``x`` must stay unchanged until the wait. On a line of
    one rank a self-edge copies ``x`` and no edge gives zeros.

    The reference's instrumented ``ppermute`` (:806): one ledger row as
    ``kind`` under ``label``, and the arrival passes through
    :func:`_fault_throttle`."""
    edges = tuple((int(s), int(d)) for s, d in edges)
    with _record(kind, line, x, edges=edges, label=label):
        wait = _hop_start(x, line, edges)
    if line.size == 1:
        return wait
    return lambda: _fault_throttle(wait(), line, edges)


def _hop_start(x: torch.Tensor, line, edges) -> Callable[[], torch.Tensor]:
    """:func:`axis_ppermute_start`'s hop alone: no ledger row, no
    throttle (the ring collective-matmuls' hops, which the reference
    issues as raw ``lax.ppermute`` and records once a ring)."""
    if line.size == 1:
        y = x.clone() if any(s == d for s, d in edges) else \
            torch.zeros_like(x)
        return lambda: y
    inflight = _HopInFlight(x, line, edges)
    return lambda: _HopArrival.apply(inflight, x)


class _Throttle(torch.autograd.Function):
    """The degraded link's detour on the value path: ``extra`` rounds of
    the swap permutation applied twice (a bitwise identity that crosses
    the link both ways each time); the backward is the identity."""

    @staticmethod
    def forward(ctx, y, line, swap, extra):
        out = y.detach()
        for _ in range(extra):
            out = ppermute(ppermute(out, line, swap, what="ppermute"),
                           line, swap, what="ppermute")
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def _fault_throttle(y: torch.Tensor, line, edges) -> torch.Tensor:
    """Apply an active :class:`~tpu_p2p_torch.obs.faults.FaultPlan` link
    throttle to one arrived ship over ``edges`` (reference :761).

    When the plan degrades an edge ``(s, d)`` of this ship, the arrival
    takes ``degrade_factor - 1`` extra round trips through that link:
    each round applies the swap permutation (``s <-> d``, self-edges
    elsewhere) twice, the bitwise identity, so values stay exact while
    host timing, the card's trace and the ledger (``fault_throttle``
    rows) all see a slower link. Without an active plan: one check."""
    from tpu_p2p_torch.obs import faults as _faults

    plan = _faults.active_plan()
    if plan is None or plan.degrade_edge is None:
        return y
    edge = (int(plan.degrade_edge[0]), int(plan.degrade_edge[1]))
    if edge not in edges:
        return y
    n = line.size
    s, d = edge
    if s >= n or d >= n:
        return y  # a plan written for a bigger mesh: nothing to slow
    swap = tuple((i, i) for i in range(n) if i not in (s, d)) \
        + ((s, d), (d, s))
    extra = plan.degrade_factor - 1
    with _record("ppermute", line, y, edges=((s, d), (d, s)),
                 count=2 * extra, label="fault_throttle"):
        return _Throttle.apply(y, line, swap, extra)


# ------------------------------------ ring collective-matmuls along a line
#
# The reference's decompositions of a collective into shift hops that
# each overlap a chunk's compute (collectives.py :344-600, after Wang et
# al., ASPLOS 2023): each next hop is issued before the current chunk's
# compute (:func:`axis_ppermute_start`), the eager counterpart of the
# reference's reliance on XLA's latency-hiding scheduler. ``line`` is a
# process mesh (this rank's line along one axis of a mesh); a line of
# one rank degrades to ``compute_chunk(x, 0)``. ``compute_chunk(chunk,
# src)`` gets the chunk's ring index ``src`` (or ``dst``) as a Python
# int. The chunk order, the ``src`` indices and the padding error are
# the reference's; the backward of every hop is the blocking reverse hop
# (it does not overlap the backward's compute).


def _shift_edges(n: int, s: int) -> Tuple[Edge, ...]:
    """Shift-by-``s`` permutation edges: one hop of the decomposed
    all-to-all (hop ``s`` carries every rank's chunk for the rank ``s``
    positions downstream)."""
    return tuple((j, (j + s) % n) for j in range(n))


def ring_allgather_matmul(compute_chunk: Callable, x_shard: torch.Tensor,
                          line, gather_dim: int, *,
                          transport: str = "xla") -> torch.Tensor:
    """All-gather ``x_shard`` along the line *through* ``compute_chunk``
    (reference :344): ``n - 1`` shift-by-1 hops, each issued before the
    chunk in hand is consumed, so each arriving chunk's compute runs
    while the next is in flight. → the rank-order concatenation of
    every rank's ``compute_chunk(chunk, src)`` along ``gather_dim``:
    exactly ``compute(all_gather(x_shard))`` for a per-chunk-independent
    compute. ``compute_chunk`` must be shape-uniform across chunks and
    keep ``gather_dim``'s position; ``src`` is the rank the chunk came
    from (hop ``s`` delivers rank ``idx - s``'s).

    ``transport="pallas_dma"`` swaps each hop for the fused ship
    (:func:`pallas_dma.dma_ship_compute`): the chunk's compute runs
    while the peer-push kernel moves the next chunk. Differentiable:
    each hop's transpose is the reverse hop, so a chunk's cotangent
    returns to its owner summed over the ranks that consumed it."""
    _check_transport(transport)
    n = line.size
    if n == 1:
        return compute_chunk(x_shard, 0)
    fwd = ring_edges(n)
    with _record("dma" if transport == "pallas_dma" else "ppermute", line,
                 x_shard, edges=fwd, count=n - 1,
                 label="ring_allgather_matmul"):
        ys = [None] * n
        cur, src = x_shard, line.index
        for s in range(n):
            if transport == "pallas_dma" and s + 1 < n:
                nxt, y = PD.dma_ship_compute(cur, line, fwd,
                                             compute_chunk, cur, src)
            else:
                wait = _hop_start(cur, line, fwd) if s + 1 < n else None
                y = compute_chunk(cur, src)
                nxt = wait() if wait is not None else None
            ys[src] = y
            cur, src = nxt, (src - 1) % n
    return torch.cat(ys, dim=gather_dim)


def matmul_ring_reducescatter(compute_chunk: Callable, x: torch.Tensor,
                              line, chunk_dim: int) -> torch.Tensor:
    """``psum(compute(x))``'s chunk ``idx`` along ``chunk_dim``, with the
    partial products combined hop by hop (reference :431): the
    accumulator starts at the chunk that travels furthest, takes one
    local partial a hop, and each hop of the accumulator is in flight
    while the next partial computes. ``x`` is full along ``chunk_dim``,
    which must divide by the line's size (callers pad);
    ``compute_chunk(chunk, c)`` is chunk ``c``'s partial product against
    this rank's shard. Differentiable (the transpose is the mirrored
    gather ring)."""
    n = line.size
    if n == 1:
        return compute_chunk(x, 0)
    if x.shape[chunk_dim] % n:
        raise ValueError(
            f"chunk dim {chunk_dim} of size {x.shape[chunk_dim]} does not "
            f"divide by ring size {n} — pad before the ring")
    idx, ct = line.index, x.shape[chunk_dim] // n

    def part(c):
        return compute_chunk(x.narrow(chunk_dim, c * ct, ct), c)

    rev = tuple((j, (j - 1) % n) for j in range(n))
    acc = part((idx + 1) % n)
    with _record("ppermute", line, acc, edges=rev, count=n - 1,
                 label="matmul_ring_reducescatter"):
        for s in range(1, n):
            wait = _hop_start(acc, line, rev)
            p = part((idx + 1 + s) % n)
            acc = wait() + p
    return acc


def ring_all_to_all_matmul(compute_chunk: Callable, x: torch.Tensor, line,
                           split_dim: int, concat_dim: int) -> torch.Tensor:
    """The tiled all-to-all of ``x`` along the line *through*
    ``compute_chunk`` (reference :488): ``n - 1`` shift-by-``s`` hops
    (:func:`_shift_edges`), hop ``s + 1`` issued before the arrival of
    hop ``s`` is consumed. ``x`` is full along ``split_dim`` (divisible
    by the line's size), its chunk ``d`` bound for rank ``d``;
    ``compute_chunk(chunk, src)`` consumes the chunk that came from rank
    ``src``, and the outputs concatenate along ``concat_dim`` in source
    order: exactly ``compute(all_to_all(x))`` for a
    per-source-chunk-independent compute (the MoE expert FFN).
    Differentiable: each hop's transpose is the inverse hop."""
    n = line.size
    if n == 1:
        return compute_chunk(x, 0)
    if x.shape[split_dim] % n:
        raise ValueError(
            f"split dim {split_dim} of size {x.shape[split_dim]} does not "
            f"divide by axis size {n}")
    idx, ce = line.index, x.shape[split_dim] // n

    def send_chunk(s):
        return x.narrow(split_dim, (idx + s) % n * ce, ce)

    ys = [None] * n
    cur = send_chunk(0)
    for s in range(n):
        wait = None
        if s + 1 < n:  # one ledger row a hop, in hop order
            with _record("ppermute", line, _obs.tensor_bytes(x) // n,
                         edges=_shift_edges(n, s + 1),
                         label="ring_all_to_all_matmul"):
                wait = _hop_start(send_chunk(s + 1), line,
                                  _shift_edges(n, s + 1))
        src = (idx - s) % n  # hop s delivers the rank s upstream
        ys[src] = compute_chunk(cur, src)
        cur = wait() if wait is not None else None
    return torch.cat(ys, dim=concat_dim)


def matmul_ring_all_to_all(compute_chunk: Callable, x: torch.Tensor, line,
                           split_dim: int, concat_dim: int) -> torch.Tensor:
    """The combine direction of :func:`ring_all_to_all_matmul`
    (reference :569): each per-destination chunk is computed and its hop
    home issued at once (shift ``n - s``), the next chunk computing while
    it flies; → ``all_to_all(compute(x))``, the arrivals concatenated
    along ``concat_dim`` in source order. ``compute_chunk(chunk, dst)``
    computes the chunk bound for rank ``dst``."""
    n = line.size
    if n == 1:
        return compute_chunk(x, 0)
    if x.shape[split_dim] % n:
        raise ValueError(
            f"split dim {split_dim} of size {x.shape[split_dim]} does not "
            f"divide by axis size {n}")
    idx, ct = line.index, x.shape[split_dim] // n

    def part(d):
        return compute_chunk(x.narrow(split_dim, d * ct, ct), d)

    waits = []
    for s in range(1, n):
        y = part((idx - s) % n)
        with _record("ppermute", line, y, edges=_shift_edges(n, n - s),
                     label="matmul_ring_all_to_all"):
            waits.append((_hop_start(y, line, _shift_edges(n, n - s)),
                          (idx + s) % n))
    ys = [None] * n
    ys[idx] = part(idx)
    for wait, src in waits:
        ys[src] = wait()
    return torch.cat(ys, dim=concat_dim)


def all_reduce_flat(tensors: Sequence[torch.Tensor], mesh,
                    what: str) -> None:
    """Sum each tensor over ``mesh`` in place, one all-reduce a dtype
    over the tensors flattened together (the gradient reduction of a
    step: one collective instead of one a leaf). Nothing on a mesh of
    one rank."""
    if mesh.size == 1 or not tensors:
        return
    group = axis_group(mesh, what)
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        _dist(dist.all_reduce, flat, group=group)
        offset = 0
        for t in same:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def _gather_buckets(items, bucket_bytes):
    """Greedy split of ``[(name, shard, dim), ...]`` into buckets of at
    most ``bucket_bytes`` of local-shard payload each (a shard larger
    than the cap gets its own bucket). ``None`` = one bucket."""
    if bucket_bytes is None:
        return [items]
    buckets, cur, cur_bytes = [], [], 0
    for it in items:
        nbytes = it[1].numel() * it[1].element_size()
        if cur and cur_bytes + nbytes > bucket_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(it)
        cur_bytes += nbytes
    if cur:
        buckets.append(cur)
    return buckets


class _BucketInFlight:
    """One bucket's all-gather, issued from the shards' values (no
    autograd) and not yet waited on: the raveled shards concatenated in
    ``flat`` and the landing buffer ``rows`` (``[n * total]``, flat as
    gloo wants it) both stay referenced here until
    :class:`_BucketGather` has waited."""

    def __init__(self, bucket, line, group) -> None:
        self.bucket, self.line, self.group = bucket, line, group
        with torch.no_grad():
            self.flat = torch.cat([v.detach().reshape(-1)
                                   for _, v, _ in bucket])
        if line.in_process:
            # A LocalMesh line: a rendezvous, done when it returns.
            with torch.no_grad():
                self.rows = torch.cat(line.all_gather(self.flat))
            self.work = None
            return
        self.rows = self.flat.new_empty(line.size * self.flat.numel())
        self.work = _dist(dist.all_gather_into_tensor, self.rows,
                          self.flat, group=group, async_op=True)


class _BucketGather(torch.autograd.Function):
    """Wait on a bucket's gather and carve each leaf out of ``rows``:
    ``movedim(0, d)`` of the leading gather axis and a merge reshape is
    the tiled gather's block concatenation, so each leaf is bitwise the
    per-leaf tiled gather. The backward is its transpose: each leaf's
    cotangent laid out as ``[n, size]`` in the same order, one summing
    ``reduce_scatter_tensor`` for the bucket, and this rank's row split
    back into the shards."""

    @staticmethod
    def forward(ctx, inflight, *shards):
        if inflight.work is not None:
            inflight.work.wait()
        n = inflight.line.size
        rows = inflight.rows.view(n, -1)
        if not inflight.line.in_process:
            rows = _to_positions(rows, _group_order(inflight.line))
        ctx.line, ctx.group = inflight.line, inflight.group
        ctx.meta = [(tuple(v.shape), d) for v, (_, _, d)
                    in zip(shards, inflight.bucket)]
        outs, off = [], 0
        for shape, d in ctx.meta:
            size = math.prod(shape)
            seg = rows[:, off:off + size].reshape((n,) + shape)
            outs.append(seg.movedim(0, d).reshape(
                shape[:d] + (n * shape[d],) + shape[d + 1:]))
            off += size
        inflight.flat = inflight.rows = inflight.work = None
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        n = ctx.line.size
        rows = torch.cat([
            g.reshape(shape[:d] + (n, shape[d]) + shape[d + 1:])
            .movedim(d, 0).reshape(n, -1)
            for g, (shape, d) in zip(grads, ctx.meta)], dim=1).contiguous()
        if ctx.line.in_process:
            flat = ctx.line.all_reduce(rows)[ctx.line.index]
        else:
            rows = _to_groups(rows, _group_order(ctx.line))
            flat = rows.new_empty(rows.shape[1])
            _dist(dist.reduce_scatter_tensor, flat, rows.view(-1),
                  group=ctx.group)
        out, off = [], 0
        for shape, _ in ctx.meta:
            size = math.prod(shape)
            out.append(flat[off:off + size].view(shape))
            off += size
        return (None, *out)


class PendingGather:
    """Bucketed all-gathers in flight (:func:`start_bucketed_all_gather`);
    :meth:`wait` lands them and returns ``{name: full tensor}``."""

    def __init__(self, names, ready, inflight) -> None:
        self._names, self._ready, self._inflight = names, ready, inflight

    def wait(self) -> Dict[str, torch.Tensor]:
        out = dict(self._ready)
        for b in self._inflight:
            names = [k for k, _, _ in b.bucket]
            out.update(zip(names, _BucketGather.apply(
                b, *(v for _, v, _ in b.bucket))))
        self._inflight = ()
        return {k: out[k] for k in self._names}


def start_bucketed_all_gather(shards, line, bucket_bytes=None
                              ) -> PendingGather:
    """Issue :func:`bucketed_all_gather`'s collectives without waiting:
    the ZeRO prefetch starts the next stage's gather before this stage's
    compute and waits where it needs the result. On a card the gathers
    run on NCCL's stream and :meth:`PendingGather.wait` orders the
    current stream after them; on the CPU gloo runs them in its own
    thread."""
    # Validate BEFORE the trivial-line return: a mis-built plan must
    # fail on a world of one too.
    for k, (v, d) in shards.items():
        if not 0 <= d < v.ndim:
            raise ValueError(f"{k}: gather dim {d} out of range for "
                             f"rank-{v.ndim} shard")
    if line is None or line.size == 1:
        return PendingGather(list(shards),
                             {k: v for k, (v, _) in shards.items()}, ())
    group = (None if line.in_process
             else axis_group(line, "bucketed_all_gather"))
    by_dtype: Dict[torch.dtype, list] = {}
    for k, (v, d) in shards.items():
        by_dtype.setdefault(v.dtype, []).append((k, v, d))
    buckets = [bucket for items in by_dtype.values()
               for bucket in _gather_buckets(items, bucket_bytes)]
    inflight = []
    for bucket in buckets:  # one ledger row a bucket (reference :329)
        with _record("all_gather", line,
                     sum(_obs.tensor_bytes(v) for _, v, _ in bucket),
                     label="bucketed_all_gather"):
            inflight.append(_BucketInFlight(bucket, line, group))
    return PendingGather(list(shards), {}, inflight)


def bucketed_all_gather(shards, line, bucket_bytes=None
                        ) -> Dict[str, torch.Tensor]:
    """Gather many dp-sharded tensors in one collective a bucket (the
    reference's ``bucketed_all_gather``, :280).

    ``shards``: ``{name: (local_shard, gather_dim)}``, each the local
    block of a tensor split along ``gather_dim`` over ``line``; → each
    name's full tensor, bitwise the per-leaf tiled all-gather, paying
    one ``all_gather_into_tensor`` a bucket instead of one a leaf.
    Shards are grouped by dtype (concatenation needs one element type)
    and split into buckets of at most ``bucket_bytes`` of local-shard
    payload (``None``: one bucket a dtype). Differentiable: the backward
    is one summing ``reduce_scatter_tensor`` a bucket, the reference's
    ``psum_scatter`` transpose. ``line=None`` or a line of one rank:
    the shards themselves."""
    return start_bucketed_all_gather(shards, line, bucket_bytes).wait()


class CollectiveCache:
    """One callable per (mesh, edge set, chain length, transport), with
    the edge set canonicalised and validated once: a plain memo with
    hit/miss counters (its callables cost nothing to rebuild, so nothing
    is evicted)."""

    def __init__(self) -> None:
        self._cache: Dict[tuple, object] = {}
        self._hits = self._misses = 0

    def _get(self, key, builder):
        fn = self._cache.get(key)
        if fn is not None:
            self._hits += 1
            return fn
        self._misses += 1
        fn = self._cache[key] = _obs.program(builder())
        return fn

    def stats(self) -> Dict[str, int]:
        return {"size": len(self._cache), "hits": self._hits,
                "misses": self._misses}

    @staticmethod
    def _canon(mesh, axis: str, edges: Sequence[Edge], transport: str):
        _check_transport(transport)
        if axis not in mesh.axis_names:
            raise ValueError(f"axis {axis!r} not in {mesh.axis_names}")
        return _canon_edges(edges, mesh.shape[axis])

    @staticmethod
    def _hop(mesh, edges: Tuple[Edge, ...], transport: str):
        if transport == "pallas_dma":
            tables = PD.complete_permutation(edges, mesh.size)
            return lambda x: PD.dma_ppermute(x, mesh, edges, tables=tables)
        _library_group(mesh, mesh.device)  # fail before any traffic
        return lambda x: ppermute(x, mesh, edges)

    @staticmethod
    def _kind(transport: str) -> str:
        return "dma" if transport == "pallas_dma" else "ppermute"

    def permute(self, mesh, axis: str, edges: Sequence[Edge],
                transport: str = "xla"):
        """One transfer of ``edges`` along ``axis``: ``[(src, dst)]`` ≙
        the blocking send/recv pair of ``p2p_matrix.cc:156-171``,
        ``[(src, dst), (dst, src)]`` ≙ its full-duplex exchange
        (``:211-251``). Ledger: one row a call (reference :943)."""
        edges = self._canon(mesh, axis, edges, transport)

        def build():
            line = mesh.line(axis)
            hop = self._hop(line, edges, transport)
            label = ("dma_permute" if transport == "pallas_dma"
                     else "permute")

            def one(x):
                with _record(self._kind(transport), line, x, edges=edges,
                             axis=axis, label=label):
                    return hop(x)

            return one

        return self._get(("permute", mesh, axis, edges, transport), build)

    def permute_chain(self, mesh, axis: str, edges: Sequence[Edge],
                      count: int, transport: str = "xla"):
        """``count`` back-to-back transfers, each hop's input the
        previous hop's output, launched without a drain in between — the
        unit of the fused and differential timing modes."""
        edges = self._canon(mesh, axis, edges, transport)

        def build():
            line = mesh.line(axis)
            hop = self._hop(line, edges, transport)
            label = ("dma_permute_chain" if transport == "pallas_dma"
                     else "permute_chain")

            def chain(x):
                # One row of ``count`` (reference :981, :998).
                with _record(self._kind(transport), line, x, edges=edges,
                             count=count, axis=axis, label=label):
                    for _ in range(count):
                        x = hop(x)
                return x

            return chain

        return self._get(("chain", mesh, axis, edges, count, transport),
                         build)

    def dma_permute_chain(self, mesh, axis: str, edges: Sequence[Edge],
                          count: int):
        """:meth:`permute_chain` over the peer-push kernel."""
        return self.permute_chain(mesh, axis, edges, count,
                                  transport="pallas_dma")

    def loopback_chain(self, mesh, count: int):
        """``count`` chained whole-buffer rewrites (``x + 1``) on this
        rank's device: the honest loopback floor of a self-edge, which
        moves no bytes between ranks (read and write the buffer once a
        hop)."""

        def build():
            def chain(x):
                for _ in range(count):
                    x = x + 1
                return x

            return chain

        return self._get(("loopback", mesh, count), build)

    # -- all-to-all and reductions (library collectives) ----------------

    def _collective(self, name: str, mesh, axis: str, count: int, what: str,
                    step, first=None, records=()):
        """A cached callable of ``count`` data-dependent ``step(x, line,
        group)`` calls along ``axis`` (``first`` for the first, when it
        differs); the line's group is found, or refused, when it is
        built. ``records``: ``(kind, bytes_of(x, n))`` pairs, one ledger
        row of ``count`` each (reference :1096-1273)."""
        if axis not in mesh.axis_names:
            raise ValueError(f"axis {axis!r} not in {mesh.axis_names}")

        def build():
            line = mesh.line(axis)
            group = _reduction_group(line, what)
            head = first or step

            def chain(x):
                with contextlib.ExitStack() as issued:
                    for kind, nbytes in records:  # a row a kind
                        issued.enter_context(_record(
                            kind, line, nbytes(x, line.size), count=count,
                            axis=axis, label=name))
                    x = head(x, line, group)
                    for _ in range(count - 1):
                        x = step(x, line, group)
                return x

            return chain

        return self._get((name, mesh, axis, count), build)

    def all_to_all(self, mesh, axis: str):
        """One tiled all-to-all along ``axis`` over the payload dim
        (reference :1080): chunk ``j`` of each member's row goes to
        member ``j``."""
        return self._collective(
            "all_to_all", mesh, axis, 1, "all_to_all",
            lambda x, m, g: all_to_all(x, m, group=g),
            records=(("all_to_all", _whole),))

    def all_reduce(self, mesh, axis: str):
        """One sum of the payload over ``axis`` (reference :1111), into a
        new tensor: the one-hop :meth:`psum_chain`."""
        return self.psum_chain(mesh, axis, 1)

    def psum_chain(self, mesh, axis: str, count: int):
        """``count`` data-dependent sums (reference :1134): one copy of
        the payload, then ``count`` in-place all-reduces of it, so every
        hop after the copy is the collective alone (integers wrap)."""
        return self._collective(
            "psum_chain", mesh, axis, count, "all_reduce",
            lambda x, m, g: psum(x, m, group=g, inplace=True),
            first=lambda x, m, g: psum(x, m, group=g),
            records=(("all_reduce", _whole),))

    def reduce_scatter(self, mesh, axis: str):
        """One tiled reduce-scatter along the payload dim (reference
        :1163): member ``j`` keeps chunk ``j`` of the sum."""
        return self._collective(
            "reduce_scatter", mesh, axis, 1, "reduce_scatter",
            lambda x, m, g: reduce_scatter(x, m, group=g),
            records=(("reduce_scatter", _whole),))

    def rs_ag_chain(self, mesh, axis: str, count: int):
        """``count`` hops of reduce-scatter + tiled all-gather (reference
        :1188): shape-preserving, one ring-decomposed allreduce a hop."""
        def step(x, m, g):
            rs = reduce_scatter(x, m, group=g)
            out = x.new_empty(x.shape)
            _dist(dist.all_gather_into_tensor, out.view(-1), rs.view(-1),
                  group=g)
            return _to_positions(out.view(m.size, -1),
                                 _group_order(m)).view(out.shape)

        return self._collective(
            "rs_ag_chain", mesh, axis, count, "reduce_scatter", step,
            records=(("reduce_scatter", _whole),
                     ("all_gather", _own_chunk)))

    def all_gather(self, mesh, axis: str):
        """One slice-own-chunk + tiled all-gather (reference :1225): the
        payload is the gathered buffer, ``(n-1)/n`` of it moves; the
        one-hop :meth:`ag_chain`."""
        return self.ag_chain(mesh, axis, 1)

    def ag_chain(self, mesh, axis: str, count: int):
        """``count`` data-dependent slice-own-chunk + all-gather hops
        (reference :1259)."""
        return self._collective(
            "ag_chain", mesh, axis, count, "all_gather",
            lambda x, m, g: all_gather_own(x, m, group=g),
            records=(("all_gather", _own_chunk),))

    # -- the overlap knobs' ring collective-matmuls ----------------------

    def _ring(self, name: str, mesh, axis: str, count: int, k: int, hop,
              *extra):
        """A cached callable of ``count`` shape-preserving ``hop(x, line,
        w)`` round trips along ``axis``, ``w`` the ``[k, k]`` identity in
        the payload's dtype (values pass through: the chain times the
        transport and the per-chunk products)."""
        if axis not in mesh.axis_names:
            raise ValueError(f"axis {axis!r} not in {mesh.axis_names}")

        def build():
            line = mesh.line(axis)

            def chain(x):
                w = torch.eye(k, dtype=x.dtype, device=x.device)
                for _ in range(count):
                    x = hop(x, line, w).to(x.dtype).reshape(x.shape)
                return x

            return chain

        return self._get((name, mesh, axis, count, k, *extra), build)

    def tp_ring_chain(self, mesh, axis: str, count: int, k: int = 64):
        """``count`` ring collective-matmul round trips (reference
        :1357): :func:`ring_allgather_matmul` of the payload's token
        chunks through a ``[k, k]`` product, then
        :func:`matmul_ring_reducescatter` back to this rank's chunk; the
        twin of the flagship's ``tp_overlap="ring"`` joins. The payload's
        last dim is viewed as ``[elems // k, k]`` tokens x features."""
        def hop(x, line, w):
            if x.shape[-1] % k:
                raise ValueError(f"payload {x.shape[-1]} elems not "
                                 f"divisible by feature dim {k}")
            full = ring_allgather_matmul(lambda c, _s: c @ w,
                                         x.reshape(-1, k), line, 0)
            return matmul_ring_reducescatter(lambda c, _s: c @ w, full,
                                             line, 0)

        return self._ring("tp_ring_chain", mesh, axis, count, k, hop)

    def ep_ring_chain(self, mesh, axis: str, count: int, k: int = 64):
        """``count`` ring all-to-all-matmul round trips (reference
        :1407): :func:`ring_all_to_all_matmul` (the MoE dispatch through a
        ``[k, k]`` product, one expert row a rank), then
        :func:`matmul_ring_all_to_all` home; the twin of
        ``ep_overlap="ring"``. The payload's last dim is viewed as ``[n,
        elems / (n k), k]`` experts x slots x features."""
        n = mesh.shape[axis] if axis in mesh.axis_names else 1

        def hop(x, line, w):
            if x.shape[-1] % (n * k):
                raise ValueError(f"payload {x.shape[-1]} elems not "
                                 f"divisible by experts x features ({n} "
                                 f"x {k})")
            h = ring_all_to_all_matmul(lambda c, _s: c @ w,
                                       x.reshape(n, -1, k), line, 0, 1)
            return matmul_ring_all_to_all(lambda c, _d: c @ w, h, line, 1,
                                          0)

        return self._ring("ep_ring_chain", mesh, axis, count, k, hop)

    def pp_wave_chain(self, mesh, axis: str, count: int, chunks: int = 4,
                      k: int = 64):
        """``count`` wave stage hops (reference :1459):
        :func:`chunked_ppermute_compute` over the shift-by-1 ring (the
        pipeline hop with its wraparound, so ``axis_size`` hops bring
        every payload home) of the payload's ``[elems // k, k]`` token
        view through a ``[k, k]`` product in ``chunks`` chunks; the twin
        of ``pp_overlap="wave"``."""
        def hop(x, line, w):
            if x.shape[-1] % k:
                raise ValueError(f"payload {x.shape[-1]} elems not "
                                 f"divisible by feature dim {k}")
            return chunked_ppermute_compute(
                lambda c, _i: c @ w, x.reshape(-1, k), line,
                ring_edges(line.size), chunk_dim=0, chunks=chunks)

        return self._ring("pp_wave_chain", mesh, axis, count, k, hop, chunks)

    def __len__(self) -> int:
        return len(self._cache)


def _whole(x: torch.Tensor, n: int) -> int:
    return _obs.tensor_bytes(x)


def _own_chunk(x: torch.Tensor, n: int) -> int:
    """A slice-own-chunk gather's operand: this rank's ``1/n`` of the
    payload dim."""
    return _obs.tensor_bytes(x) // x.shape[-1] * (x.shape[-1] // n)


def _check_divides(elems: int, n: int) -> None:
    if elems % n:
        raise ValueError(f"{elems} payload elements do not split into "
                         f"{n} chunks")


def expected_all_reduce(x: np.ndarray) -> np.ndarray:
    """Host semantics of the payload psum: every row becomes the
    elementwise sum over rows, with native integer wraparound."""
    out = x[0].copy()
    for r in range(1, x.shape[0]):
        out = out + x[r]  # stepwise, preserving the dtype's wraparound
    return np.broadcast_to(out, x.shape).copy()


def expected_reduce_scatter(x: np.ndarray) -> np.ndarray:
    """Host semantics of the tiled reduce-scatter over a flat-mesh
    payload ``[n, elems]``: row ``j`` holds chunk ``j`` of the summed
    payload (elems/n each)."""
    if x.ndim != 2:
        raise ValueError(f"expected a [devices, elems] payload, got "
                         f"{x.shape}")
    n, elems = x.shape
    _check_divides(elems, n)
    return expected_all_reduce(x)[0].reshape(n, elems // n)


def expected_all_gather(x: np.ndarray) -> np.ndarray:
    """Host semantics of the slice-own-chunk + tiled all-gather over a
    flat-mesh payload ``[n, elems]``: every row becomes the diagonal
    concatenation — chunk ``j`` of the result is row ``j``'s own chunk
    ``j``."""
    if x.ndim != 2:
        raise ValueError(f"expected a [devices, elems] payload, got "
                         f"{x.shape}")
    n, elems = x.shape
    _check_divides(elems, n)
    c = elems // n
    diag = np.concatenate([x[j, j * c:(j + 1) * c] for j in range(n)])
    return np.broadcast_to(diag, x.shape).copy()


def expected_all_to_all(x: np.ndarray, axis_size: int) -> np.ndarray:
    """Host semantics of the tiled all-to-all: with rows as devices and
    the payload dim split into ``axis_size`` chunks, output[i] chunk j ==
    input[j] chunk i."""
    n = axis_size
    if x.shape[0] != n:
        raise ValueError(f"expected {n} rows, got {x.shape}")
    _check_divides(x.shape[-1], n)
    chunks = x.reshape(n, n, x.shape[-1] // n)  # [device, chunk, elems/n]
    return np.swapaxes(chunks, 0, 1).reshape(x.shape)


def unidir_edges(src: int, dst: int) -> Tuple[Edge, ...]:
    """p2p_matrix.cc:156-171 — one ordered pair."""
    return ((src, dst),)


def bidir_edges(a: int, b: int) -> Tuple[Edge, ...]:
    """p2p_matrix.cc:211-251 — grouped send+recv, both directions."""
    return ((a, b), (b, a))


def ring_edges(n: int, shift: int = 1) -> Tuple[Edge, ...]:
    """Shift-by-``shift`` ring."""
    return tuple((i, (i + shift) % n) for i in range(n))


def all_pairs(n: int):
    """The reference's pair sweep order (p2p_matrix.cc:141-145):
    row-major over ordered (src, dst), diagonal included."""
    for src in range(n):
        for dst in range(n):
            yield src, dst
