"""Edge-set transfers over a mesh — the port's copy of the benchmark half
of ``tpu_p2p/parallel/collectives.py``.

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
- the chunk wave :func:`chunked_ppermute_compute` (reference :627): a
  computed buffer shipped as ``chunks`` hops, each chunk's ship in flight
  while the next chunk computes, over either transport.
- On a :class:`~tpu_p2p_torch.parallel.runtime.LocalMesh` (every rank in
  this process) the same functions take and return one tensor per rank;
  the ``xla`` transport there is a ``Tensor.copy_`` into the destination
  rank's buffer, on the destination's stream.
- ``cudaMalloc`` + ``cudaMemset`` buffers (``p2p_matrix.cc:124-130``) →
  :func:`make_payload`, each rank's row of a rank-tagged payload whose
  bytes equal the reference's ``_payload_np`` bit for bit, so transfers
  are verifiable against :func:`expected_permute`.

Each function works on the calling rank's own row ``[1, elems]`` (a
``shard_map`` block in the reference); the host-side oracles
(:func:`host_payload`, :func:`expected_permute`) hold the whole mesh.
:class:`CollectiveCache` keeps what the reference caches — canonical
edge sets and one callable per (mesh, edges, chain length, transport),
with a ``pallas_dma`` hop's completed permutation made once; there is
nothing to compile. The reference's ledger hooks and fault
throttle are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpu_p2p_torch.config import TRANSPORTS
from tpu_p2p_torch.parallel import pallas_dma as PD
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
    """The whole mesh's payload ``[n, elems]`` on the host: the oracle
    every rank can rebuild without a gather."""
    return _payload_np((mesh.size,), elems_for(msg_bytes, dtype), dtype)


def make_payload(mesh, msg_bytes: int, dtype=np.int8) -> torch.Tensor:
    """This rank's send buffer ``[1, elems]`` on the mesh's device."""
    row = _payload_row(mesh.index, elems_for(msg_bytes, dtype), dtype)
    return torch.from_numpy(row).to(mesh.device)


def verify_against(got: torch.Tensor, want: np.ndarray, mesh) -> bool:
    """This rank's row of a transfer against the host oracle's."""
    return bool(np.array_equal(got.cpu().numpy(),
                               want[mesh.index:mesh.index + 1]))


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


def _library_group(mesh, device: torch.device):
    """The group the library collective runs over on ``device``."""
    if device.type == "cpu":
        return mesh.host_group
    if mesh.device_group is None:
        raise BackendError(
            "transport 'xla' is NCCL send/recv, which needs one card per "
            f"rank; the ranks of this mesh share {mesh.device} — use "
            "--transport pallas_dma")
    return mesh.device_group


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


def ppermute(x: torch.Tensor, mesh, edges: Sequence[Edge]) -> torch.Tensor:
    """This rank's arrival of one edge-set transfer over the library
    collective: row ``dst`` gets row ``src`` per edge, zeros where no
    edge arrives. Members without an edge send nothing. On a
    ``LocalMesh``, ``x`` and the result are per-rank lists."""
    if mesh.in_process:
        return _local_ppermute(x, mesh, edges)
    i = mesh.index
    x = x.contiguous()
    out = torch.zeros_like(x)
    group = _library_group(mesh, x.device)
    ops = []
    for s, d in edges:
        if s == i and d == i:
            out.copy_(x)
        elif s == i:
            ops.append(dist.P2POp(dist.isend, x, mesh.ranks[d], group))
        elif d == i:
            ops.append(dist.P2POp(dist.irecv, out, mesh.ranks[s], group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def dma_ppermute(x: torch.Tensor, mesh, edges: Sequence[Edge]):
    """:func:`ppermute` over the peer-push kernel (``pallas_dma``): the
    same contract, every member of the mesh taking part."""
    return PD.dma_ppermute(x, mesh, edges)


def chunked_ppermute_compute(compute_chunk: Callable, x, mesh,
                             edges: Sequence[Edge], chunk_dim: int,
                             chunks: int, *, transport: str = "xla"):
    """Ship ``compute_chunk(x)`` over ``edges`` as a wave of chunk hops
    (reference ``collectives.py:627``): ``x`` splits along ``chunk_dim``
    into ``chunks`` equal chunks, zero-padded when the dim does not
    divide (padded rows ride the wave and are sliced off after
    reassembly, so the compute must be zero-inert there);
    ``compute_chunk(x_c, c)`` must keep ``chunk_dim``'s extent and one
    shape across chunks. The result is exactly ``ppermute(concat_c(
    compute_chunk(x_c, c)), edges)``: the same bytes, no extra hops.

    ``transport="xla"`` ships each chunk with :func:`ppermute` the moment
    its compute is issued. ``"pallas_dma"`` makes ``chunks - 1`` calls
    to :func:`pallas_dma.dma_ship_compute` (chunk ``c``'s push in flight
    while chunk ``c + 1`` computes) and ships the last chunk with
    :func:`dma_ppermute`. ``chunks <= 1`` degrades to one ship of
    ``compute_chunk(x, 0)``. ``x`` and the result are this rank's tensor
    on a process mesh and per-rank lists on a ``LocalMesh``, where each
    rank's compute runs on the rank's own stream.
    """
    _check_transport(transport)
    edges = _canon_edges(edges, mesh.size)
    rows = mesh.rows(x)
    pallas = transport == "pallas_dma"
    hop = PD.dma_ppermute if pallas else ppermute

    def ship(per_rank):
        return mesh.rows(hop(mesh.unrows(per_rank), mesh, edges))

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
        return mesh.unrows(ship(computed(rows, 0)))
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
        for c in range(1, chunks):
            arr, y = PD.dma_ship_compute(
                mesh.unrows(y_prev), mesh, edges,
                lambda xc, cc=c: compute_chunk(xc, cc),
                mesh.unrows(chunk_of(c)))
            arrivals.append(mesh.rows(arr))
            y_prev = mesh.rows(y)
        arrivals.append(ship(y_prev))
    else:
        for c in range(chunks):
            arrivals.append(ship(computed(chunk_of(c), c)))
    out = []
    for k in range(len(rows)):
        o = torch.cat([a[k] for a in arrivals], dim=chunk_dim)
        out.append(o.narrow(chunk_dim, 0, size) if pad else o)
    return mesh.unrows(out)


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
        fn = self._cache[key] = builder()
        return fn

    def stats(self) -> Dict[str, int]:
        return {"size": len(self._cache), "hits": self._hits,
                "misses": self._misses}

    @staticmethod
    def _canon(mesh, axis: str, edges: Sequence[Edge], transport: str):
        _check_transport(transport)
        if axis not in mesh.axis_names:
            raise ValueError(f"axis {axis!r} not in {mesh.axis_names}")
        return _canon_edges(edges, mesh.size)

    @staticmethod
    def _hop(mesh, edges: Tuple[Edge, ...], transport: str):
        if transport == "pallas_dma":
            tables = PD.complete_permutation(edges, mesh.size)
            return lambda x: PD.dma_ppermute(x, mesh, edges, tables=tables)
        _library_group(mesh, mesh.device)  # fail before any traffic
        return lambda x: ppermute(x, mesh, edges)

    def permute(self, mesh, axis: str, edges: Sequence[Edge],
                transport: str = "xla"):
        """One transfer of ``edges`` along ``axis``: ``[(src, dst)]`` ≙
        the blocking send/recv pair of ``p2p_matrix.cc:156-171``,
        ``[(src, dst), (dst, src)]`` ≙ its full-duplex exchange
        (``:211-251``)."""
        edges = self._canon(mesh, axis, edges, transport)
        return self._get(("permute", mesh, axis, edges, transport),
                         lambda: self._hop(mesh, edges, transport))

    def permute_chain(self, mesh, axis: str, edges: Sequence[Edge],
                      count: int, transport: str = "xla"):
        """``count`` back-to-back transfers, each hop's input the
        previous hop's output, launched without a drain in between — the
        unit of the fused and differential timing modes."""
        edges = self._canon(mesh, axis, edges, transport)

        def build():
            hop = self._hop(mesh, edges, transport)

            def chain(x):
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

    def __len__(self) -> int:
        return len(self._cache)


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
