"""The peer-push transport behind ``--transport pallas_dma``.

Port of ``tpu_p2p/parallel/pallas_dma.py`` (same module name, so a
reader finds the counterpart). On the TPU it is a Pallas kernel of raw
remote DMAs; here it is a hand-written CUDA kernel
(``tpu_p2p_torch/csrc/p2p_dma.cu``, built by
:mod:`tpu_p2p_torch.utils.cuda_build`) that stores into peer-mapped CUDA
IPC windows. Three forms side by side, as for every kernel of the port:

- the **kernel** (:func:`_dma_transport_permute_call`), launched for
  CUDA tensors;
- the **plain version** (:func:`_dma_ppermute_plain`), the same function
  over ``torch.distributed`` send/recv on the host group, taken for CPU
  tensors and the kernel's yardstick on the card;
- the **wrapper** :func:`dma_ppermute`: the ``ppermute(x, edges)``
  contract — unique sources and destinations, rows with no real arrival
  become zeros — differentiable, its gradient the same hop over the
  reversed edges (the reference's custom_vjp, :220-242).

Edge sets are completed to a total permutation first
(:func:`complete_permutation`, copied from the reference with equal
tables): every rank pushes exactly one buffer and receives exactly one,
ranks without a real edge over dummy edges whose arrivals are zeroed.
Every rank of the mesh takes part in every call.

Windows: one per set of ranks and capacity (``Mesh.windows``), made
collectively the first time a payload needs it — every member allocates
a slab and flags with ``cudaMalloc``, the 64-byte IPC handles are
all-gathered over the host group, and each member maps the others'.
They live until :func:`close_windows` (``Runtime.close``).
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpu_p2p_torch.utils.errors import BackendError, TransferTimeout

Edge = Tuple[int, int]

# Kernel launches since the last reset — a plain count, so a run can
# show that its main path went through the kernel. Only a launch counts:
# the plain version (CPU) adds nothing.
launches = {"dma_permute": 0}

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


# ------------------------------------------------------------ plain


def _dma_ppermute_plain(x: torch.Tensor, mesh, edges: Sequence[Edge],
                        tables=None):
    """Plain version: the completed permutation over send/recv on the
    mesh's host group (gloo), a local copy for a self-edge, zeros for a
    dummy arrival. Same arguments and result as :func:`dma_ppermute`."""
    if tables is None:
        tables = complete_permutation(edges, mesh.size)
    dst_t, src_t, has_in = tables
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


def _lib():
    """The built kernel library, with its C signatures declared."""
    global _LIB
    if _LIB is None:
        from tpu_p2p_torch.utils.cuda_build import load

        lib = load("p2p_dma")
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong
        for name, args in (
                ("tp_dma_window_alloc", [u, ctypes.POINTER(p), p]),
                ("tp_dma_window_open", [p, ctypes.POINTER(p)]),
                ("tp_dma_window_close", [p]),
                ("tp_dma_window_free", [p]),
                ("tp_dma_fault_alloc", [ctypes.POINTER(p),
                                        ctypes.POINTER(p)]),
                ("tp_dma_permute", [p, p, u, p, p, p, i, i, i, i, i, i, i,
                                    i, u, u, p, p])):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = i
        for name in ("tp_dma_max_ranks", "tp_dma_fault_bytes"):
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


class _Window:
    """One symmetric window: a slab of ``capacity`` bytes and its flags
    on every member of ``mesh``, mapped into every other member."""

    def __init__(self, mesh, capacity: int) -> None:
        lib = _lib()
        members = sorted(mesh.ranks)
        if len(members) > lib.tp_dma_max_ranks():
            raise BackendError(
                f"pallas_dma windows hold at most {lib.tp_dma_max_ranks()}"
                f" ranks, the mesh has {len(members)}")
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

    def close(self) -> None:
        lib = _lib()
        for r, b in self.bases.items():
            if b != self.own:
                lib.tp_dma_window_close(b)
        lib.tp_dma_window_free(self.own)
        self.bases = {}


def _window(mesh, nbytes: int) -> _Window:
    """The smallest window of ``mesh``'s rank set that holds ``nbytes``,
    made (collectively) when none does."""
    fits = [c for c in mesh.windows if c >= nbytes]
    if fits:
        return mesh.windows[min(fits)]
    cap = max(MIN_WINDOW, 1 << max(0, nbytes - 1).bit_length())
    with torch.cuda.device(mesh.device):
        win = _Window(mesh, cap)
    mesh.windows[cap] = win
    return win


def close_windows(windows: dict) -> None:
    """Unmap the peers' windows and free this rank's (after a barrier:
    no kernel may still be pushing)."""
    for win in windows.values():
        win.close()
    windows.clear()


def _dma_transport_permute_call(x: torch.Tensor, mesh, tables, *,
                                timeout_s: float = SPIN_TIMEOUT_S):
    """One total-permutation push on the card: ``x`` into the slab of
    this rank's destination, then this rank's arrival (or zeros) out.
    ``tables`` are :func:`complete_permutation`'s for the hop's edges.

    Replaces ``tpu_p2p/parallel/pallas_dma.py::_dma_transport_permute_call``
    (:146). Launches on the current stream, allocates only the output,
    and raises when the launch is refused; a peer that never comes
    surfaces as :class:`TransferTimeout` from :func:`check_faults`."""
    dst_t, src_t, has_in = tables
    i = mesh.index
    x = x.contiguous()
    out = torch.empty_like(x)
    nbytes = x.numel() * x.element_size()
    if nbytes == 0:
        return out
    win = _window(mesh, nbytes)
    check_faults()
    win.epoch += 1
    me, d, s = mesh.rank, mesh.ranks[dst_t[i]], mesh.ranks[src_t[i]]
    vec16 = x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().tp_dma_permute(
            x.data_ptr(), out.data_ptr(), nbytes, win.bases[me],
            win.bases[d], win.bases[s], win.slot[me], win.slot[d],
            win.slot[s], me, d, s, int(has_in[i]), int(vec16), win.epoch,
            int(timeout_s * 1e9), _fault_record()[1], stream)
    if err:
        raise BackendError(f"dma_permute kernel launch failed: CUDA error "
                           f"{err} ({torch.cuda.get_device_name()})")
    launches["dma_permute"] += 1
    return out


# ----------------------------------------------------------- wrapper


def _dma_ppermute(x, mesh, edges, tables, timeout_s):
    if mesh.size == 1 and not edges:
        return torch.zeros_like(x)
    if x.device.type == "cpu":
        return _dma_ppermute_plain(x, mesh, edges, tables)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return _dma_transport_permute_call(x, mesh, tables, timeout_s=timeout_s)


class _DmaPPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, edges, tables, timeout_s):
        ctx.mesh, ctx.edges, ctx.timeout_s = mesh, edges, timeout_s
        return _dma_ppermute(x, mesh, edges, tables, timeout_s)

    @staticmethod
    def backward(ctx, g):
        # The transpose of a permutation is the reverse-edge permutation.
        rev = tuple((d, s) for s, d in ctx.edges)
        tables = complete_permutation(rev, ctx.mesh.size)
        return (_dma_ppermute(g, ctx.mesh, rev, tables, ctx.timeout_s),
                None, None, None, None)


def dma_ppermute(x: torch.Tensor, mesh, edges: Sequence[Edge], *,
                 tables=None,
                 timeout_s: float = SPIN_TIMEOUT_S) -> torch.Tensor:
    """``ppermute(x, edges)`` over the peer-push kernel: this rank's
    arrival over ``edges`` of ``mesh`` (mesh indices), zeros where no
    real edge arrives. Every member of ``mesh`` must call it with the
    same edges and a tensor of the same shape and dtype. ``tables``, when
    given, are ``complete_permutation(edges, mesh.size)`` made once by the
    caller (a cached hop); else they are made, and the edges validated,
    here before any traffic."""
    edges = tuple((int(s), int(d)) for s, d in edges)
    if tables is None:
        tables = complete_permutation(edges, mesh.size)
    return _DmaPPermute.apply(x, mesh, edges, tables, timeout_s)
