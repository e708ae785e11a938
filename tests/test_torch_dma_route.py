"""The peer-push kernels' launch path on the CPU, against a fake library.

``tpu_p2p_torch/parallel/pallas_dma.py`` decides per hop where each
rank's push lands (:func:`plan_hop`): straight into the receiver's
output wherever this process holds it (every edge of a ``LocalMesh``, a
self-edge on any mesh), into the receiver's IPC-mapped slab on an edge
between processes, and nowhere toward a dummy arrival, whose receiver
zero-fills; the fused ship's arrival waits (a ``LocalMesh``) or copies
the slab out after the compute (a process mesh). A CPU host cannot
launch the kernels, so these tests stand a recording fake in for the
built library (and fake streams and windows for the card's) and let CPU
tensors take the kernel path: what
each launch gets, how many launches a call makes, the epochs, and that
a refused launch raises before any later one. The kernels themselves
are held against their plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import contextlib

import numpy as np
import pytest
import torch

import chip_smoke
from tpu_p2p_torch.parallel import collectives as C
from tpu_p2p_torch.parallel import pallas_dma as PD
from tpu_p2p_torch.parallel.runtime import LocalMesh, Mesh
from tpu_p2p_torch.utils.errors import BackendError

HEADER = 16384          # csrc/p2p_dma.cu: kHeaderBytes
ARGS = ("x", "out", "dest", "nbytes", "self", "to", "from", "me", "dst",
        "src", "rank", "dst_rank", "src_rank", "push", "arrive", "sys",
        "epoch", "timeout_ns", "fault", "share", "stream")
CASES = [(name, n) for n in (2, 4) for name in chip_smoke.EDGE_SETS_8]


def edges_of(name, n):
    """tests/test_pallas_dma.py:101's edge set ``name`` cut to ``n``."""
    return chip_smoke.cut_edges(chip_smoke.EDGE_SETS_8[name], n)


class FakeLib:
    """Stands in for the built ``p2p_dma`` library: each launch entry
    records its name and its arguments by name and returns ``err``;
    windows get distinct fake addresses."""

    def __init__(self, err: int = 0):
        self.calls = []
        self.err = err
        self.next_base = 1 << 40

    def tp_dma_header_bytes(self):
        return HEADER

    def tp_dma_max_ranks(self):
        return 64

    def tp_dma_enable_peer(self, a, b):
        return 0

    def tp_dma_window_alloc(self, capacity, base, handle):
        base._obj.value = self.next_base
        self.next_base += 1 << 32
        return 0

    def tp_dma_window_free(self, base):
        return 0

    def _entry(self, name, *args):
        self.calls.append((name, dict(zip(ARGS, args))))
        return self.err

    def tp_dma_permute(self, *args):
        return self._entry("tp_dma_permute", *args)

    def tp_dma_ship_push(self, *args):
        return self._entry("tp_dma_ship_push", *args)

    def tp_dma_ship_arrive(self, *args):
        return self._entry("tp_dma_ship_arrive", *args)


class FakeStream:
    """A stream that records what it was told to wait for."""

    def __init__(self, sid: int):
        self.cuda_stream = sid
        self.waited = []

    def wait_stream(self, other):
        self.waited.append(other.cuda_stream)

    def synchronize(self):
        pass


CALLER = FakeStream(1)


class FakeWindow:
    """A process mesh's window without the host group's handle exchange:
    rank ``r``'s window at a fake address of its own."""

    def __init__(self, mesh, capacity):
        self.slot = {r: k for k, r in enumerate(sorted(mesh.ranks))}
        self.capacity = capacity
        self.epoch = 0
        self.bases = {r: (7 << 40) + (r << 32) for r in mesh.ranks}
        self.slabs = {r: b + HEADER for r, b in self.bases.items()}
        self.sys_scope = True

    def close(self):
        pass


@pytest.fixture
def fake(monkeypatch):
    """CPU tensors take the kernel path, into a fake library, on fake
    streams and windows."""
    lib = FakeLib()
    monkeypatch.setattr(PD, "_lib", lambda: lib)
    monkeypatch.setattr(PD, "_fault_record", lambda: (0, 0xFA17))
    monkeypatch.setattr(PD, "_device_type", lambda rows: "cuda")
    monkeypatch.setattr(PD, "_Window", FakeWindow)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: CALLER)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "fake card")
    PD.reset_launches()
    CALLER.waited.clear()
    return lib


def local_mesh(n):
    mesh = LocalMesh(["cpu"] * n)
    mesh.streams = tuple(FakeStream(10 + i) for i in range(n))
    mesh.side_streams = tuple(FakeStream(20 + i) for i in range(n))
    return mesh


def process_mesh(n, rank):
    return Mesh(ranks=tuple(range(n)), rank=rank,
                device=torch.device("cpu"), host_group=None)


def moved_bytes(hop, nbytes):
    """Device-memory traffic of one rank's part of a hop of ``nbytes``:
    a push reads ``x`` and writes its copy, a slab arrival copies it out
    again, a dummy arrival writes zeros."""
    push = 0 if hop.push == "none" else 2 * nbytes
    return push + {"none": 0, "wait": 0, "copy": 2 * nbytes,
                   "zero": nbytes}[hop.arrival]


def rows_of(n, nbytes=4096):
    return [torch.full((nbytes,), i + 1, dtype=torch.int8) for i in range(n)]


# ----------------------------------------------------- the pure decision


@pytest.mark.parametrize("name,n", CASES)
def test_plan_sends_each_push_where_the_process_can_store(name, n):
    tables = PD.complete_permutation(edges_of(name, n), n)
    dst_t, src_t, has_in = tables
    outs = {i: 1000 + i for i in range(n)}
    slabs = {i: 2000 + i for i in range(n)}
    local = [PD.plan_hop(True, i, tables, outs, slabs) for i in range(n)]
    for i, hop in enumerate(local):
        d = int(dst_t[i])
        if has_in[d]:
            # A LocalMesh holds every output: the receiver's, never a slab.
            assert (hop.push, hop.dest) == ("out", outs[d])
        else:
            assert (hop.push, hop.dest) == ("none", None)
        assert hop.arrival == ("zero" if not has_in[i] else
                               "none" if src_t[i] == i else "wait")
    for i in range(n):
        # A process holds only its own output: a self-edge stores into
        # it, an edge to another rank goes through that rank's slab.
        hop = PD.plan_hop(False, i, tables, {i: outs[i]}, slabs)
        d = int(dst_t[i])
        if not has_in[d]:
            assert (hop.push, hop.dest) == ("none", None)
        elif d == i:
            assert (hop.push, hop.dest) == ("out", outs[i])
        else:
            assert (hop.push, hop.dest) == ("slab", slabs[d])
        assert hop.arrival == ("zero" if not has_in[i] else
                               "none" if src_t[i] == i else "copy")


@pytest.mark.parametrize("name,n", CASES)
def test_a_real_edge_moves_its_payload_once_and_a_dummy_none(name, n):
    nbytes = 4096
    edges = edges_of(name, n)
    tables = PD.complete_permutation(edges, n)
    dst_t, _, has_in = tables
    outs = {i: 1000 + i for i in range(n)}
    slabs = {i: 2000 + i for i in range(n)}
    for in_process in (True, False):
        hops = [PD.plan_hop(in_process, i, tables,
                            outs if in_process else {i: outs[i]}, slabs)
                for i in range(n)]
        for i, hop in enumerate(hops):
            d = int(dst_t[i])
            edge = moved_bytes(hop._replace(arrival="none"), nbytes) \
                + moved_bytes(hops[d]._replace(push="none"), nbytes)
            if not has_in[d]:
                # The dummy edge moves nothing; its receiver writes
                # zeros into its own output.
                assert hop.push == "none" and hops[d].arrival == "zero"
                assert edge == nbytes
            elif in_process or d == i:
                assert edge == 2 * nbytes      # read x, write the output
            else:
                assert edge == 4 * nbytes      # and the copy-out
    local = [PD.plan_hop(True, i, tables, outs, slabs) for i in range(n)]
    assert sum(moved_bytes(h, nbytes) for h in local) == \
        (2 * len(edges) + (n - len(edges))) * nbytes


# ------------------------------------------------ launches, fake library


@pytest.mark.parametrize("name,n", CASES)
def test_local_mesh_permute_stores_into_each_receivers_output(fake, name, n):
    mesh = local_mesh(n)
    edges = edges_of(name, n)
    dst_t, src_t, has_in = PD.complete_permutation(edges, n)
    got = PD.dma_ppermute(rows_of(n), mesh, edges)
    assert [c[0] for c in fake.calls] == ["tp_dma_permute"] * n
    for i, (_, a) in enumerate(fake.calls):
        d = int(dst_t[i])
        assert a["out"] == got[i].data_ptr()
        assert a["dest"] == (got[d].data_ptr() if has_in[d] else None)
        assert a["push"] == PD.PUSH["out" if has_in[d] else "none"]
        assert a["arrive"] == PD.ARRIVAL[
            "zero" if not has_in[i] else "none" if src_t[i] == i
            else "wait"]
        assert (a["me"], a["dst"], a["src"]) == (i, d, int(src_t[i]))
        assert a["self"] == mesh.windows[0].bases[i]
        assert a["to"] == mesh.windows[0].bases[d]
        assert a["nbytes"] == 4096 and a["share"] == 2 * n
        assert a["stream"] == mesh.streams[i].cuda_stream
    assert PD.launches == {"dma_permute": n, "dma_ship": 0}


@pytest.mark.parametrize("name,n", CASES)
def test_process_mesh_permute_goes_through_the_slab_between_ranks(
        fake, name, n):
    edges = edges_of(name, n)
    dst_t, src_t, has_in = PD.complete_permutation(edges, n)
    for rank in range(n):
        fake.calls.clear()
        mesh = process_mesh(n, rank)
        got = PD.dma_ppermute(rows_of(n)[rank], mesh, edges)
        (entry, a), = fake.calls
        d = int(dst_t[rank])
        win = mesh.windows[PD.MIN_WINDOW]
        if not has_in[d]:
            want = (PD.PUSH["none"], None)
        elif d == rank:
            want = (PD.PUSH["out"], got.data_ptr())
        else:
            want = (PD.PUSH["slab"], win.bases[d] + HEADER)
        assert (entry, a["push"], a["dest"]) == ("tp_dma_permute", *want)
        assert a["arrive"] == PD.ARRIVAL[
            "zero" if not has_in[rank] else "none" if src_t[rank] == rank
            else "copy"]
        assert a["out"] == got.data_ptr() and a["share"] == 1
        assert a["stream"] == CALLER.cuda_stream


@pytest.mark.parametrize("rank", [0, 1])
def test_both_orders_of_a_pair_push_into_the_peers_slab(fake, rank):
    # A submesh and its reverse (pair isolation) share one window; mesh
    # index 1 is global rank 1 in one and rank 0 in the other.
    shared = {}
    for ranks in ((0, 1), (1, 0)):
        fake.calls.clear()
        mesh = Mesh(ranks=ranks, rank=rank, device=torch.device("cpu"),
                    host_group=None, windows=shared)
        PD.dma_ppermute(rows_of(2)[rank], mesh, ((0, 1), (1, 0)))
        (_, a), = fake.calls
        peer = 1 - rank
        assert a["dest"] == shared[PD.MIN_WINDOW].bases[peer] + HEADER
        assert (a["self"], a["to"]) == (
            shared[PD.MIN_WINDOW].bases[rank],
            shared[PD.MIN_WINDOW].bases[peer])
    assert list(shared) == [PD.MIN_WINDOW]


def test_self_edge_stores_into_its_own_output(fake):
    mesh = process_mesh(1, 0)
    x = rows_of(1)[0]
    got = PD.dma_ppermute(x, mesh, ((0, 0),))
    (_, a), = fake.calls
    assert (a["push"], a["arrive"]) == (PD.PUSH["out"], PD.ARRIVAL["none"])
    assert a["dest"] == a["out"] == got.data_ptr()
    assert a["x"] == x.data_ptr()


@pytest.mark.parametrize("name,n", CASES)
def test_ship_pushes_on_side_streams_and_waits_only_where_a_peer_writes(
        fake, name, n):
    mesh = local_mesh(n)
    edges = edges_of(name, n)
    dst_t, _, has_in = PD.complete_permutation(edges, n)
    order = []
    arr, y = PD.dma_ship_compute(
        rows_of(n), mesh, edges,
        lambda a: order.append(len(fake.calls)) or a + 1, rows_of(n))
    pushes = [a for e, a in fake.calls if e == "tp_dma_ship_push"]
    waits = [a for e, a in fake.calls if e == "tp_dma_ship_arrive"]
    # Every push is launched before any compute or arrival.
    assert [e for e, _ in fake.calls[:n]] == ["tp_dma_ship_push"] * n
    assert order[0] == n
    for i, a in enumerate(pushes):
        d = int(dst_t[i])
        assert a["stream"] == mesh.side_streams[i].cuda_stream
        assert a["dest"] == (arr[d].data_ptr() if has_in[d] else None)
        assert a["out"] == arr[i].data_ptr()
    wanted = [i for i in range(n) if has_in[i] and dst_t[i] != i]
    assert [a["me"] for a in waits] == wanted
    for a in waits:
        assert a["stream"] == mesh.streams[a["me"]].cuda_stream
        assert a["x"] is None and a["dest"] is None
    for i in range(n):
        # The side stream follows the rank's own, which follows the
        # caller's.
        assert mesh.side_streams[i].waited == [mesh.streams[i].cuda_stream]
        assert mesh.streams[i].waited == [CALLER.cuda_stream]
        assert torch.equal(y[i], rows_of(n)[i] + 1)
    # The caller joins every rank's own stream (its arrival) and side
    # stream (its push, which wrote a peer's output).
    assert CALLER.waited[-2 * n:] == [10 + i for i in range(n)] + [
        20 + i for i in range(n)]
    assert PD.launches == {"dma_permute": 0, "dma_ship": n}


@pytest.mark.parametrize("name,n", CASES)
def test_process_mesh_ship_pushes_to_the_slab_and_copies_after_compute(
        fake, name, n):
    # A process mesh's fused ship: the push on the mesh's side stream into
    # the peer's slab (its own output on a self-edge, nowhere toward a
    # dummy arrival), the compute, then the copy arrival on the caller's
    # stream where a peer writes this rank's arrival; both grids capped
    # to a quarter of the card (share 4) beside the compute.
    edges = edges_of(name, n)
    dst_t, src_t, has_in = PD.complete_permutation(edges, n)
    for rank in range(n):
        fake.calls.clear()
        CALLER.waited.clear()
        PD.reset_launches()
        mesh = process_mesh(n, rank)
        mesh.side = FakeStream(30)
        order = []
        x = rows_of(n)[rank]
        arr, y = PD.dma_ship_compute(
            x, mesh, edges, lambda a: order.append(len(fake.calls)) or a + 1,
            x)
        (entry, a), *rest = fake.calls
        assert entry == "tp_dma_ship_push" and order == [1]
        d = int(dst_t[rank])
        win = mesh.windows[PD.MIN_WINDOW]
        if not has_in[d]:
            want = (PD.PUSH["none"], None)
        elif d == rank:
            want = (PD.PUSH["out"], arr.data_ptr())
        else:
            want = (PD.PUSH["slab"], win.bases[d] + HEADER)
        assert (a["push"], a["dest"]) == want
        assert (a["x"], a["out"]) == (x.data_ptr(), arr.data_ptr())
        assert (a["stream"], a["share"]) == (30, 4)
        arrival = ("zero" if not has_in[rank] else
                   "none" if src_t[rank] == rank else "copy")
        assert a["arrive"] == PD.ARRIVAL[arrival]
        if arrival == "copy":
            (entry, b), = rest
            assert entry == "tp_dma_ship_arrive"
            assert b["arrive"] == PD.ARRIVAL["copy"]
            assert (b["x"], b["dest"], b["out"]) == (None, None,
                                                     arr.data_ptr())
            assert (b["stream"], b["share"], b["epoch"]) == (
                CALLER.cuda_stream, 4, a["epoch"])
        else:
            assert rest == []
        # The push follows the caller's stream; the caller joins it.
        assert mesh.side.waited == [CALLER.cuda_stream]
        assert CALLER.waited == [30]
        assert PD.launches == {"dma_permute": 0, "dma_ship": 1}
        assert torch.equal(y, x + 1)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("chunks", [2, 4])
def test_launch_counts_per_migration_match_the_smoke(fake, n, chunks):
    # One migration ships K and V (chip_smoke.py's expect_launches): the
    # chunk wave makes chunks - 1 fused ships and one last permute, each
    # launching once per rank.
    mesh = local_mesh(n)
    edges = edges_of("unidir", n)
    for _ in ("k", "v"):
        C.chunked_ppermute_compute(lambda c, k: c * 2, rows_of(n, 64), mesh,
                                   edges, chunk_dim=0, chunks=chunks,
                                   transport="pallas_dma")
    chip_smoke.expect_launches(dict(PD.launches), {"kv_migrated": 1}, n,
                               chunks, "route")


@pytest.mark.parametrize("name,n", CASES)
def test_epochs_advance_once_per_call(fake, name, n):
    mesh = local_mesh(n)
    edges = edges_of(name, n)
    for _ in range(3):
        PD.dma_ppermute(rows_of(n), mesh, edges)
        PD.dma_ship_compute(rows_of(n), mesh, edges, lambda a: a, rows_of(n))
    assert mesh.windows[0].epoch == 6
    by_epoch = {}
    for _, a in fake.calls:
        by_epoch.setdefault(a["epoch"], []).append(a["me"])
    assert sorted(by_epoch) == [1, 2, 3, 4, 5, 6]
    for e, ranks in by_epoch.items():
        # Every rank launches once a call (a ship's arrival shares its
        # push's epoch).
        assert sorted(set(ranks)) == list(range(n)), e


@pytest.mark.parametrize("name,n", CASES)
def test_refused_launch_raises_before_any_later_launch(fake, name, n):
    fake.err = 9
    mesh = local_mesh(n)
    edges = edges_of(name, n)
    with pytest.raises(BackendError, match="tp_dma_permute kernel launch "
                                           "failed: CUDA error 9"):
        PD.dma_ppermute(rows_of(n), mesh, edges)
    assert len(fake.calls) == 1 and PD.launches["dma_permute"] == 0
    fake.calls.clear()
    with pytest.raises(BackendError, match="tp_dma_ship_push kernel launch "
                                           "failed: CUDA error 9"):
        PD.dma_ship_compute(rows_of(n), mesh, edges, lambda a: a,
                            rows_of(n))
    assert len(fake.calls) == 1 and PD.launches["dma_ship"] == 0


def test_windows_of_a_local_mesh_hold_flags_only(fake):
    mesh = local_mesh(2)
    PD.dma_ppermute(rows_of(2, 1 << 22), mesh, ((0, 1),))
    PD.dma_ppermute(rows_of(2, 16), mesh, ((0, 1),))
    assert list(mesh.windows) == [0] and mesh.windows[0].slabs == {}
    proc = process_mesh(2, 0)
    PD.dma_ppermute(rows_of(2, 16)[0], proc, ((0, 1),))
    PD.dma_ppermute(rows_of(2, 3 << 20)[0], proc, ((0, 1),))
    assert sorted(proc.windows) == [PD.MIN_WINDOW, 4 << 20]


def test_cpu_tensors_still_take_the_plain_version():
    # Without the fake, CPU tensors never reach the library.
    mesh = LocalMesh(["cpu"] * 2)
    x = [torch.arange(6, dtype=torch.float32) + 10 * i for i in range(2)]
    PD.reset_launches()
    got = PD.dma_ppermute(x, mesh, ((0, 1),))
    assert PD.launches["dma_permute"] == 0
    want = C.expected_permute(np.stack([t.numpy() for t in x]), ((0, 1),))
    assert all(np.array_equal(g.numpy(), w) for g, w in zip(got, want))
