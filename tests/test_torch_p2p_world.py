"""Rank-side cases of the port's peer-transfer tests, and the port's own
error paths — this file imports torch and the port only, never JAX.

Each ``*_case`` function runs on every rank of a spawned world
(``tpu_p2p_torch.parallel.launch.run_world(n, "<this file>:<case>",
kwargs)``), builds its runtime, and returns what the parent
compares: ``tests/test_torch_p2p.py`` holds the CPU arrivals against the
JAX reference, ``tests/test_torch_cuda.py`` runs the card cases.
"""

import ctypes

import numpy as np
import pytest
import torch

from tpu_p2p_torch import cli as TCLI
from tpu_p2p_torch.config import BenchConfig
from tpu_p2p_torch.parallel import collectives as C
from tpu_p2p_torch.parallel import pallas_dma as PD
from tpu_p2p_torch.parallel import runtime as RT
from tpu_p2p_torch.utils import timing
from tpu_p2p_torch.workloads import base as WB
from tpu_p2p_torch.utils.errors import (BackendError, PlacementError,
                                        TpuP2PError, TransferTimeout)

# tests/test_pallas_dma.py:101 — rings, a shifted ring, a pair, a
# full-duplex pair, a scattered partial set, and empty.
EDGE_SETS_8 = {
    "ring": C.ring_edges(8),
    "shift3": C.ring_edges(8, shift=3),
    "unidir": C.unidir_edges(2, 5),
    "bidir": C.bidir_edges(1, 6),
    "partial": ((0, 1), (3, 2), (6, 4)),
    "empty": (),
}


def cut_edges(edges, n):
    """``edges`` on a world of ``n``: ranks taken mod ``n``, an edge kept
    only while its source and destination are still unused (the 8-rank
    sets come back unchanged)."""
    out, srcs, dsts = [], set(), set()
    for s, d in edges:
        s, d = s % n, d % n
        if s not in srcs and d not in dsts:
            out.append((s, d))
            srcs.add(s)
            dsts.add(d)
    return tuple(out)


def edge_sets(n):
    return {name: cut_edges(e, n) for name, e in EDGE_SETS_8.items()}


def float_payload(n, shape=(5, 3), seed=0):
    """The float32 payload of tests/test_pallas_dma.py:131: ``[n, *shape]``
    standard normals from ``seed``."""
    return np.random.default_rng(seed).standard_normal(
        (n, *shape)).astype(np.float32)


# --------------------------------------------------------- rank cases


def cpu_arrivals_case(msg_bytes=136, seed=0):
    """Every edge set through ``ppermute`` and ``dma_ppermute`` at
    ``msg_bytes`` of int8 and a [5, 3] float32 row, plus one backward
    pass of ``dma_ppermute`` per set → this rank's arrays."""
    rt = RT.make_runtime(device="cpu")
    mesh, i = rt.mesh, rt.rank
    xf = torch.from_numpy(float_payload(rt.world, seed=seed)[i])
    gf = torch.from_numpy(float_payload(rt.world, seed=seed + 1)[i])
    out = {}
    for name, edges in edge_sets(rt.world).items():
        x8 = C.make_payload(mesh, msg_bytes, np.int8)
        xg = xf.clone().requires_grad_(True)
        y = C.dma_ppermute(xg, mesh, edges)
        y.backward(gf)
        out[name] = {
            "xla_int8": C.ppermute(x8, mesh, edges).numpy(),
            "dma_int8": C.dma_ppermute(x8, mesh, edges).numpy(),
            "xla_f32": C.ppermute(xf, mesh, edges).numpy(),
            "dma_f32": y.detach().numpy(),
            "dma_grad": xg.grad.numpy(),
        }
    rt.close()
    return out


def cpu_ship_case(sets, ship, w, wave_x, wave_w, wave_edges, chunks):
    """The fused ship and the chunk wave on a process mesh (this rank's
    rows of the ``[n, ...]`` inputs, the plain versions over gloo):
    ``dma_ship_compute`` of ``ship`` with ``c @ w`` over each of
    ``sets``, its gradient over ``sets["ring"]``, and
    ``chunked_ppermute_compute`` of ``wave_x`` over both transports →
    this rank's arrays."""
    rt = RT.make_runtime(device="cpu")
    mesh, i = rt.mesh, rt.rank
    x, wi = torch.from_numpy(ship[i]), torch.from_numpy(w[i])
    out = {}
    for name, edges in sets.items():
        arr, y = PD.dma_ship_compute(x, mesh, edges, lambda a, b: a @ b,
                                     x * 2, wi)
        out[name] = (arr.numpy(), y.numpy())
    xg, wg = x.clone().requires_grad_(True), wi.clone().requires_grad_(True)
    arr, y = PD.dma_ship_compute(xg, mesh, sets["ring"],
                                 lambda a, b: a @ b, xg, wg)
    ((arr * arr * 3).sum() + (y * y).sum()).backward()
    out["grads"] = (xg.grad.numpy(), wg.grad.numpy())
    ww = torch.from_numpy(wave_w)
    for transport in ("pallas_dma", "xla"):
        out[f"wave_{transport}"] = C.chunked_ppermute_compute(
            lambda c, k: c @ ww + k, torch.from_numpy(wave_x[i]), mesh,
            wave_edges, chunk_dim=0, chunks=chunks,
            transport=transport).numpy()
    rt.close()
    return out


def _oracle_row(mesh, nbytes, dtype, edges):
    want = C.expected_permute(C.host_payload(mesh, nbytes, dtype), edges)
    return want[mesh.index:mesh.index + 1]


def card_checks_case(sizes=(136, 4096, 32 << 20), device="cuda:0",
                     chain=9):
    """On ``device`` (shared by every rank): for each edge set and size,
    the kernel's arrival against the plain version on ``.cpu()`` copies
    and against ``expected_permute``, bitwise; a float32 [5, 3] row and
    one backward pass; then back-to-back launches with no drain between
    them (a ring chain and a mixed sequence of edge sets) against the
    host oracle. → per-rank verdicts and the launch count."""
    rt = RT.make_runtime(device=device)
    mesh = rt.mesh
    PD.reset_launches()
    made = 0
    bad = []
    for name, edges in edge_sets(rt.world).items():
        for nbytes in sizes:
            x = C.make_payload(mesh, nbytes, np.int8)
            got = C.dma_ppermute(x, mesh, edges)
            made += 1
            plain = PD._dma_ppermute_plain(x.cpu(), mesh, edges)
            want = _oracle_row(mesh, nbytes, np.int8, edges)
            got = got.cpu()
            if not torch.equal(got, plain) or not np.array_equal(
                    got.numpy(), want):
                bad.append((name, nbytes))
        xf = torch.from_numpy(float_payload(rt.world)[rt.rank]).to(
            device).requires_grad_(True)
        gf = torch.from_numpy(float_payload(rt.world, seed=1)[rt.rank])
        y = C.dma_ppermute(xf, mesh, edges)
        y.backward(gf.to(device))
        made += 2
        rev = tuple((d, s) for s, d in edges)
        if not (torch.equal(y.detach().cpu(),
                            PD._dma_ppermute_plain(xf.detach().cpu(),
                                                   mesh, edges))
                and torch.equal(xf.grad.cpu(),
                                PD._dma_ppermute_plain(gf, mesh, rev))):
            bad.append((name, "float32+grad"))
    # Back to back, no drain: a ring chain, then a mixed sequence.
    ring = C.ring_edges(rt.world)
    x = C.make_payload(mesh, 4096, np.int8)
    y = x
    for _ in range(chain):
        y = C.dma_ppermute(y, mesh, ring)
    made += chain
    host = C.host_payload(mesh, 4096, np.int8)
    want = host
    for _ in range(chain):
        want = C.expected_permute(want, ring)
    if not np.array_equal(y.cpu().numpy(), want[rt.rank:rt.rank + 1]):
        bad.append(("ring chain", chain))
    y, want = x, host
    for name, edges in list(edge_sets(rt.world).items()) * 2:
        y = C.dma_ppermute(y, mesh, edges)
        want = C.expected_permute(want, edges)
        made += 1
    if not np.array_equal(y.cpu().numpy(), want[rt.rank:rt.rank + 1]):
        bad.append(("mixed sequence", 12))
    rt.barrier()
    launches = PD.launches["dma_permute"]
    rt.close()
    return {"bad": bad, "launches": launches, "expected_launches": made}


def card_reversed_segments_case(nbytes=32 << 20, device="cuda:0"):
    """The kernel built to push a slab's segments last first
    (``-DTP_DMA_REVERSE_SEGMENTS=1``): each edge set at ``nbytes`` int8
    against ``expected_permute``, bitwise, then a 3-hop ring chain with no
    drain. → per-rank verdicts and the launch count."""
    from tpu_p2p_torch.utils import cuda_build

    build = cuda_build.load
    cuda_build.load = lambda name, defines=(): build(
        name, ("TP_DMA_REVERSE_SEGMENTS=1",))
    PD._LIB = None
    rt = RT.make_runtime(device=device)
    mesh = rt.mesh
    PD.reset_launches()
    bad, made = [], 0
    for name, edges in edge_sets(rt.world).items():
        got = C.dma_ppermute(C.make_payload(mesh, nbytes, np.int8), mesh,
                             edges)
        made += 1
        if not np.array_equal(got.cpu().numpy(),
                              _oracle_row(mesh, nbytes, np.int8, edges)):
            bad.append(name)
    ring = C.ring_edges(rt.world)
    y = C.make_payload(mesh, nbytes, np.int8)
    want = C.host_payload(mesh, nbytes, np.int8)
    for _ in range(3):
        y = C.dma_ppermute(y, mesh, ring)
        want = C.expected_permute(want, ring)
        made += 1
    if not np.array_equal(y.cpu().numpy(), want[rt.rank:rt.rank + 1]):
        bad.append("ring chain")
    rt.barrier()
    launches = PD.launches["dma_permute"]
    rt.close()
    return {"bad": bad, "launches": launches, "expected_launches": made}


def card_timeout_case(device="cuda:0", timeout_s=0.5):
    """Rank 0 launches a hop that rank 1 never joins: its kernel must
    give up past ``timeout_s`` and the wrapper raise TransferTimeout."""
    rt = RT.make_runtime(device=device)
    mesh = rt.mesh
    x = C.make_payload(mesh, 4096, np.int8)
    C.dma_ppermute(x, mesh, C.ring_edges(rt.world))  # window + 1 good hop
    torch.cuda.synchronize()
    raised = None
    if rt.rank == 0:
        PD.dma_ppermute(x, mesh, C.ring_edges(rt.world), timeout_s=timeout_s)
        torch.cuda.synchronize()
        try:
            PD.check_faults()
        except TransferTimeout as e:
            raised = str(e)
    rt.close()
    return raised


def card_check_timeout_case(device="cuda:0", timeout_s=0.5):
    """A ``--check`` hop whose peer never launches. One good check first,
    so the allocator holds a freed block with the expected arrival in
    it; then rank 1 answers with the right row without launching, and
    rank 0's kernel gives up. Rank 0 must see TransferTimeout and rank 1
    a failed check — neither a pass on stale memory. Then a serialized
    measurement whose only timed hop times out must come back a timed-out
    cell. → per rank: (check error type, error text, timed_out)."""
    rt = RT.make_runtime(device=device)
    mesh = rt.mesh
    edges, nbytes = C.bidir_edges(0, 1), 4096
    ctx = WB.WorkloadContext(rt=rt, cfg=BenchConfig(
        pattern="pairwise", transport="pallas_dma", check=True))
    WB.verify_edges(ctx, mesh, "d", edges, nbytes)
    if rt.rank == 0:
        hop = lambda x: PD.dma_ppermute(x, mesh, edges,  # noqa: E731
                                        timeout_s=timeout_s)
    else:
        row = _oracle_row(mesh, nbytes, np.int8, edges)
        hop = lambda x: torch.from_numpy(row).to(device)  # noqa: E731
    ctx.cache.permute = lambda *a, **k: hop
    err = None
    try:
        WB.verify_edges(ctx, mesh, "d", edges, nbytes)
    except TpuP2PError as e:
        err = (type(e).__name__, str(e))
    timed_out = None
    if rt.rank == 0:
        x = ctx.payloads.get(mesh, nbytes, np.int8)
        s = timing.measure_serialized(
            hop, x, 1, warmup=0,
            barrier=lambda: torch.cuda.current_stream().synchronize())
        timed_out = s.timed_out and s.mean_region != s.mean_region
    rt.close()
    return err, timed_out


# ------------------------------------------------- port-only tests


def test_cut_edges_keeps_the_reference_sets_at_eight():
    assert edge_sets(8) == EDGE_SETS_8
    assert edge_sets(2)["unidir"] == ((0, 1),)
    for n in (2, 4):
        for edges in edge_sets(n).values():
            PD.complete_permutation(edges, n)  # all valid partial perms


def _world1_cpu():
    return RT.make_runtime(device="cpu")


def test_bad_edges_and_transport_are_rejected():
    rt = _world1_cpu()
    try:
        cache = C.CollectiveCache()
        for bad, match in ((((0, 0), (0, 0)), "duplicate"),
                           (((0, 3),), "out of range")):
            with pytest.raises(ValueError, match=match):
                cache.permute(rt.mesh, "d", bad)
            with pytest.raises(ValueError, match=match):
                C.dma_ppermute(torch.zeros(1, 4), rt.mesh, bad)
        with pytest.raises(ValueError, match="unknown transport"):
            cache.permute(rt.mesh, "d", ((0, 0),), transport="nccl")
        with pytest.raises(ValueError, match="axis"):
            cache.permute(rt.mesh, "x", ((0, 0),))
    finally:
        rt.close()


def test_world_of_one_self_edge_and_empty():
    rt = _world1_cpu()
    try:
        x = C.make_payload(rt.mesh, 136, np.int8)
        for fn in (C.ppermute, C.dma_ppermute):
            assert torch.equal(fn(x, rt.mesh, ((0, 0),)), x)
            assert not fn(x, rt.mesh, ()).any()
        assert rt.all_true(True) and not rt.all_true(False)
        assert rt.broadcast("a", 0) == "a" and rt.gather(3) == [3]
    finally:
        rt.close()


def test_collective_cache_keys_and_chains():
    rt = _world1_cpu()
    try:
        cache = C.CollectiveCache()
        hop = cache.permute(rt.mesh, "d", ((0, 0),))
        assert cache.permute(rt.mesh, "d", [[0, 0]]) is hop  # canonical
        assert cache.permute(rt.mesh, "d", ((0, 0),),
                             transport="pallas_dma") is not hop
        chain = cache.permute_chain(rt.mesh, "d", ((0, 0),), 3)
        assert cache.permute_chain(rt.mesh, "d", ((0, 0),), 3) is chain
        assert cache.stats() == {"size": 3, "hits": 2, "misses": 3}
        x = C.make_payload(rt.mesh, 8, np.int8)
        assert torch.equal(chain(x), x)
        assert torch.equal(cache.loopback_chain(rt.mesh, 2)(x), x + 2)
        assert len(cache) == 4
    finally:
        rt.close()


def test_kernel_fault_fails_the_check_and_times_out_the_cell(monkeypatch):
    # A fault record as the kernel leaves it when it gives up waiting for
    # a peer: the drain after the hop must surface it, so --check fails
    # instead of comparing an output that was never written, and the
    # measurement marks the cell timed out.
    rec = PD._FaultRecord(phase=2, rank=0, peer=1, epoch=7)
    monkeypatch.setattr(PD, "_FAULT", (ctypes.addressof(rec), 0))
    rt = _world1_cpu()
    try:
        ctx = WB.WorkloadContext(rt=rt, cfg=BenchConfig(
            pattern="pairwise", transport="pallas_dma", check=True))
        with pytest.raises(TransferTimeout, match="rank 1's arrival at "
                                                  "epoch 7"):
            WB.verify_edges(ctx, rt.mesh, "d", ((0, 0),), 136)
        assert rec.phase == 0  # read once, then cleared
        WB.verify_edges(ctx, rt.mesh, "d", ((0, 0),), 136)
        rec.phase = 1
        x = C.make_payload(rt.mesh, 136, np.int8)
        s = timing.measure_serialized(lambda v: v, x, 3, warmup=0,
                                      barrier=rt.barrier)
        assert s.timed_out and s.count == 0 and s.mean_region != \
            s.mean_region
    finally:
        rt.close()


def test_oversubscribed_runtime_raises(monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(PlacementError, match="local rank 1 needs cuda:1"):
        RT.make_runtime()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("LOCAL_RANK", "0")
    with pytest.raises(PlacementError, match="0 CUDA device"):
        RT.make_runtime()


def test_xla_transport_on_shared_card_raises():
    # Ranks that share a card have no NCCL group (make_runtime decides
    # that from the gathered (host, device) keys).
    assert not RT._nccl_possible([(1, "cuda:0"), (1, "cuda:0")])
    assert RT._nccl_possible([(1, "cuda:0"), (1, "cuda:1")])
    assert not RT._nccl_possible([(1, "cpu"), (1, "cpu")])
    mesh = RT.Mesh(ranks=(0, 1), rank=0, device=torch.device("cuda", 0),
                   host_group=None)
    with pytest.raises(BackendError, match="--transport pallas_dma"):
        C.CollectiveCache().permute(mesh, "d", ((0, 1),))
    with pytest.raises(BackendError, match="one card per rank"):
        C.CollectiveCache().permute_chain(mesh, "d", ((0, 1),), 4)
    # The peer-push transport is the one that runs there.
    C.CollectiveCache().permute(mesh, "d", ((0, 1),), transport="pallas_dma")


def test_num_devices_must_match_the_world():
    with pytest.raises(TpuP2PError, match="only 1 visible"):
        RT.make_runtime(num_devices=2, device="cpu")


def test_cpu_tensor_takes_plain_and_other_devices_raise():
    rt = _world1_cpu()
    try:
        PD.reset_launches()
        PD.dma_ppermute(torch.ones(3), rt.mesh, ((0, 0),))
        assert PD.launches["dma_permute"] == 0  # the plain version ran
        with pytest.raises(ValueError, match="no kernel for device meta"):
            PD._dma_ppermute(torch.ones(3, device="meta"), rt.mesh,
                             ((0, 0),), None, 1.0)
    finally:
        rt.close()


def _port_cli(*args):
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-m", "tpu_p2p_torch", *args],
                          capture_output=True, text=True, cwd=repo,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


def test_cli_sweep_fused_jsonl_resume_and_num_devices(tmp_path):
    log = str(tmp_path / "cells.jsonl")
    args = ["--cpu-mesh", "2", "--sweep", "1KiB:2KiB", "--iters", "2",
            "--mode", "fused", "--transport", "pallas_dma", "--jsonl", log]
    first = _port_cli(*args)
    assert first.count("Evaluating the") == 4  # 2 sizes x uni, bi
    assert "pairwise bi-dir 2KiB fused pallas_dma" in first
    with open(log) as fh:
        assert len(fh.readlines()) == 8  # 2 sizes x 2 dirs x 2 cells
    # Resumed cells print their logged value; nothing is appended.
    assert _port_cli(*args, "--resume") == first
    with open(log) as fh:
        assert len(fh.readlines()) == 8
    listing = _port_cli("--cpu-mesh", "4", "--num-devices", "2",
                        "--list-devices")
    assert listing.startswith("2 devices on 1 host(s), 2 per host")
    assert TCLI.main(["--cpu-mesh", "2", "--num-devices", "3"]) == 1


@pytest.mark.parametrize("argv", [
    ["--hybrid"], ["--pp-schedule", "zb"], ["--tick-lowering", "switch"],
    ["obs"], ["topo"], ["zb"],
])
def test_unported_flags_exit_2(argv, capsys, monkeypatch):
    if argv[0] in ("--hybrid", "obs", "topo"):
        assert TCLI.main(argv) == 2
        assert "not ported yet" in capsys.readouterr().err
        return
    # Ported since: the schedule knobs parse into the config (a no-op
    # for the default pairwise pattern) and `zb` runs the smoke; each
    # then takes the default card path, which this host does not have
    # (the default benchmark's exit, test_default_benchmark_needs_a_card).
    cfg = TCLI.config_from_args(TCLI.build_parser().parse_args(
        [] if argv == ["zb"] else argv))
    assert (cfg.pp_schedule, cfg.tick_lowering) == (
        {"--pp-schedule": ("zb", "masked"),
         "--tick-lowering": ("1f1b", "switch")}.get(argv[0],
                                                     ("1f1b", "masked")))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert TCLI.main(argv) == 255
    err = capsys.readouterr().err
    assert "0 CUDA device" in err and "not ported yet" not in err


def test_default_benchmark_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert TCLI.main([]) == 255  # PlacementError, as the reference exits
    assert "0 CUDA device" in capsys.readouterr().err


def test_ship_kernel_call_takes_each_mesh_kinds_form(monkeypatch):
    # The kernel branch of dma_ship_compute (taken for CUDA tensors),
    # faked here to run without a card: on a LocalMesh it hands the
    # kernel call the per-rank rows, on a process mesh this rank's.
    seen = []

    def fake_kernel(rows, mesh, tables, compute, timeout_s):
        seen.append(len(rows))
        return ([torch.zeros_like(r) for r in rows],
                [compute(i) for i in mesh.local_ranks])

    monkeypatch.setattr(PD, "_device_type", lambda rows: "cuda")
    monkeypatch.setattr(PD, "_dma_transport_ship_call", fake_kernel)
    arr, y = PD.dma_ship_compute([torch.ones(3)] * 2,
                                 RT.LocalMesh(["cpu"] * 2), ((0, 1),),
                                 lambda a: a + 1, [torch.ones(3)] * 2)
    assert len(arr) == len(y) == 2
    assert torch.equal(y[1], torch.full((3,), 2.0))
    assert seen == [2]
    rt = _world1_cpu()
    try:
        arr, y = PD.dma_ship_compute(torch.ones(3), rt.mesh, ((0, 0),),
                                     lambda a: a * 2, torch.ones(3))
        assert torch.equal(y, torch.full((3,), 2.0))
        assert arr.shape == (3,) and seen == [2, 1]
    finally:
        rt.close()
