"""The port's collective ledger (``tpu_p2p_torch/obs/ledger.py``), its
hooks and the link throttle against the JAX reference's
``tpu_p2p/obs/ledger.py`` and ``tpu_p2p/parallel/collectives.py``.

- Host logic is equal: ``wire_bytes``, the registry's totals and
  ``totals_record``.
- Each ``live_capture`` workload, recorded alone on a gloo world of 8
  (``tests/torch_obs_world.py``), records the reference's entries on its
  8-device CPU mesh, in order: kind, axis, payload and wire bytes,
  count, label and edges. The reference's zero-bubble tick step does
  not trace on the installed jax (its vma check), so the port's ``zb``
  step is held to the rule its golden totals pin: the rows of the fused
  1F1B step. The whole capture's totals equal those of
  ``tests/golden/cli_obs_8dev.txt``, and a warm program records nothing.
- The reference's tests of the bucketed all-gather and the FSDP per-leaf
  gather fail on the installed jax (its vma check), so the port is
  held to the rule those tests assert: one row a bucket with the
  bucket's local bytes, one row a planned leaf labelled with its name.
- ``join_trace`` on synthetic Kineto event lists with NCCL's kernel
  names: per-kind and per-link results as computed by hand, ragged
  pools, unmatched events, and NCCL's all-to-all sharing the send/recv
  pool with the permutes; and a recorded-once tick loop beside an
  all-to-all, whose kernels follow the issue labels of a real CPU
  profiler window: joined by label, nothing is ragged and each ring edge
  set carries its own events, where the cyclic pool comes out ragged;
  the same loop's autograd-backward hops inside their labelled ranges,
  with two programs' sites of one signature: nothing ragged, each
  backward event on the reversed edge set, the totals the forward rows'.
- The sums of a reordered line on the gloo world: each mesh-order hop an
  unrowed ``ppermute`` entry over its edges, the rows and totals those
  of the rank-order line; NCCL kernels placed in the real issue ranges
  of the window join with nothing ragged or unmatched, each hop's
  ``SendRecv`` on its own entry and each sum's kernel on its row.
- A GPipe step's autograd backward on the gloo world labels each reverse
  hop with the forward site over the reversed edges and adds no row; a
  profiled window's measured part starts after the mesh's barrier on
  every rank.
- The degraded-link throttle: values bitwise the clean ring's, the
  reference's ``fault_throttle`` rows, nothing off the edge; the health
  probe under a 16x throttle flags exactly that edge.
- The serving rows: ``serve_ledger`` after the summary, and the disagg
  migration's ``kv_migrate:xla`` rows, one program a (pages,
  destination).
"""

import math
import os
import time

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh

from tpu_p2p.obs import ledger as JL
from tpu_p2p_torch.obs import ledger as TL
from tpu_p2p_torch.parallel.launch import run_world

WORLD = os.path.join(os.path.dirname(__file__), "torch_obs_world.py")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "cli_obs_8dev.txt")
MSG, COUNT = 256 * 1024, 4


def _issues(led):
    return [(it.kind, it.axis, it.payload_bytes, it.wire_bytes, it.count,
             it.label, it.edges) for it in led.issues]


def _reference_workloads(n=8):
    """Each reference live-capture workload recorded alone → name →
    issues (the zero-bubble step is left out: it does not trace here)."""
    import jax.numpy as jnp

    from tpu_p2p.models import moe as M
    from tpu_p2p.models import pipeline as PL
    from tpu_p2p.models import schedule as SCH
    from tpu_p2p.parallel import collectives as C

    devs = np.asarray(jax.devices()[:n])
    mesh = JMesh(devs, ("d",))
    cache = C.CollectiveCache()
    payload = C.make_payload(mesh, MSG)
    dma_payload = C.make_payload(mesh, min(MSG, 64 * 1024))
    runs = {
        "ring": lambda: cache.permute_chain(mesh, "d", C.ring_edges(n),
                                            COUNT)(payload),
        "all_gather": lambda: cache.ag_chain(mesh, "d", COUNT)(payload),
        "dma": lambda: cache.dma_permute_chain(
            mesh, "d", C.ring_edges(n), COUNT)(dma_payload),
    }
    ep_mesh = JMesh(devs, ("ep",))
    moe_x = jnp.zeros((8 * n, 16), jnp.float32)
    for mode in ("none", "ring"):
        cfg = M.MoEConfig(d_model=16, d_ff=32, num_experts=n,
                          capacity_factor=float(n), ep_overlap=mode)
        layer, params = M.make_moe_layer(ep_mesh, cfg), \
            M.init_moe_params(cfg)
        runs[f"moe_{mode}"] = (lambda layer=layer, params=params:
                               layer(params, moe_x))
    pp_mesh = JMesh(devs, ("pp",))
    pp_cfg = PL.PipelineConfig(d_model=8, d_ff=16, stages=n,
                               microbatches=2)
    pp_params = PL.place_pipeline_params(PL.init_pipeline_params(pp_cfg),
                                         pp_mesh)
    pp_x = jnp.zeros((2, 4, 8), jnp.float32)
    for mode in ("none", "wave"):
        fwd = PL.make_pipeline_forward(pp_mesh, pp_cfg, pp_overlap=mode,
                                       pp_chunks=2)
        runs[f"gpipe_{mode}"] = lambda fwd=fwd: fwd(pp_params, pp_x)
    stp = SCH.make_tick_train_step(pp_mesh, pp_cfg, SCH.compile_1f1b(2, n))
    runs["sched_1f1b"] = lambda: stp(pp_params, pp_x, jnp.ones_like(pp_x))
    out = {}
    for name, run in runs.items():
        with JL.recording() as led:
            jax.block_until_ready(run())
        out[name] = _issues(led)
    return out


@pytest.fixture(scope="module")
def world():
    return run_world(8, f"{WORLD}:ledger_case",
                     {"msg_bytes": MSG, "count": COUNT}, timeout=300)


@pytest.fixture(scope="module")
def reference():
    return _reference_workloads()


def _golden_totals():
    """``kind/axis`` → issues, payload, wire bytes of the golden table."""
    out = {}
    with open(GOLDEN) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) == 8 and parts[0] == "#" and parts[4].isdigit():
                out[f"{parts[1]}/{parts[2]}"] = {
                    "issues": int(parts[3]), "payload_bytes": int(parts[4]),
                    "wire_bytes": int(parts[5])}
    return out


# ------------------------------------------------------------ host logic


@pytest.mark.parametrize("kind", ["ppermute", "dma", "kv_migrate",
                                  "all_gather", "reduce_scatter",
                                  "all_to_all", "all_reduce"])
def test_wire_bytes_equal_the_reference(kind):
    for n in (1, 2, 3, 4, 8):
        for b in (0, 1, 7, 4096, 3 * 1024 * 1024 + 5):
            assert TL.wire_bytes(kind, n, b) == JL.wire_bytes(kind, n, b)
    with pytest.raises(ValueError, match="unknown collective kind"):
        TL.wire_bytes("bogus", 2, 8)


def test_totals_and_totals_record_equal_the_reference():
    rng = np.random.default_rng(7)
    kinds = ["ppermute", "dma", "all_gather", "reduce_scatter",
             "all_to_all", "all_reduce", "kv_migrate"]
    calls = []
    for _ in range(40):
        kind = kinds[rng.integers(len(kinds))]
        n = int(rng.choice([2, 4, 8]))
        calls.append(dict(kind=kind, axis=str(rng.choice(["d", "pp", "ep"])),
                          nbytes=int(rng.integers(1, 1 << 20)), axis_size=n,
                          count=int(rng.integers(1, 5)),
                          edges=([(0, 1), (1, 0)] if kind == "ppermute"
                                 else None),
                          label=f"l{int(rng.integers(3))}"))
    with TL.recording() as t, JL.recording() as j:
        for c in calls:
            kw = dict(c)
            kind, axis = kw.pop("kind"), kw.pop("axis")
            TL.record_issue(kind, axis, **kw)
            JL.record_issue(kind, axis, **kw)
    assert _issues(t) == _issues(j)
    assert t.totals() == j.totals()
    assert TL.totals_record(t) == JL.totals_record(j)
    assert [(e.kind, e.count) for e in t.expanded()] == \
        [(e.kind, e.count) for e in j.expanded()]


def test_recording_is_scoped_nested_and_muted():
    TL.record_issue("ppermute", "d", nbytes=8, axis_size=2)  # no ledger
    with TL.recording() as outer:
        with TL.recording() as inner:
            TL.record_issue("all_reduce", "d", nbytes=8, axis_size=2)
        with TL.muted():
            TL.record_issue("all_reduce", "d", nbytes=8, axis_size=2)
        prog = TL.program(lambda: TL.record_issue(
            "ppermute", "d", nbytes=4, axis_size=2))
        prog()
        prog()  # warm: records nothing
        body = TL.ScanBody()
        for _ in range(3):
            with body.site("a"):
                TL.record_issue("dma", "d", nbytes=2, axis_size=2)
    assert len(inner) == 1 and len(outer) == 3
    assert [i.kind for i in outer.issues] == ["all_reduce", "ppermute",
                                              "dma"]
    assert TL.active() is None


# --------------------------------------------- the capture's workloads


@pytest.mark.parametrize("name", ["ring", "all_gather", "dma", "moe_none",
                                  "moe_ring", "gpipe_none", "gpipe_wave",
                                  "sched_1f1b"])
def test_capture_workload_records_the_references_entries(world, reference,
                                                         name):
    for rank in world:
        got = [tuple(tuple(map(tuple, e)) if isinstance(e, list) and e
                     and isinstance(e[0], (list, tuple)) else e
                     for e in it)
               for it in rank["workloads"][name]["issues"]]
        assert got == reference[name], name


def test_zero_bubble_step_records_the_fused_steps_rows(world):
    # The reference's zb step fails on the installed jax; its golden
    # totals (ppermute pp 7, all_reduce pp 4) are GPipe's and the fused
    # step's rows plus one more fused step's.
    for rank in world:
        w = rank["workloads"]
        assert w["sched_zb"]["issues"] == w["sched_1f1b"]["issues"]


def test_capture_totals_equal_the_golden_table(world, reference):
    golden = _golden_totals()
    want = {}
    for name, issues in list(reference.items()) + [
            ("sched_zb", reference["sched_1f1b"])]:
        for kind, axis, payload, wire, count, _, _ in issues:
            d = want.setdefault(f"{kind}/{axis}", {
                "issues": 0, "payload_bytes": 0, "wire_bytes": 0})
            d["issues"] += count
            d["payload_bytes"] += payload * count
            d["wire_bytes"] += wire * count
    assert want == golden
    for rank in world:
        assert rank["capture_totals"] == golden
        assert rank["capture_no_track"] is True
        assert rank["warm_issues"] == 0  # a warm program records nothing


def test_bucketed_gather_records_one_row_a_bucket(world):
    # The rule of the reference's
    # test_bucketed_all_gather_records_bucket_bytes: one bucket covers
    # both float32 leaves, payload the local shards' bytes (2x4 + 1
    # floats), wire (n-1) x payload.
    for rank in world:
        (row,) = rank["bucketed"]
        kind, axis, payload, wire, count, label, edges = row
        assert (kind, axis, count, label) == ("all_gather", "d", 1,
                                              "bucketed_all_gather")
        assert payload == 2 * 4 * 4 + 1 * 4 and wire == 7 * payload


def test_fsdp_gather_records_one_row_a_planned_leaf(world):
    # The rule of the reference's
    # test_fsdp_all_gather_params_records_per_leaf: only the planned
    # leaf records, with the dp shard's bytes and its name in the label.
    for rank in world:
        (row,) = rank["fsdp"]
        assert row[0] == "all_gather" and row[2] == (16 // 8) * 2 * 4
        assert row[5].endswith(":w")


def test_ring_collective_matmuls_record_once_a_ring(world):
    # As the reference's test_ring_collective_matmuls_record_ring_hops.
    for rank in world:
        by_label = {r[5]: r for r in rank["rings"]}
        ag = by_label["ring_allgather_matmul"]
        rs = by_label["matmul_ring_reducescatter"]
        assert ag[0] == rs[0] == "ppermute"
        assert ag[4] == rs[4] == 7
        assert ag[2] == (16 // 8) * 8 * 4
        assert len(ag[6]) == 8 and len(rs[6]) == 8
        assert len(rank["rings"]) == 2


# ------------------------------------------------------------ throttle


def test_throttle_bitwise_identity_and_ledger_rows(world):
    # As the reference's test of the same name: factor 4 → 3 extra
    # rounds x 2 permutes, over both directions of the degraded edge,
    # values bitwise the clean ring's.
    for rank in world:
        assert rank["throttle_equal"] is True
        (row,) = rank["throttle_rows"]
        assert row[4] == 6 and set(row[6]) == {(0, 1), (1, 0)}
        assert row[0] == "ppermute"


def test_throttle_noop_off_edge_oversized_plan_and_no_plan(world):
    for rank in world:
        assert rank["throttle_off"] == [[], [], []]


def test_probe_flags_exactly_the_degraded_edge(world):
    # A 16x throttle of edge (0, 1): one verdict, that edge alone, by
    # the fleet-median rule (the reference's
    # test_probe_detects_injected_degraded_link). The matrix is the
    # slowest rank's time, the same on every rank.
    for rank in world:
        assert rank["probe"] == [[(0, 1, ["fleet_median"])]]


# ---------------------------------------------------------------- join


def _kernel(name, ts, dur, stream=7, device=0):
    return {"ph": "X", "cat": "kernel", "name": name, "pid": device,
            "tid": stream, "ts": ts, "dur": dur,
            "args": {"device": device, "stream": stream}}


SENDRECV = "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)"
ALLGATHER = "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)"
ALLREDUCE = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)"


def test_kind_of_event_maps_ncll_and_peer_push_names():
    assert TL.kind_of_event(SENDRECV) == "ppermute"
    assert TL.kind_of_event(ALLGATHER) == "all_gather"
    assert TL.kind_of_event(
        "ncclDevKernel_ReduceScatter_Sum_f32_RING_LL(x)") == \
        "reduce_scatter"
    assert TL.kind_of_event(ALLREDUCE) == "all_reduce"
    assert TL.kind_of_event("dma_permute_kernel(int, ...)") == "dma"
    assert TL.kind_of_event("dma_ship_push_kernel") == "dma"
    assert TL.kind_of_event("flash_fwd_kernel_wgmma") is None
    assert TL.kind_of_event("ampere_sgemm_128x64_nn") is None


def test_join_per_kind_and_per_link_by_hand():
    # Two ring hops of 1 MB over 4 ranks, each event 100 us on this
    # rank's card, and one all-gather of 64 KiB shards in 50 us.
    led = TL.CollectiveLedger()
    with TL.recording(led):
        TL.record_issue("ppermute", "d", nbytes=1_000_000, axis_size=4,
                        edges=[(0, 1), (1, 2), (2, 3), (3, 0)], count=2)
        TL.record_issue("all_gather", "d", nbytes=65536, axis_size=4)
    events = [_kernel(SENDRECV, 1000.0, 100.0),
              _kernel(ALLGATHER, 1200.0, 50.0),
              _kernel(SENDRECV, 1400.0, 100.0),
              _kernel("some_gemm", 1000.0, 500.0),
              {"ph": "X", "cat": "cpu_op", "name": SENDRECV, "ts": 0,
               "dur": 5}]
    join = TL.join_trace(led, events)
    assert not join.no_device_track and join.ragged == ()
    assert join.unmatched == {}
    pk = join.per_kind()
    assert pk["ppermute"]["events"] == 2
    assert pk["ppermute"]["wire_bytes"] == 2_000_000
    assert math.isclose(pk["ppermute"]["seconds"], 200e-6)
    assert math.isclose(pk["ppermute"]["achieved_gbps"], 80.0)
    assert math.isclose(pk["all_gather"]["achieved_gbps"],
                        3 * 65536 * 8 / 50e-6 / 1e9)
    m = join.link_matrix(4)
    assert math.isclose(m[0][1], 80.0) and math.isclose(m[3][0], 80.0)
    assert math.isnan(m[1][0]) and math.isnan(m[0][0])
    mine = join.link_matrix(4, src=2)  # the links rank 2 sends on
    assert math.isclose(mine[2][3], 80.0) and math.isnan(mine[0][1])
    merged = TL.merged_link_matrix([join.link_matrix(4, src=r)
                                    for r in range(4)])
    assert merged == m or all(
        (math.isnan(a) and math.isnan(b)) or a == b
        for ra, rb in zip(merged, m) for a, b in zip(ra, rb))


def test_join_ragged_unmatched_and_no_track():
    led = TL.CollectiveLedger()
    with TL.recording(led):
        TL.record_issue("ppermute", "d", nbytes=8, axis_size=2,
                        edges=[(0, 1), (1, 0)], count=2)
    events = [_kernel(SENDRECV, t, 10.0) for t in (0, 20, 40)] + \
        [_kernel(ALLREDUCE, 60, 10.0),
         _kernel("ncclDevKernel_Broadcast_RING_LL(x)", 80, 5.0)]
    join = TL.join_trace(led, events)
    assert join.ragged == ("ppermute",)  # 3 events over 2 entries
    assert len([j for j in join.joined if j.issue.kind == "ppermute"]) == 3
    assert join.unmatched == {
        "all_reduce": {"events": 1, "seconds": pytest.approx(10e-6)},
        "other": {"events": 1, "seconds": pytest.approx(5e-6)}}
    assert [n for n, _, _ in join.unmatched_intervals] == [
        ALLREDUCE, "ncclDevKernel_Broadcast_RING_LL(x)"]
    cpu_only = [{"ph": "X", "cat": "cpu_op", "name": "aten::add",
                 "ts": 0, "dur": 1}]
    none = TL.join_trace(led, cpu_only)
    assert none.no_device_track and none.joined == []


def test_join_shares_the_sendrecv_pool_between_permutes_and_all_to_all():
    # NCCL runs all_to_all_single as grouped send/recv: the events are
    # matched against the ppermute and all_to_all entries together, in
    # issue order, and each joined event keeps its entry's own kind.
    led = TL.CollectiveLedger()
    with TL.recording(led):
        TL.record_issue("all_to_all", "ep", nbytes=4096, axis_size=4,
                        label="moe_dispatch")
        TL.record_issue("ppermute", "pp", nbytes=128, axis_size=4,
                        edges=[(0, 1)])
        TL.record_issue("all_to_all", "ep", nbytes=4096, axis_size=4,
                        label="moe_combine")
    events = [_kernel(SENDRECV, 100.0 * i, 10.0) for i in range(6)]
    join = TL.join_trace(led, events)
    assert join.ragged == () and join.unmatched == {}
    assert [j.issue.label for j in join.joined] == [
        "moe_dispatch", "", "moe_combine"] * 2
    pk = join.per_kind()
    assert pk["all_to_all"]["events"] == 4 and pk["ppermute"]["events"] == 2
    assert pk["all_to_all"]["wire_bytes"] == 4 * (3 * 4096 // 4)


def test_kv_migrate_rows_join_their_transports_pool():
    led = TL.CollectiveLedger()
    with TL.recording(led):
        TL.record_issue("kv_migrate", "mig", nbytes=1 << 20, axis_size=2,
                        edges=[(0, 1)], label="kv_migrate:pallas_dma")
        TL.record_issue("kv_migrate", "mig", nbytes=1 << 20, axis_size=2,
                        edges=[(0, 1)], label="kv_migrate:xla")
    events = [_kernel("dma_permute_kernel", 0.0, 100.0),
              _kernel(SENDRECV, 200.0, 50.0)]
    join = TL.join_trace(led, events)
    assert [(j.issue.label, j.event_name) for j in join.joined] == [
        ("kv_migrate:pallas_dma", "dma_permute_kernel"),
        ("kv_migrate:xla", SENDRECV)]
    assert join.per_kind()["kv_migrate"]["events"] == 2


def _labelled_tick_loop_trace(tmp_path, n=4, ticks=6):
    """A recorded-once tick loop on rank 0 of a pp line of ``n``: the
    activation hop ships on the ticks of ``ship_y``, the gradient hop on
    those of ``ship_g``, and the MoE's dispatch and combine all-to-alls
    run every tick — the real issue ranges of a CPU ``torch.profiler``
    window, each with a synthetic NCCL launch inside it and its
    ``SendRecv`` kernel (what the card's window would add) → (ledger,
    events, the label each kernel was issued under)."""
    import json

    import torch

    fwd = [(i, (i + 1) % n) for i in range(n)]
    bwd = [((i + 1) % n, i) for i in range(n)]
    ship_y = [1, 1, 1, 0, 0, 0][:ticks]
    ship_g = [0, 0, 1, 1, 1, 1][:ticks]
    led = TL.CollectiveLedger()
    body = TL.ScanBody()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with TL.recording(led):
            for t in range(ticks):
                with body.site("moe"):
                    for lab in ("moe_dispatch", "moe_combine"):
                        with TL.issue("all_to_all", "ep", nbytes=4096,
                                      axis_size=n, label=lab):
                            time.sleep(1e-4)  # the launch
                if ship_y[t]:
                    with body.site("fwd"), TL.issue(
                            "ppermute", "pp", nbytes=1 << 20, axis_size=n,
                            edges=fwd, label="pp_fwd_ship"):
                        time.sleep(1e-4)
                if ship_g[t]:
                    with body.site("bwd"), TL.issue(
                            "ppermute", "pp", nbytes=1 << 20, axis_size=n,
                            edges=bwd, label="pp_bwd_ship"):
                        time.sleep(1e-4)
                # an autograd backward's hop: no issue range around it
                time.sleep(1e-4)
    path = tmp_path / "window.json"
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        host = json.load(fh)["traceEvents"]
    marks = sorted((e for e in host if e.get("cat") == "user_annotation"
                    and e["name"].startswith(TL.ISSUE_TAG)),
                   key=lambda e: e["ts"])
    events, issued = list(host), []
    for k, m in enumerate(marks):
        t = m["ts"] + m["dur"] / 2  # inside the issue range
        events.append({"ph": "X", "cat": "cuda_driver",
                       "name": "cuLaunchKernelEx", "pid": m["pid"],
                       "tid": m["tid"], "ts": t, "dur": 2.0,
                       "args": {"correlation": 10_000 + k}})
        kern = _kernel(SENDRECV, t + 5.0, 3.0)
        kern["args"]["correlation"] = 10_000 + k
        events.append(kern)
        issued.append(m["name"].split("|")[3])
    # The backward hop after the last range: launched outside every
    # issue range, so it carries no label.
    last = marks[-1]
    t = last["ts"] + last["dur"] + 50.0
    events.append({"ph": "X", "cat": "cuda_driver", "name":
                   "cuLaunchKernelEx", "pid": last["pid"],
                   "tid": last["tid"], "ts": t, "dur": 2.0,
                   "args": {"correlation": 99_999}})
    kern = _kernel(SENDRECV, t + 5.0, 3.0)
    kern["args"]["correlation"] = 99_999
    events.append(kern)
    return led, events, issued


def test_join_labels_a_recorded_once_tick_loop_beside_all_to_all(tmp_path):
    # The recorded-once loop ships on some ticks and not others, while
    # the all-to-alls run every tick: one entry a site, many events. The
    # cyclic pool match spreads the ring's events over the MoE entries
    # (ragged); the issue labels put each event on its own entry, so no
    # kind is ragged and each ring edge set carries exactly its events.
    led, events, issued = _labelled_tick_loop_trace(tmp_path)
    assert [it.label for it in led.issues] == [
        "moe_dispatch", "moe_combine", "pp_fwd_ship", "pp_bwd_ship"]
    join = TL.join_trace(led, [e for e in events
                               if e.get("args", {}).get("correlation")
                               != 99_999])
    assert join.ragged == () and join.unmatched == {}
    assert [j.issue.label for j in join.joined] == issued
    # The unlabelled backward hop joins the pool as before the labels.
    with_bwd = TL.join_trace(led, events)
    assert [j.issue.label for j in with_bwd.joined][:-1] == issued
    assert with_bwd.ragged == ("ppermute",)
    assert issued.count("pp_fwd_ship") == 3
    assert issued.count("pp_bwd_ship") == 4
    assert issued.count("moe_dispatch") == 6
    for j in join.joined:
        if j.issue.label == "pp_fwd_ship":
            assert j.issue.edges == ((0, 1), (1, 2), (2, 3), (3, 0))
        elif j.issue.label == "pp_bwd_ship":
            assert j.issue.edges == ((1, 0), (2, 1), (3, 2), (0, 3))
        else:
            assert j.issue.kind == "all_to_all" and j.issue.edges is None
    m = join.link_matrix(4, src=0)
    fwd_s = sum(j.seconds for j in join.joined
                if j.issue.label == "pp_fwd_ship")
    assert math.isclose(fwd_s, 3 * 3e-6, rel_tol=1e-3)  # 3 kernels of 3 us
    assert math.isclose(m[0][1], 3 * (1 << 20) * 8 / fwd_s / 1e9,
                        rel_tol=1e-3)  # the trace clock rounds
    assert math.isclose(m[0][3], m[0][1], rel_tol=1e-3)
    assert math.isnan(m[0][2])
    # The same kernels without their labels: the cyclic pool of before.
    from tpu_p2p_torch.utils.profiling import labelled_collective_intervals

    intervals = [(n, t0, t1) for n, t0, t1, _ in
                 labelled_collective_intervals(events)][:-1]
    cyclic = TL.join_trace(led, intervals)
    assert cyclic.ragged == ("ppermute",)
    assert [j.issue.label for j in cyclic.joined] != issued


def _labelled_backward_trace(tmp_path, n=4):
    """Two recorded-once pp programs on rank 0 of a line of ``n`` that
    ship one activation signature 6 and 7 times (as the 1F1B and
    zero-bubble steps' ``pp_bwd_ship`` do on 4 ranks), beside an
    all-to-all every tick; then autograd's backward of each: every
    forward ship's reverse hop and the all-to-all's inverse, each inside
    :func:`TL.backward_issue` of the site its forward saved. The real
    issue ranges of a CPU profiler window, each with a synthetic NCCL
    launch and ``SendRecv`` kernel inside → (ledger, events, the label
    and edges each kernel was issued under)."""
    import json

    import torch

    fwd = tuple((i, (i + 1) % n) for i in range(n))
    led = TL.CollectiveLedger()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with TL.recording(led):
            for ships in (6, 7):
                body = TL.ScanBody()
                saved = []
                for _ in range(ships):
                    with body.site("moe"), TL.issue(
                            "all_to_all", "ep", nbytes=4096, axis_size=n,
                            label="moe_dispatch"):
                        saved.append(TL.current_site())
                        time.sleep(1e-4)
                    with body.site("ship"), TL.issue(
                            "ppermute", "pp", nbytes=1 << 20, axis_size=n,
                            edges=fwd, label="pp_stage_ship"):
                        saved.append(TL.current_site())
                        time.sleep(1e-4)
                assert TL.current_site() is None
                for site in reversed(saved):  # autograd's backward
                    with TL.backward_issue(site):
                        time.sleep(1e-4)
    path = tmp_path / "window.json"
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        host = json.load(fh)["traceEvents"]
    marks = sorted((e for e in host if e.get("cat") == "user_annotation"
                    and e["name"].startswith(TL.ISSUE_TAG)),
                   key=lambda e: e["ts"])
    events, issued = list(host), []
    for k, m in enumerate(marks):
        t = m["ts"] + m["dur"] / 2
        events.append({"ph": "X", "cat": "cuda_driver",
                       "name": "cuLaunchKernelEx", "pid": m["pid"],
                       "tid": m["tid"], "ts": t, "dur": 2.0,
                       "args": {"correlation": 20_000 + k}})
        kern = _kernel(SENDRECV, t + 5.0, 3.0)
        kern["args"]["correlation"] = 20_000 + k
        events.append(kern)
        issued.append(m["name"].split("|")[3:5])
    return led, events, issued


def test_join_places_labelled_backward_hops_on_reversed_edges(tmp_path):
    # The backward's hops join by their labels: nothing ragged, although
    # the two programs' ships of one signature (6 + 7 over 2 entries)
    # would be ragged in a cyclic pool, and each backward event lands on
    # the reversed edge set; the rows and totals are the forward's.
    led, events, issued = _labelled_backward_trace(tmp_path)
    fwd = ((0, 1), (1, 2), (2, 3), (3, 0))
    rev = ((1, 0), (2, 1), (3, 2), (0, 3))
    assert [(it.kind, it.label, it.edges) for it in led.issues] == [
        ("all_to_all", "moe_dispatch", None),
        ("ppermute", "pp_stage_ship", fwd)] * 2
    assert [(it.kind, it.label, it.edges, it.count)
            for it in led.unrowed] == [
        ("ppermute", "pp_stage_ship", rev, 1),
        ("all_to_all", "moe_dispatch", None, 1)]
    plain = TL.CollectiveLedger()
    plain.issues.extend(led.issues)
    assert led.totals() == plain.totals() and len(led) == 4
    join = TL.join_trace(led, events)
    assert join.ragged == () and join.unmatched == {}
    assert len(join.joined) == len(issued) == 2 * (6 + 7) * 2
    ships = [j for j in join.joined if j.issue.label == "pp_stage_ship"]
    assert [j.issue.edges for j in ships] == [
        tuple(tuple(int(v) for v in e.split(">")) for e in edges.split(","))
        for label, edges in issued if label == "pp_stage_ship"]
    assert sum(j.issue.edges == rev for j in ships) == 13
    m = join.link_matrix(4, src=1)
    assert not math.isnan(m[1][0]) and not math.isnan(m[1][2])
    # The forward ships' signature has 13 events over its 2 entries: a
    # rule holding a labelled group to a whole multiple of its entries
    # would call it ragged, though every event's entry is known.
    sig = led.issues[1].signature
    assert sum(it.signature == sig for it in led.issues) == 2
    assert sum(j.issue.signature == sig for j in join.joined) == 13


def test_backward_hops_label_reversed_edges_and_add_no_row(world):
    got = world[0]["backward_labels"]
    # The rows are the forward-only GPipe forward's, held to the
    # reference by the capture test.
    gpipe = world[0]["workloads"]["gpipe_none"]
    assert got["rows"] == gpipe["issues"] and got["totals"] == \
        gpipe["totals"]
    ship = [r for r in got["rows"] if r[5] == "pp_stage_ship"]
    assert len(ship) == 1
    kind, axis, nbytes, _, count, label, edges = ship[0]
    rev = tuple((d, s) for s, d in edges)
    assert got["backward"] == [(kind, axis, nbytes, 1, label, rev)]
    fwd_sig = f"{TL.ISSUE_TAG}|ppermute|pp|pp_stage_ship|" + ",".join(
        f"{s}>{d}" for s, d in edges) + f"|{nbytes}"
    bwd_sig = f"{TL.ISSUE_TAG}|ppermute|pp|pp_stage_ship|" + ",".join(
        f"{s}>{d}" for s, d in rev) + f"|{nbytes}"
    hops = 2 + 8 - 2  # GPipe's ticks less the last, on 8 stages
    assert got["ranges"][fwd_sig] == got["ranges"][bwd_sig] == hops


REDUCESCATTER = "ncclDevKernel_ReduceScatter_Sum_f32_RING_LL(x)"


def _kernels_in_ranges(ranges):
    """A synthetic launch and NCCL kernel for each issue range, the kind
    of its signature, launched where the range's own code issues it: in
    the first gap after its first nested range (a sum's library call
    follows its hop), else at its middle → the events."""
    kernel = {"ppermute": SENDRECV, "all_reduce": ALLREDUCE,
              "reduce_scatter": REDUCESCATTER}
    events = list(ranges)
    for k, r in enumerate(ranges):
        end = r["ts"] + r["dur"]
        kids = sorted((c for c in ranges if c is not r
                       and r["ts"] <= c["ts"]
                       and c["ts"] + c["dur"] <= end), key=lambda c: c["ts"])
        if kids:
            lo = kids[0]["ts"] + kids[0]["dur"]
            hi = kids[1]["ts"] if len(kids) > 1 else end
        else:
            lo, hi = r["ts"], end
        t = (lo + hi) / 2
        events.append({"ph": "X", "cat": "cuda_driver",
                       "name": "cuLaunchKernelEx", "pid": r["pid"],
                       "tid": r["tid"], "ts": t, "dur": 0.0,
                       "args": {"correlation": 30_000 + k}})
        kern = _kernel(kernel[r["name"].split("|")[1]], t + 5.0, 3.0)
        kern["args"]["correlation"] = 30_000 + k
        events.append(kern)
    return events


def test_join_places_a_reordered_sums_hops_on_their_own_entry(world):
    got = world[0]["reordered_sums"]
    rank, perm = got["rank"], got["perm"]
    # The hops are no rows: the reordered line's rows and totals are the
    # rank-order line's, and only it has unrowed entries.
    assert perm["rows"] == rank["rows"] and perm["totals"] == \
        rank["totals"]
    assert [r[0] for r in rank["rows"]] == ["all_reduce", "reduce_scatter"]
    assert rank["unrowed"] == []
    swap = ((0, 0), (1, 7), (2, 6), (3, 5), (4, 4), (5, 3), (6, 2), (7, 1))
    assert perm["unrowed"] == [("ppermute", "d", 4096 * 4, 1,
                                "sum_mesh_order", swap),
                               ("ppermute", "d", 4096 * 4 // 8, 1,
                                "sum_mesh_order", swap)]
    led = TL.CollectiveLedger()
    led.issues.extend(
        TL._entry(kind, axis, nbytes=nbytes, axis_size=8, edges=edges,
                  count=count, label=label)
        for kind, axis, nbytes, _, count, label, edges in perm["rows"])
    led.unrowed.extend(
        TL._entry(kind, axis, nbytes=nbytes, axis_size=8, edges=edges,
                  label=label)
        for kind, axis, nbytes, _, label, edges in perm["unrowed"])
    ranges = sorted(got["ranges"], key=lambda r: r["ts"])
    # The window's ranges: each sum's row, the all-reduce's hop inside it
    # and the reduce-scatter's two.
    assert [r["name"].split("|")[1] for r in ranges] == [
        "all_reduce", "ppermute", "reduce_scatter", "ppermute", "ppermute"]
    join = TL.join_trace(led, _kernels_in_ranges(ranges))
    assert join.ragged == () and join.unmatched == {}
    assert [(j.issue.kind, j.issue.label, j.issue.payload_bytes)
            for j in join.joined] == [
        ("ppermute", "sum_mesh_order", 4096 * 4),
        ("all_reduce", "psum_chain", 4096 * 4),
        ("ppermute", "sum_mesh_order", 4096 * 4),
        ("reduce_scatter", "reduce_scatter", 4096 * 4),
        ("ppermute", "sum_mesh_order", 4096 * 4 // 8)]
    assert all(j.issue.edges == swap for j in join.joined
               if j.issue.kind == "ppermute")


def test_profiled_window_starts_after_the_barrier_on_every_rank(world):
    stamps = world[0]["window"]
    assert len(stamps) == 8 and all(len(s["enter"]) == 2 for s in stamps)
    # Ranks reached the window 50 ms apart; every measured part starts
    # after the last rank entered the first barrier, and every window
    # closes after the last measured part ended.
    last_in = max(s["enter"][0] for s in stamps)
    assert all(s["start"] >= last_in for s in stamps)
    assert max(s["enter"][0] for s in stamps) - \
        min(s["enter"][0] for s in stamps) > 0.3
    last_end = max(s["end"] for s in stamps)
    assert all(s["after"] >= last_end for s in stamps)
    assert all(s["enter"][1] >= s["end"] for s in stamps)


def test_issue_markers_only_while_profiling_and_in_muted_repeats():
    import torch

    led = TL.CollectiveLedger()
    body = TL.ScanBody()
    with TL.recording(led):
        for _ in range(3):
            with body.site("ship"), TL.issue(
                    "dma", "pp", nbytes=64, axis_size=2, edges=[(0, 1)],
                    label="pp_fwd_ship"):
                pass
    assert len(led) == 1  # recorded once, no profiler: no range
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with TL.recording(led):
            for _ in range(3):
                with body.site("ship"), TL.issue(  # muted repeats label
                        "dma", "pp", nbytes=64, axis_size=2,
                        edges=[(0, 1)], label="pp_fwd_ship"):
                    pass
    names = [e.name for e in prof.events()
             if e.name.startswith(TL.ISSUE_TAG)]
    assert names == [led.issues[0].signature] * 3
    assert len(led) == 1
    assert led.issues[0].signature == \
        "tp_p2p_issue|dma|pp|pp_fwd_ship|0>1|64"


def test_print_report_renders_the_matrices_with_a_track(capsys):
    led = TL.CollectiveLedger()
    with TL.recording(led):
        TL.record_issue("ppermute", "d", nbytes=1_000_000, axis_size=2,
                        edges=[(0, 1), (1, 0)])
        TL.record_issue("dma", "d", nbytes=1_000_000, axis_size=2,
                        edges=[(0, 1), (1, 0)])
    join = TL.join_trace(led, [_kernel(SENDRECV, 0.0, 100.0),
                               _kernel("dma_permute_kernel", 200, 50.0)])
    TL.print_report(led, join, n=2, host_only=True)
    out = capsys.readouterr().out
    assert "Evaluating the Ledger-Joined GPU P2P Achieved Bandwidth" in out
    assert "Evaluating the Ledger-Joined Pallas-DMA P2P Achieved" in out
    assert "  80.00 " in out and " 160.00 " in out
    assert "# host-only:" in out and "# time-sliced:" in out


# --------------------------------------------------------- serving rows


def test_serve_ledger_row_follows_the_summary():
    # Colocated serving on one rank records no collective: the receipt
    # is a zero-issue row after the summary, as the reference's.
    from tpu_p2p import config as JC
    from tpu_p2p.models import flagship as JF
    from tpu_p2p.serve import engine as JE
    from tpu_p2p_torch import config as TC
    from tpu_p2p_torch.models import flagship as TF
    from tpu_p2p_torch.serve import engine as TE

    kw = dict(slots=2, page_len=8, num_pages=12, max_blocks=3, chunk=4,
              requests=3, seed=0, rate=1.0, prompt_len=(4, 8),
              gen_len=(2, 4), vocab=64)
    jsc, tsc = JC.ServeConfig(**kw), TC.ServeConfig(**kw)
    jcfg, tcfg = JE._engine_model(jsc), TE._engine_model(tsc)
    mesh = JE.serve_mesh(1)
    j_params = JF.init_flagship_params(jcfg)
    t_params = TF.params_from_numpy(
        {k: np.asarray(v) for k, v in j_params.items()}, "cpu")
    j_recs, t_recs = [], []
    JE.run_engine(mesh, jcfg, JF.place_flagship_params(j_params, mesh),
                  JE.synthetic_trace(jsc), sc=jsc, emit=j_recs.append,
                  ledger=JL.CollectiveLedger())
    TE.run_engine(TE.serve_mesh(1, ["cpu"]), tcfg, t_params,
                  TE.synthetic_trace(tsc), sc=tsc, emit=t_recs.append,
                  ledger=TL.CollectiveLedger())
    assert [r["obs"] for r in t_recs] == [r["obs"] for r in j_recs]
    assert t_recs[-1] == j_recs[-1] == {"obs": "serve_ledger",
                                        "issues": 0, "totals": {}}


def test_disagg_migration_records_kv_migrate_rows():
    # The migration ships record as kind="kv_migrate", labelled with
    # their transport, one program a (pages, destination): the
    # reference's rows on the same trace over 1 prefill + 3 decode
    # ranks.
    import jax as _jax

    from test_torch_disagg import _cfg_kw, _engine_kw
    from tpu_p2p.config import ServeConfig as JServeConfig
    from tpu_p2p.models import flagship as JF
    from tpu_p2p.serve import disagg as JD
    from tpu_p2p.serve import engine as JE
    from tpu_p2p_torch.config import ServeConfig as TServeConfig
    from tpu_p2p_torch.models import flagship as TF
    from tpu_p2p_torch.serve import disagg as TD
    from tpu_p2p_torch.serve import engine as TE

    n_dec, kw = _engine_kw("1+3")
    cfg = JF.FlagshipConfig(**_cfg_kw())
    seeded = JF.init_flagship_params(cfg)
    sc = JServeConfig(**kw)
    pre, dec, mig = JD.build_disagg_meshes(
        1, devices=_jax.devices()[:1 + n_dec])
    j_led = JL.CollectiveLedger()
    JD.run_disagg_engine(pre, dec, mig, cfg,
                         JF.place_flagship_params(seeded, pre),
                         JF.place_flagship_params(seeded, dec),
                         JE.synthetic_trace(sc), sc=sc, ledger=j_led)
    tsc = TServeConfig(**kw)
    _, _, tmig = TD.build_disagg_meshes(1, ["cpu"] * (1 + n_dec))
    t_led = TL.CollectiveLedger()
    recs = []
    TD.run_disagg_engine(tmig, TF.FlagshipConfig(**_cfg_kw()),
                         TF.params_from_numpy({k: np.asarray(v) for k, v
                                               in seeded.items()}, "cpu"),
                         TE.synthetic_trace(tsc), sc=tsc,
                         emit=recs.append, ledger=t_led)

    def rows(led):
        return sorted((it.kind, it.axis, it.payload_bytes, it.count,
                       it.label, it.edges) for it in led.issues
                      if it.kind == "kv_migrate")

    assert rows(t_led) and rows(t_led) == rows(j_led)
    assert {it.label for it in t_led.issues
            if it.kind == "kv_migrate"} == {"kv_migrate:xla"}
    assert recs[-1]["obs"] == "serve_ledger"
    assert recs[-1]["totals"]["kv_migrate/mig"] == \
        TL.totals_record(t_led)["totals"]["kv_migrate/mig"]
