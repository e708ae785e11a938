"""Rank-side cases of the port's obs-layer tests — this file imports
torch and the port only, never JAX.

Each case runs on every rank of a spawned gloo world
(``tpu_p2p_torch.parallel.launch.run_world(n, "<this file>:<case>",
kwargs)``) and returns what the parent compares with the JAX reference
it ran on its CPU mesh.
"""

import collections
import json
import os
import tempfile
import time

import torch

from tpu_p2p_torch.obs import faults as TFaults
from tpu_p2p_torch.obs import health as TH
from tpu_p2p_torch.obs import ledger as TL
from tpu_p2p_torch.parallel import collectives as TC
from tpu_p2p_torch.parallel.runtime import make_runtime


def _issues(led):
    return [(it.kind, it.axis, it.payload_bytes, it.wire_bytes, it.count,
             it.label, it.edges) for it in led.issues]


def _totals(led):
    return {f"{k}/{a}": v for (k, a), v in sorted(led.totals().items())}


def _backward_labels(rt):
    """A GPipe step through the tick IR on the world's pp line, whose
    backward is autograd's (each stage hop's reverse hop): recorded once,
    then again in a CPU profiler window → its rows, its backward entries
    and the count of each issue range's label in the window."""
    from tpu_p2p_torch.models import pipeline as PL
    from tpu_p2p_torch.models import schedule as SCH

    n = rt.world
    pp = rt.axis_mesh((n,), ("pp",))
    cfg = PL.PipelineConfig(d_model=8, d_ff=16, stages=n, microbatches=2)
    params = PL.place_pipeline_params(PL.init_pipeline_params(cfg), pp,
                                      device=pp.device)
    x = torch.zeros((2, 4, 8), dtype=torch.float32)
    step = SCH.make_tick_train_step(pp, cfg, SCH.compile_gpipe(2, n))

    def run():
        step({k: v.clone() for k, v in params.items()}, x,
             torch.ones_like(x))

    with TL.recording() as led:
        run()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with TL.recording():
            run()
    names = collections.Counter(e.name for e in prof.events()
                                if e.name.startswith(TL.ISSUE_TAG))
    return {"rows": _issues(led), "totals": _totals(led),
            "backward": [(it.kind, it.axis, it.payload_bytes, it.count,
                          it.label, it.edges) for it in led.unrowed],
            "ranges": dict(names)}


def _reordered_sums(rt):
    """The ``CollectiveCache``'s all-reduce and reduce-scatter of one
    seeded float32 operand on the world's 1-D line in rank order and over
    the permutation ``0, n-1, ..., 1`` (there each sum takes a mesh-order
    hop first, the reduce-scatter a second one after), each recorded once
    → per arm its rows, totals and unrowed entries; then the permuted
    arm again in a CPU profiler window, whose issue ranges on this rank's
    host track are returned too (``ranges``: name, start, duration,
    process, thread)."""
    import numpy as np

    n = rt.world
    x = torch.from_numpy(np.random.default_rng(23).standard_normal(
        (n, 1, 4096)).astype(np.float32)[rt.rank])
    out = {}
    for arm, ranks in (("rank", None),
                       ("perm", (0,) + tuple(range(n - 1, 0, -1)))):
        mesh = rt.axis_mesh((n,), ("d",), ranks=ranks)
        cache = TC.CollectiveCache()
        fns = (cache.all_reduce(mesh, "d"), cache.reduce_scatter(mesh, "d"))
        with TL.recording() as led:
            for fn in fns:
                fn(x)
        out[arm] = {"rows": _issues(led), "totals": _totals(led),
                    "unrowed": [(it.kind, it.axis, it.payload_bytes,
                                 it.count, it.label, it.edges)
                                for it in led.unrowed]}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with TL.recording():
            for fn in fns:
                fn(x)
    with tempfile.TemporaryDirectory(prefix="obs_sums_") as td:
        path = os.path.join(td, "window.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            host = json.load(fh)["traceEvents"]
    out["ranges"] = [{k: e[k] for k in ("name", "ts", "dur", "pid", "tid",
                                        "cat")}
                     for e in host if e.get("cat") == "user_annotation"
                     and str(e.get("name", "")).startswith(TL.ISSUE_TAG)]
    return out


def _aligned_window(rt):
    """``profile_window`` with the mesh's barrier, the ranks reaching it
    50 ms apart → every rank's stamps: when it entered each barrier, when
    its measured part started and ended, and when the window returned."""
    from tpu_p2p_torch.utils.profiling import profile_window

    stamps = {"enter": []}

    def barrier():
        stamps["enter"].append(time.time())
        rt.mesh.barrier()

    def work():
        stamps["start"] = time.time()
        time.sleep(0.01)
        stamps["end"] = time.time()

    rt.mesh.barrier()
    time.sleep(0.05 * rt.rank)
    with tempfile.TemporaryDirectory(prefix="obs_window_") as td:
        profile_window(work, td, barrier=barrier)
    stamps["after"] = time.time()
    return rt.gather(stamps)


def ledger_case(msg_bytes, count):
    """The ledger and the link throttle on a world of 8: each capture
    workload recorded alone (issues and totals), the whole capture, the
    warm program, the bucketed and FSDP gathers, the ring
    collective-matmuls, the throttle's rows and values, the probe
    under a 16x degraded edge, a GPipe step's labelled backward hops,
    the sums of a reordered line with their mesh-order hops and the
    profiled window's barriers."""
    from tpu_p2p_torch.parallel import fsdp

    rt = make_runtime(device="cpu")
    n, rank = rt.world, rt.rank
    out = {"workloads": {}}
    runs = TL.capture_workloads(rt, msg_bytes, count)
    for name, run in runs.items():
        with TL.recording() as led:
            run()
        out["workloads"][name] = {"issues": _issues(led),
                                  "totals": _totals(led)}
    with TL.recording() as warm:  # every program is warm now
        for run in runs.values():
            run()
    out["warm_issues"] = len(warm)
    cap = TL.live_capture(rt, msg_bytes=msg_bytes, count=count)
    out["capture_totals"] = _totals(cap.ledger)
    out["capture_no_track"] = cap.join.no_device_track

    line = rt.mesh
    a = torch.zeros((16, 4), dtype=torch.float32)[2 * rank:2 * rank + 2]
    b = torch.zeros((8,), dtype=torch.float32)[rank:rank + 1]
    with TL.recording() as led:
        TC.bucketed_all_gather({"a": (a, 0), "b": (b, 0)}, line)
    out["bucketed"] = _issues(led)
    w = torch.ones((16, 2), dtype=torch.float32)[2 * rank:2 * rank + 2]
    with TL.recording() as led:
        fsdp.all_gather_params({"w": w, "r": torch.ones(3)}, line,
                               {"w": 0, "r": None})
    out["fsdp"] = _issues(led)
    k = 8
    eye = torch.eye(k)
    x = torch.zeros((16, k))[2 * rank:2 * rank + 2]
    with TL.recording() as led:
        full = TC.ring_allgather_matmul(lambda c, _s: c @ eye, x, line, 0)
        TC.matmul_ring_reducescatter(lambda c, _s: c @ eye, full, line, 0)
    out["rings"] = _issues(led)

    # The throttle: bitwise identity, rows only on the degraded edge.
    payload = TC.make_payload(line, 512)
    edges = TC.ring_edges(n)
    clean = TC.axis_ppermute(payload, line, edges, label="throttle_test")
    plan = TFaults.FaultPlan(degrade_edge=(0, 1), degrade_factor=4)
    with TFaults.injecting(plan), TL.recording() as led:
        throttled = TC.axis_ppermute(payload, line, edges,
                                     label="throttle_test")
    out["throttle_equal"] = bool(torch.equal(clean, throttled))
    out["throttle_rows"] = [r for r in _issues(led)
                            if r[5] == "fault_throttle"]
    off = []
    for plan in (TFaults.FaultPlan(degrade_edge=(0, 1)),
                 TFaults.FaultPlan(degrade_edge=(8, 9))):
        with TFaults.injecting(plan), TL.recording() as led:
            TC.axis_ppermute(payload, line, ((2, 5),),
                             label="throttle_test")
        off.append([r for r in _issues(led) if r[5] == "fault_throttle"])
    with TL.recording() as led:
        TC.axis_ppermute(payload, line, edges, label="throttle_test")
    off.append([r for r in _issues(led) if r[5] == "fault_throttle"])
    out["throttle_off"] = off

    plan = TFaults.FaultPlan(degrade_edge=(0, 1), degrade_factor=16)
    with TFaults.injecting(plan):
        # The probe's own message and hops; five repeats, so a rank's
        # scheduling hiccup on a loaded host is not the best time of a
        # link.
        mat = TH.probe_link_matrix(line, repeats=5)
    vs = TH.HealthMonitor().observe_link_matrix(1, mat)
    out["probe"] = [[(f["src"], f["dst"], f["reasons"])
                     for f in v.detail["links"]] for v in vs]
    out["backward_labels"] = _backward_labels(rt)
    out["reordered_sums"] = _reordered_sums(rt)
    out["window"] = _aligned_window(rt)
    rt.close()
    return out


def _records(path):
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def train_case(cfg_kw, steps, start, slow_ms, trace_dir):
    """The training loop with the obs stream on a world of 4 (dp 2 x sp
    2): a clean run (the stream and the losses), the lost host healed
    onto 2 ranks, the uninterrupted twin, and rank 1 straggling from
    ``start`` on. → the first rank's streams and summaries."""
    from tpu_p2p_torch.models import flagship as F
    from tpu_p2p_torch.train import run_training, run_training_with_heal

    rt = make_runtime(device="cpu")
    mesh = F.build_mesh(rt.world, runtime=rt)
    cfg = F.FlagshipConfig(**cfg_kw)
    first = rt.rank == 0
    td = rt.broadcast(tempfile.mkdtemp(dir=trace_dir) if first else None,
                      0)
    common = dict(steps=steps, lr=1e-2, log_every=0, mesh=mesh)
    out = {}
    path = os.path.join(td, "clean.jsonl")
    s = run_training(cfg, obs_jsonl=path, **common)
    out["clean"] = {"final_loss": s["final_loss"],
                    "records": _records(path) if first else None}
    path = os.path.join(td, "heal.jsonl")
    s = run_training_with_heal(
        cfg, ckpt_dir=os.path.join(td, "ck"), ckpt_every=2,
        obs_jsonl=path,
        fault_plan=TFaults.FaultPlan(lost_host=rt.world - 1,
                                     start_step=start), **common)
    healed_mesh = s.pop("mesh")
    out["heal"] = {"final_loss": s["final_loss"], "heal": s["heal"],
                   "in_new_mesh": healed_mesh is not None,
                   "records": _records(path) if first else None}
    rt.barrier()
    path = os.path.join(td, "slow.jsonl")
    run_training(cfg, obs_jsonl=path, fault_plan=TFaults.FaultPlan(
        slow_rank=1, slow_ms=slow_ms, start_step=start), **common)
    out["slow"] = {"records": _records(path) if first else None}
    rt.close()
    return out
