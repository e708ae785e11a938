"""Rank-side cases of the port's topology tests — this file imports
torch, numpy and the port only, never JAX.

``topo_case`` runs on every rank of a spawned gloo world of 8
(``tpu_p2p_torch.parallel.launch.run_world(8, "<this file>:topo_case",
kwargs)``) and returns, on rank 0, what the parent holds against the JAX
reference: the throttled probe on the first 4 ranks, one flagship SGD
step per mesh shape on the rank-order mesh and on a reordered one, the
pipeline step on ``make_runtime``'s ring-ordered world and on the
rank-order world, the ranks ``make_runtime`` lays out, the library
collectives, the reduction patterns and the obs live capture on a
ring-ordered world and in rank order, and the smoke's ring parity pins.
"""

import io

import numpy as np
import torch

from tpu_p2p_torch.models import flagship as F
from tpu_p2p_torch.models import pipeline as PIPE
from tpu_p2p_torch.models import pipeline_interleaved as IL
from tpu_p2p_torch.parallel.runtime import local_shard, make_runtime
from tpu_p2p_torch.topo import place as PL
from tpu_p2p_torch.topo.model import Topology


def _probe(rt, probe_kw):
    """The throttled probe on the 4-rank submesh (every rank makes the
    submesh; its members probe) → the matrix (members), None elsewhere."""
    from tpu_p2p_torch.obs import faults
    from tpu_p2p_torch.obs.health import probe_link_matrix
    from tpu_p2p_torch.parallel import collectives as C

    mesh = rt.submesh(tuple(range(4)))
    if not mesh.is_member:
        return None
    edges = list(C.ring_edges(4)) + [(0, 2), (0, 3), (1, 3)]
    plan = faults.FaultPlan(degrade_edge=(1, 2), degrade_factor=16)
    with faults.injecting(plan):
        return probe_link_matrix(mesh, edges=edges, **probe_kw)


def _flagship_step(rt, case, ranks):
    """One flagship SGD step on the mesh of ``case["dims"]`` laid over
    ``ranks`` (mesh position → global rank) → (loss, rank 0's gathered
    params as numpy, else None)."""
    mesh = rt.axis_mesh(case["dims"], F.AXES, ranks=ranks)
    cfg = F.FlagshipConfig(**case["cfg"])
    params = F.place_flagship_params(
        {k: torch.from_numpy(v) for k, v in case["params"].items()},
        mesh, cfg)
    spec = F.flagship_data_spec(mesh)
    x, t = (torch.from_numpy(np.ascontiguousarray(
        local_shard(a, mesh, spec[:a.ndim]))) for a in case["batch"])
    new, loss = F.make_flagship_train_step(cfg, lr=1e-2, mesh=mesh)(
        params, x, t)
    full = F.gather_flagship_params(new, mesh, cfg)
    return float(loss), ({k: v.numpy() for k, v in full.items()}
                         if mesh.rank == 0 else None)


def _pipeline_step(rt, problem):
    cfg = PIPE.PipelineConfig(**problem["cfg"])
    params = {k: torch.from_numpy(v) for k, v in problem["params"].items()}
    x, target = (torch.from_numpy(a) for a in problem["batch"])
    placed = PIPE.place_pipeline_params(params, rt.mesh)
    new, loss = PIPE.make_pipeline_train_step(rt.mesh, cfg, lr=5e-2)(
        placed, x, target)
    return float(loss), IL.unplace_interleaved_params(new, rt.mesh, 1)


def _reductions(rt, msg_bytes):
    """Every ``CollectiveCache`` reduction, the module-level ``psum`` and
    the all-to-all on ``rt``'s mesh, each held to its host oracle on this
    rank's row; the reduction and all-to-all patterns under ``--check``
    in both timed modes (each raises on a wrong row); the obs live
    capture → (this rank's verdicts, the patterns' printed lines, the
    capture's ledger totals)."""
    import contextlib

    from tpu_p2p_torch.cli import run_benchmark
    from tpu_p2p_torch.config import BenchConfig
    from tpu_p2p_torch.obs import ledger as TL
    from tpu_p2p_torch.parallel import collectives as C

    mesh, n = rt.mesh, rt.world
    cache = C.CollectiveCache()
    x = C.make_payload(mesh, msg_bytes)
    host = C.host_payload(mesh, msg_bytes)
    ar = C.expected_all_reduce
    ag = C.expected_all_gather(host)
    cases = {
        "all_reduce": (cache.all_reduce(mesh, "d"), ar(host)),
        "psum_chain": (cache.psum_chain(mesh, "d", 3), ar(ar(ar(host)))),
        "all_gather": (cache.all_gather(mesh, "d"), ag),
        "ag_chain": (cache.ag_chain(mesh, "d", 2),
                     C.expected_all_gather(ag)),
        "reduce_scatter": (cache.reduce_scatter(mesh, "d"),
                           C.expected_reduce_scatter(host)),
        "rs_ag_chain": (cache.rs_ag_chain(mesh, "d", 2), ar(ar(host))),
        "all_to_all": (cache.all_to_all(mesh, "d"),
                       C.expected_all_to_all(host, n)),
        "psum": (lambda v: C.psum(v, mesh), ar(host)),
    }
    verdicts = {k: C.verify_against(fn(x), want, mesh)
                for k, (fn, want) in cases.items()}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        for pattern in ("allreduce", "reduce_scatter", "all_gather",
                        "all_to_all"):
            for mode in ("serialized", "fused"):
                run_benchmark(rt, BenchConfig(
                    pattern=pattern, msg_size=msg_bytes, iters=2,
                    mode=mode, check=True))
    cap = TL.live_capture(rt, msg_bytes=msg_bytes, count=2)
    totals = {f"{k}/{a}": v
              for (k, a), v in sorted(cap.ledger.totals().items())}
    return verdicts, buf.getvalue(), totals


def topo_case(flagship_cases, pipeline_problem, probe_kw):
    """Every rank: the cases of the module docstring → on rank 0 a dict
    of their results; None elsewhere."""
    from tpu_p2p_torch.topo.smoke import _ring_parity

    rt = make_runtime(device="cpu", apply_ring_order=False)
    first = rt.rank == 0
    out = {"probe": _probe(rt, probe_kw)}

    # One flagship step a shape, on the rank-order mesh and reordered;
    # a 4-rank shape runs on the first 4 ranks alone.
    r4 = rt.restrict(range(4)) if rt.rank < 4 else None
    steps = {}
    for case in flagship_cases:
        n = int(np.prod(case["dims"]))
        world = rt if n == rt.world else r4
        if world is None:
            continue
        order = tuple(reversed(range(n)))
        steps[case["name"]] = {
            "naive": _flagship_step(world, case, tuple(range(n))),
            "topo": _flagship_step(world, case, order)}
    out["flagship"] = steps
    rt.barrier()

    # make_runtime threads the ring order through its 1-D world.
    t = Topology.preset_uniform(8, 100.0)
    t.gbps[3][4] = 1.0
    rt_topo = make_runtime(device="cpu", axis_names=("pp",),
                           ring_topology=t)
    rt_raw = make_runtime(device="cpu", axis_names=("pp",),
                          apply_ring_order=False)
    out["runtime"] = {
        "order": PL.ring_order(t),
        "topo_ranks": rt_topo.mesh.ranks,
        "raw_ranks": rt_raw.mesh.ranks,
        "topo": _pipeline_step(rt_topo, pipeline_problem),
        "raw": _pipeline_step(rt_raw, pipeline_problem),
        "two_d": make_runtime(device="cpu", mesh_shape=(4, 2),
                              axis_names=("x", "y"),
                              ring_topology=t).mesh.ranks,
        "mismatch": make_runtime(
            device="cpu", ring_topology=Topology.preset_uniform(4)
        ).mesh.ranks,
        "default": make_runtime(device="cpu").mesh.ranks,
        "history": make_runtime(device="cpu",
                                ring_topology="history").mesh.ranks,
    }

    # The library collectives on a reordered 1-D world and in rank order.
    rt_d = make_runtime(device="cpu", ring_topology=t)
    red = {"ranks": rt_d.mesh.ranks}
    for name, world in (("topo", rt_d), ("raw", rt)):
        verdicts, text, totals = _reductions(world, 1024)
        red[name] = {"verdicts": rt.gather(verdicts), "text": text,
                     "totals": totals}
    out["reductions"] = red

    # The smoke's ring parity pins, both transports.
    log = io.StringIO()
    parity = {}
    for transport in ("xla", "pallas_dma"):
        parity[transport] = [
            _ring_parity(rt, (0, 3, 1, 5, 2, 7, 4, 6), transport, log,
                         first),
            _ring_parity(rt, PL.ring_order(Topology.preset_uniform(8)),
                         transport, log, first)]
    out["parity"] = parity
    out["parity_log"] = log.getvalue()
    rt.close()
    return out if first else None
