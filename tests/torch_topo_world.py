"""Rank-side cases of the port's topology tests — this file imports
torch, numpy and the port only, never JAX.

``topo_case`` runs on every rank of a spawned gloo world of 8
(``tpu_p2p_torch.parallel.launch.run_world(8, "<this file>:topo_case",
kwargs)``) and returns, on rank 0, what the parent holds against the JAX
reference: the throttled probe on the first 4 ranks, one flagship SGD
step per mesh shape on the rank-order mesh and on a reordered one, the
pipeline step on ``make_runtime``'s ring-ordered world and on the
rank-order world, the ranks ``make_runtime`` lays out (with no argument,
in a directory that holds a link history), the library collectives, the
reduction patterns and the obs live capture on a ring-ordered world and
in rank order, every library sum site on seeded float32 operands over
reordered and rank-order meshes with the mesh-order hops counted, and
the smoke's ring parity pins.
"""

import io
import os

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


# The meshes of the sum sites: a 1-D world of 8 and a 2 x 4 mesh, each
# in rank order and over a permutation of the ranks.
SUM_MESHES = {"d8": ((8,), ("d",), (0, 3, 1, 5, 2, 7, 4, 6)),
              "x2y4": ((2, 4), ("x", "y"), tuple(reversed(range(8))))}
SUM_ELEMS = 4096


def _sum_sites(m, axis, full):
    """Every library sum site of the port on the process mesh ``m`` (a
    line ``axis`` of a mesh, or a plane), each on seeded float32 operands
    chosen by this rank's position in the parent mesh (``full[p]``, so a
    reordered mesh sums the same logical operands) → {site: numpy}."""
    from tpu_p2p_torch.models import schedule as SCH
    from tpu_p2p_torch.parallel import collectives as C

    def x(k):
        return torch.from_numpy(full[k]).reshape(1, -1).clone()

    n = m.size
    out = {}
    out["psum"] = C.psum(x(0), m)
    out["psum_inplace"] = C.psum(x(1), m, inplace=True)
    out["reduce_scatter"] = C.reduce_scatter(x(0), m)
    out["psum_join"] = C.psum_join(x(2), m)
    leaf = x(3).requires_grad_(True)
    C.psum_conjugate(leaf, m).backward(x(4))
    out["psum_conjugate_bwd"] = leaf.grad
    flat = [x(0)[:, :1000].clone(), x(1)[:, 1000:].clone()]
    C.all_reduce_flat(flat, m, "the sum sites")
    out["all_reduce_flat"] = torch.cat(flat, dim=1)
    shard = torch.from_numpy(full[5][:SUM_ELEMS // n]).reshape(8, -1) \
        .clone().requires_grad_(True)
    whole = C.bucketed_all_gather({"w": (shard, 0)}, m)["w"]
    whole.backward(torch.from_numpy(full[6]).reshape(whole.shape))
    out["bucket_gather_bwd"] = shard.grad
    out["host_sum"] = SCH._HostSum.apply(x(7), m)
    if axis is not None:  # the CollectiveCache chains along an axis
        cache = C.CollectiveCache()
        out["cache_all_reduce"] = cache.all_reduce(m, axis)(x(0))
        out["cache_psum_chain"] = cache.psum_chain(m, axis, 2)(x(1))
        out["cache_reduce_scatter"] = cache.reduce_scatter(m, axis)(x(2))
        out["cache_rs_ag_chain"] = cache.rs_ag_chain(m, axis, 2)(x(3))
    return {k: v.detach().numpy().copy() for k, v in out.items()}


def _sums(rt, seed):
    """The sum sites over each mesh of :data:`SUM_MESHES`, in rank order
    (``rank``) and over the permutation (``perm``): every line of size >
    1 and the whole mesh as a plane, this rank's results keyed by its
    parent-mesh position, gathered (``sites``); the hops of the
    mesh-order sum a view, counted by a wrapper around
    ``collectives.ppermute`` (``hops``); and one set of operands summed
    on the permuted 1-D world by the library alone (``raw``: what the sum
    would be without the hop), by ``psum`` (``psum``) and by the library
    in rank order (``ref``)."""
    import torch.distributed as dist

    from tpu_p2p_torch.parallel import collectives as C

    real = C.ppermute
    hops = {}
    out = {}
    for name, (dims, axes, perm) in SUM_MESHES.items():
        for arm, ranks in (("rank", None), ("perm", perm)):
            mesh = rt.axis_mesh(dims, axes, ranks=ranks)
            full = np.random.default_rng(seed).standard_normal(
                (8, 8, SUM_ELEMS)).astype(np.float32)[:, mesh.index]
            views = [(a, mesh.line(a)) for a, d in zip(axes, dims) if d > 1]
            if len(dims) > 1:
                views.append((None, mesh.plane(axes)))
            for a, m in views:
                key = (name, arm, a or "+".join(axes))
                count = [0]

                def counted(*args, _count=count, **kw):
                    _count[0] += 1
                    return real(*args, **kw)

                C.ppermute = counted
                try:
                    got = _sum_sites(m, a, full)
                finally:
                    C.ppermute = real
                hops[key] = count[0]
                out[key] = (mesh.index, got)
    ops = np.random.default_rng(seed).standard_normal(
        (8, SUM_ELEMS)).astype(np.float32)
    perm = rt.axis_mesh((8,), ("d",), ranks=SUM_MESHES["d8"][2])
    plain = rt.axis_mesh((8,), ("d",))
    raw = torch.from_numpy(ops[perm.index].copy())
    dist.all_reduce(raw, group=perm.host_group)
    ref = torch.from_numpy(ops[plain.index].copy())
    dist.all_reduce(ref, group=plain.host_group)
    return {"sites": rt.gather(out), "hops": hops,
            "raw": raw.numpy(), "ref": ref.numpy(),
            "psum": C.psum(torch.from_numpy(ops[perm.index].copy()),
                           perm).numpy()}


def _default_runtime(history_dir):
    """``make_runtime()`` with no argument, run in ``history_dir`` (a
    ``MULTICHIP_r*.json`` the port's writer made) → its mesh's ranks."""
    here = os.getcwd()
    os.chdir(history_dir)
    try:
        return make_runtime(device="cpu").mesh.ranks
    finally:
        os.chdir(here)


def topo_case(flagship_cases, pipeline_problem, probe_kw, history_dir):
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
        "default": _default_runtime(history_dir),
        "default_here": make_runtime(device="cpu").mesh.ranks,
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

    # Every library sum site, reordered and in rank order.
    out["sums"] = _sums(rt, 23)

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
