"""The injected-throttle topology smoke — the port of
``tpu_p2p/topo/smoke.py``, run by every rank of a world of processes.

Optimizers are graded, not trusted. The smoke makes the whole topology
subsystem gradeable on a world of CPU ranks (gloo) or of ranks on cards:

1. **Inject** a deterministic :class:`~tpu_p2p_torch.obs.faults.
   FaultPlan` link throttle on the edge ``(n_prefill-1, n_prefill)`` —
   BOTH a shift-by-1 ring edge and a prefill→decode migration edge of
   the disagg split, so one fault grades both optimizers.
2. **Probe** every edge the consumers route over (the ring ∪ the
   prefill×decode bipartite set) under the plan
   (:func:`~tpu_p2p_torch.obs.health.probe_link_matrix` issues its
   chains inside the plan, so the throttle is visible) and build the
   :class:`~tpu_p2p_torch.topo.model.Topology`, feeding
   :func:`~tpu_p2p_torch.obs.health.detect_degraded_links` verdicts in
   as degraded marks.
3. **Route**: the ring-order optimizer must route the cycle around the
   degraded edge and beat the naive (rank-order) ring's predicted
   bottleneck (``topo_route_gain = optimized min-link / naive min-link >
   1``); the migration placer must keep every migration off the decode
   shard behind the degraded link while free-pages-first lands at least
   one there, and beat its predicted migration bandwidth
   (``topo_migrate_gbps_gain > 1``) — in the dry scheduler
   (:func:`~tpu_p2p_torch.serve.disagg.simulate_disagg_schedule`).
4. **Pin parity**: re-placement never changes computed values — a
   chunked-wave ship + ``ring_allgather_matmul`` run BITWISE identical on
   the rank-order mesh and on the mesh laid over the recommended order
   (a relabelling of which rank holds which position, never a program
   change), and (``engine_parity``) the first rank's disagg engine, on
   in-process ranks of its own device, gives bitwise the same token
   streams under the topo policy as under free-pages-first, its
   migration events equal to the dry twin's.

On ranks that share a card the probe's Gbps are time-sliced host
timings, not link numbers; the grades hold all the same (the throttle is
a ×``degrade_factor`` in the issued hops). Needs >= 3 ranks.
"""

from __future__ import annotations

import sys
from typing import Optional

__all__ = ["run_smoke", "DEGENERATE_REASON"]


def DEGENERATE_REASON(n: int) -> str:
    """Why placement cannot be graded on an ``n``-device mesh — ONE
    wording, shared by the smoke and the CLI."""
    return (
        f"placement is degenerate on {n} device(s): a ring needs >= 3 "
        "devices for a second cycle to exist and the disagg split "
        "needs >= 2 decode shards to choose between"
    )


def _smoke_serve_shapes(n_prefill: int, n_decode: int):
    """The tiny disagg serving shape the migration half grades on (the
    reference's): 2 decode slots per shard, ample pages, 6 staggered
    requests."""
    from tpu_p2p_torch.config import ServeConfig

    slots = 2 * n_decode
    max_blocks = 3
    return ServeConfig(
        slots=slots, page_len=8,
        num_pages=n_decode * (slots // n_decode * max_blocks + 1),
        max_blocks=max_blocks, chunk=4, requests=6, seed=0, rate=1.0,
        prompt_len=(4, 12), gen_len=(4, 8), vocab=64, disagg=True,
        prefill_tp=n_prefill, prefill_slots=2,
        prefill_pages=(2 + slots) * max_blocks + 1,
    )


def _smoke_model_cfg(n_prefill: int, sc):
    """A tiny flagship model whose KV heads divide the prefill tp (GQA
    2:1, dense-safe experts)."""
    from tpu_p2p_torch.models import flagship as F

    kv = max(2, n_prefill)
    return F.FlagshipConfig(
        batch=4, seq=16, heads=2 * kv, kv_heads=kv, head_dim=8,
        stages=2, microbatches=1, num_experts=2, capacity_factor=2.0,
        vocab=sc.vocab, norm=True, rope=True,
    )


def _ring_outputs(mesh, transport: str) -> tuple:
    """One chunked-wave ship + one ``ring_allgather_matmul`` consume of
    this rank's position's rows of one fixed global array on ``mesh`` →
    every position's outputs as host arrays, in position order (the same
    on every rank)."""
    import numpy as np
    import torch

    from tpu_p2p_torch.parallel import collectives as C

    n, i = mesh.size, mesh.index
    xg = np.arange(n * 8 * 4, dtype=np.float32).reshape(n * 8, 4) / 7.0
    xs = torch.from_numpy(xg[8 * i:8 * i + 8].copy()).to(mesh.device)
    y = C.chunked_ppermute_compute(
        lambda c, _i: c * 1.5 + 1.0, xs, mesh, C.ring_edges(n),
        chunk_dim=0, chunks=2, transport=transport,
        label="topo_smoke_wave")
    z = C.ring_allgather_matmul(lambda c, _s: c * 0.5 + 1.0, xs, mesh, 0,
                                transport=transport)
    mine = (i, y.cpu().numpy(), torch.sum(z).reshape(1).cpu().numpy())
    import torch.distributed as dist

    rows = [None] * n
    dist.all_gather_object(rows, mine, group=mesh.host_group)
    rows.sort(key=lambda r: r[0])
    return (np.concatenate([r[1] for r in rows]),
            np.concatenate([r[2] for r in rows]))


def _ring_parity(rt, order, transport: str, log, first: bool) -> bool:
    """Bitwise pin: the same programs on the rank-order mesh and on the
    mesh over ``order`` (a relabelling of positions), every output byte
    equal (collective over the world)."""
    import numpy as np

    naive = _ring_outputs(rt.submesh(tuple(range(rt.world))), transport)
    topo = _ring_outputs(rt.submesh(tuple(order)), transport)
    ok = (np.array_equal(naive[0], topo[0])
          and np.array_equal(naive[1], topo[1]))
    if first:
        print(f"# smoke ring parity: wave ship + ring_allgather_matmul "
              f"bitwise {'OK' if ok else 'FAIL'} under reordered mesh",
              file=log, flush=True)
    return ok


def run_smoke(rt, *, out=None, engine_parity: bool = True,
              msg_bytes: int = 256 * 1024, iters: int = 4,
              repeats: int = 2, degrade_factor: int = 16,
              artifacts_dir: Optional[str] = None,
              transport: str = "xla") -> Optional[dict]:
    """Run the graded injected-throttle smoke (module docstring) on the
    world of runtime ``rt`` (every rank calls it) → on the first rank
    the result dict (``ok``, ``topo_route_gain``,
    ``topo_migrate_gbps_gain``, per-stage detail); None on the others.

    ``engine_parity=False`` skips the real-engine token-stream pin (the
    dry placement comparison and the ring parity still run).
    ``artifacts_dir`` persists the probed matrix as a ``source: "probe"``
    ``MULTICHIP_r*.json``. ``transport`` is the ring parity's hop
    transport (``"pallas_dma"`` where the ranks share a card, which has
    no NCCL). On ranks that share a card the probe's library hops run on
    the host group."""
    from tpu_p2p_torch.obs import faults
    from tpu_p2p_torch.obs.health import (
        detect_degraded_links,
        probe_link_matrix,
    )
    from tpu_p2p_torch.parallel import collectives as C
    from tpu_p2p_torch.serve.disagg import simulate_disagg_schedule
    from tpu_p2p_torch.topo import place as PL
    from tpu_p2p_torch.topo.model import Topology

    log = out if out is not None else sys.stderr
    n = rt.world
    first = rt.rank == 0
    if n < 3:
        raise RuntimeError(
            DEGENERATE_REASON(n)
            + " (spawn a world with --cpu-mesh 8)")

    def say(msg: str) -> None:
        if first:
            print(msg, file=log, flush=True)

    n_prefill = max(1, n // 2)
    n_decode = n - n_prefill
    # The one throttled edge grades BOTH optimizers: it is ring edge
    # (n_prefill-1 -> n_prefill) AND the migration link prefill rank
    # (n_prefill-1) -> decode shard 0.
    edge = (n_prefill - 1, n_prefill)
    bad_shard = 0
    results: dict = {"devices": n, "edge": edge,
                     "degrade_factor": degrade_factor}

    mesh = rt.submesh(tuple(range(n)))
    probe_edges = list(C.ring_edges(n))
    for p in range(n_prefill):
        for s in range(n_decode):
            e = (p, n_prefill + s)
            if e not in probe_edges:
                probe_edges.append(e)
    plan = faults.FaultPlan(degrade_edge=edge,
                            degrade_factor=degrade_factor)
    say(f"# topo smoke: probing {len(probe_edges)} edge(s) under "
        f"injected throttle {plan.describe()}")
    staged = rt.device.type == "cuda" and mesh.device_group is None
    with faults.injecting(plan), C.host_staged(staged):
        mat = probe_link_matrix(mesh, edges=probe_edges,
                                msg_bytes=msg_bytes, iters=iters,
                                repeats=repeats)
    topo = Topology.from_matrix(mat, "probe")
    flags = detect_degraded_links(mat)
    topo.mark_degraded(flags)
    flagged = any(f["src"] == edge[0] and f["dst"] == edge[1]
                  for f in flags)
    results["health_flagged"] = flagged
    results["matrix_gbps"] = mat
    say(f"# smoke probe: throttled edge "
        f"{edge[0]}->{edge[1]} at {topo.link_gbps(*edge):.2f} Gbps "
        f"vs fleet median {topo.fleet_median():.2f} — health "
        f"verdict {'fired' if flagged else 'MISSED'}")
    if staged:
        say("# smoke probe: the ranks share a card — these Gbps are "
            "time-sliced host timings, not link numbers")
    if artifacts_dir is not None and first:
        from tpu_p2p_torch.obs.regress import write_probe_artifact

        path = write_probe_artifact(mat, n, artifacts_dir)
        say(f"# wrote {path} (source: probe)")

    # ---------------------------------------------------------- ring
    naive_order = tuple(range(n))
    opt_order = PL.ring_order(topo)
    # Published numbers use the REPORTING view (modeled physical
    # Gbps, penalty off): the gain must be what the wire does, not
    # the avoidance bias (place.ring_min_gbps docstring).
    naive_min = PL.ring_min_gbps(topo, naive_order, effective=False)
    opt_min = PL.ring_min_gbps(topo, opt_order, effective=False)
    ring_avoided = edge not in PL.ring_order_edges(opt_order)
    route_gain = opt_min / naive_min if naive_min > 0 else None
    results["ring"] = {
        "naive_min_gbps": naive_min, "opt_min_gbps": opt_min,
        "order": list(opt_order), "avoided": ring_avoided,
        "topo_route_gain": route_gain,
    }
    say(f"# smoke ring: naive min-link {naive_min:.2f} Gbps, "
        f"optimized {opt_min:.2f} Gbps (order "
        f"{' '.join(map(str, opt_order))}) — degraded edge "
        f"avoided={ring_avoided} gain={route_gain:.2f}x")
    ring_parity_ok = _ring_parity(rt, opt_order, transport, log, first)

    # ----------------------------------------------------- migration
    from tpu_p2p_torch.serve.engine import synthetic_trace

    sc = _smoke_serve_shapes(n_prefill, n_decode)
    cfg = _smoke_model_cfg(n_prefill, sc)
    trace = synthetic_trace(sc)
    policy = PL.topo_migration_placement(topo, n_prefill)
    sims = {}
    for label, place in (("naive", None), ("topo", policy)):
        sims[label] = simulate_disagg_schedule(
            trace, slots=sc.slots, prefill_slots=sc.prefill_slots,
            page_len=sc.page_len, num_pages=sc.num_pages,
            prefill_pages=sc.prefill_pages, max_blocks=sc.max_blocks,
            chunk=sc.chunk, n_decode_shards=n_decode,
            placement=place, cfg=cfg)

    def predicted(sim):
        total_b, total_s = 0, 0.0
        per_block = sim["kv_migrate_bytes"] / max(
            sum(e["blocks"] for e in sim["migrate_events"]), 1)
        for e in sim["migrate_events"]:
            b = int(per_block * e["blocks"])
            total_b += b
            total_s += PL.predict_migrate_time_s(
                topo, n_prefill, e["dst_shard"], b, effective=False)
        return (total_b * 8 / total_s / 1e9) if total_s > 0 else None

    naive_bad = sum(e["dst_shard"] == bad_shard
                    for e in sims["naive"]["migrate_events"])
    topo_bad = sum(e["dst_shard"] == bad_shard
                   for e in sims["topo"]["migrate_events"])
    naive_gbps = predicted(sims["naive"])
    topo_gbps = predicted(sims["topo"])
    migrate_gain = (topo_gbps / naive_gbps
                    if naive_gbps and topo_gbps else None)
    results["migrate"] = {
        "migrations": len(sims["topo"]["migrate_events"]),
        "naive_on_degraded": naive_bad, "topo_on_degraded": topo_bad,
        "naive_pred_gbps": naive_gbps, "topo_pred_gbps": topo_gbps,
        "topo_migrate_gbps_gain": migrate_gain,
    }
    say(f"# smoke migrate: naive places {naive_bad}/"
        f"{len(sims['naive']['migrate_events'])} migration(s) over "
        f"the degraded link, topo places {topo_bad}/"
        f"{len(sims['topo']['migrate_events'])} — predicted Gbps "
        f"gain {migrate_gain:.2f}x")

    # -------------------------------------------------- engine parity
    parity = {"ring": ring_parity_ok, "engine": None,
              "dry_vs_real": None}
    if engine_parity and first:
        from tpu_p2p_torch.models import flagship as F
        from tpu_p2p_torch.serve.disagg import (
            build_disagg_meshes,
            run_disagg_engine,
        )

        _, _, mig = build_disagg_meshes(n_prefill, [rt.device] * n)
        params = F.init_flagship_params(cfg, device=rt.device)
        streams, real_events = {}, {}
        for label, place in (("naive", None), ("topo", policy)):
            s = run_disagg_engine(mig, cfg, params, trace, sc=sc,
                                  placement=place)
            streams[label] = {r.rid: list(r.generated)
                              for r in s["finished"]}
            real_events[label] = s["migrate_events"]
        parity["engine"] = (streams["naive"] == streams["topo"]
                            and len(streams["topo"]) > 0)
        parity["dry_vs_real"] = (
            real_events["topo"] == sims["topo"]["migrate_events"])
        say(f"# smoke engine parity: token streams bitwise "
            f"{'OK' if parity['engine'] else 'FAIL'} "
            f"({len(streams['topo'])}/{len(streams['naive'])} "
            f"requests), dry==real migration events "
            f"{'OK' if parity['dry_vs_real'] else 'FAIL'}")
    rt.barrier()
    if not first:
        return None
    results["parity"] = parity
    results["topo_route_gain"] = (round(route_gain, 4)
                                  if route_gain is not None else None)
    results["topo_migrate_gbps_gain"] = (
        round(migrate_gain, 4) if migrate_gain is not None else None)
    results["ok"] = bool(
        flagged and ring_avoided
        and route_gain is not None and route_gain > 1.0
        and topo_bad == 0 and naive_bad > 0
        and migrate_gain is not None and migrate_gain > 1.0
        and ring_parity_ok
        and parity["engine"] is not False
        and parity["dry_vs_real"] is not False
    )
    return results
