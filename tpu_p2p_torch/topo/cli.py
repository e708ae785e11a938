"""``python -m tpu_p2p_torch topo`` — render the topology model / run
the graded smoke (the port of ``tpu_p2p/topo/cli.py``).

The render is the obs report's analogue for the topology subsystem: the
modeled N×N per-link Gbps with PROVENANCE PER CELL (T=trace, P=probe,
A=preset, M=median-inherited), the fleet median, the worst links, and
the two recommendations the optimizers would hand the executors — the
ring order (vs the naive rank order's bottleneck) and the decode-shard
ranking for KV-migration placement under the current disagg split.

``--smoke`` runs the injected-throttle grade instead
(:func:`tpu_p2p_torch.topo.smoke.run_smoke`): nonzero exit unless the
probe sees the throttle, both optimizers route around it and beat the
naive predicted cost, and the bitwise parity pins hold.

The world: ``--cpu-mesh N`` spawns N CPU ranks (gloo), ``torchrun``
gives one rank a card, and a bare call is a world of one on its card
(``--device`` as ``obs`` takes it; ``cuda:0`` puts every rank of a
launched world on one card). A preset render needs no world: with
``--cpu-mesh N`` it renders N positions without spawning one. The first
rank prints.

Exit codes: 0 ok; 1 smoke failure; 2+ via the shared fail-fast.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

from tpu_p2p_torch.topo.model import PROVENANCE_LETTERS, Topology

__all__ = ["render_topology", "main"]


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_p2p_torch topo",
        description="Topology model report + placement "
                    "recommendations: per-link Gbps with per-cell "
                    "provenance off the trace>history>probe>preset "
                    "ladder, recommended ring order and KV-migration "
                    "placement; --smoke runs the graded "
                    "injected-throttle check.",
    )
    p.add_argument("--artifacts-dir", default=".", metavar="DIR",
                   help="where MULTICHIP_r*.json history lives "
                        "(default: cwd)")
    p.add_argument("--preset", choices=("auto", "uniform", "ring"),
                   default="auto",
                   help="skip the ladder and use an analytic preset "
                        "(auto = the ladder: trace matrix > history "
                        "> probe > uniform preset)")
    p.add_argument("--link-gbps", type=float, default=100.0,
                   help="preset nearest-neighbor link speed")
    p.add_argument("--payload", default="1MiB", metavar="SIZE",
                   help="payload used for the predicted-Gbps "
                        "recommendation tables")
    p.add_argument("--probe-msg-size", default="256KiB", metavar="SIZE",
                   help="probe payload per message (ladder rung 3)")
    p.add_argument("--probe-iters", type=int, default=4,
                   help="probe chain hops per edge")
    p.add_argument("--prefill-tp", type=int, default=0,
                   help="disagg split for the migration table "
                        "(0 = half the devices)")
    p.add_argument("--worst", type=int, default=3,
                   help="how many worst links to list")
    p.add_argument("--smoke", action="store_true",
                   help="run the graded injected-throttle smoke "
                        "instead of the render")
    p.add_argument("--skip-engine-parity", action="store_true",
                   help="--smoke: skip the real-engine token-stream "
                        "pin (dry placement + ring parity still run)")
    p.add_argument("--write-artifact", action="store_true",
                   help="persist the probed matrix as a "
                        "source:'probe' MULTICHIP_r*.json under "
                        "--artifacts-dir")
    p.add_argument("--cpu-mesh", type=int, default=None, metavar="N",
                   help="spawn N CPU ranks (gloo)")
    p.add_argument("--device", default=None,
                   help="each rank's device (default: a card a rank; "
                        "cuda:0 puts every rank of a launched world on "
                        "one card)")
    return p


def render_topology(topo: Topology, *, payload_bytes: int,
                    prefill_tp: int = 0, worst: int = 3,
                    stream=None) -> None:
    """Print the model the way ``obs`` prints the ledger: matrix with
    provenance letters, fleet median, worst links, and the two
    placement recommendations."""
    out = stream if stream is not None else sys.stdout
    from tpu_p2p_torch.topo import place as PL

    n = topo.n
    out.write(f"# topo model: {n} device(s), source={topo.source} "
              "(ladder: trace > history > probe > preset)\n")
    out.write("# provenance: T=trace P=probe A=preset "
              "M=median-inherited (unmeasured cells inherit the "
              "fleet median, never 0)\n")
    out.write("   D\\D" + "".join(f"{j:>10d}" for j in range(n))
              + "\n")
    for i in range(n):
        cells = []
        for j in range(n):
            if i == j:
                cells.append(f"{'.':>10}")
            else:
                letter = PROVENANCE_LETTERS.get(
                    topo.provenance[i][j], "?")
                mark = "!" if (i, j) in topo.degraded else ""
                cells.append(f"{topo.gbps[i][j]:>8.2f}{letter}{mark}"
                             .rjust(10))
        out.write(f"{i:>6d}" + "".join(cells) + "\n")
    med = topo.fleet_median()
    med_s = f"{med:.2f}" if med is not None else "-"
    out.write(f"# fleet median {med_s} Gbps over "
              f"{n * (n - 1)} directed link(s), "
              f"{len(topo.degraded)} flagged degraded\n")
    for s, d, g in topo.worst_links(worst):
        letter = PROVENANCE_LETTERS.get(topo.provenance[s][d], "?")
        mark = " DEGRADED" if (s, d) in topo.degraded else ""
        out.write(f"# worst link {s}->{d}: {g:.2f} Gbps "
                  f"({letter}){mark}\n")
    # The order is chosen in the routing view (degraded links avoided);
    # the PRINTED Gbps are the reporting view — a flagged link renders
    # its physical speed, not the 1e-6 avoidance bias.
    naive = tuple(range(n))
    order = PL.ring_order(topo)
    out.write(f"# ring order: naive 0..{n - 1} min-link "
              f"{PL.ring_min_gbps(topo, naive, effective=False):.2f} "
              f"Gbps -> recommended {' '.join(map(str, order))} "
              f"min-link "
              f"{PL.ring_min_gbps(topo, order, effective=False):.2f} "
              f"Gbps\n")
    if n >= 2:
        n_pre = int(prefill_tp) if prefill_tp else max(1, n // 2)
        n_dec = n - n_pre
        if n_dec >= 1:
            ranked = PL.rank_decode_shards(topo, n_pre, n_dec,
                                           payload_bytes)
            tbl = "  ".join(f"s{s}:{g:.2f}" for s, g in ranked)
            out.write(f"# migration placement (prefill {n_pre} x "
                      f"decode {n_dec}, {payload_bytes} B): "
                      f"predicted Gbps best-first {tbl}\n")
    out.flush()


def _preset(kind: str, n: int, link_gbps: float) -> Topology:
    if kind == "uniform":
        return Topology.preset_uniform(n, link_gbps)
    return Topology.preset_ring(n, link_gbps)


def _render(topo: Topology, args) -> None:
    """Degraded-link marks off the health detector over the model's own
    cells (the render shows what placement would avoid), then the
    render."""
    from tpu_p2p_torch.config import parse_size
    from tpu_p2p_torch.obs.health import detect_degraded_links

    topo.mark_degraded(detect_degraded_links(topo.gbps))
    render_topology(topo, payload_bytes=parse_size(args.payload),
                    prefill_tp=args.prefill_tp, worst=args.worst)


def _on_world(args) -> int:
    """The command on this rank of the world (every rank runs it)."""
    from tpu_p2p_torch.config import parse_size
    from tpu_p2p_torch.parallel.runtime import make_runtime

    rt = make_runtime(device="cpu" if args.cpu_mesh else args.device)
    n, first = rt.world, rt.rank == 0
    try:
        if args.smoke:
            from tpu_p2p_torch.topo.smoke import run_smoke

            shared = (rt.device.type == "cuda"
                      and rt.mesh.device_group is None and n > 1)
            res = run_smoke(
                rt, out=sys.stdout,
                engine_parity=not args.skip_engine_parity,
                msg_bytes=parse_size(args.probe_msg_size),
                iters=args.probe_iters,
                artifacts_dir=(args.artifacts_dir
                               if args.write_artifact else None),
                transport="pallas_dma" if shared else "xla")
            ok = bool(res["ok"]) if first else False
            if first:
                print(json.dumps({
                    "topo_route_gain": res["topo_route_gain"],
                    "topo_migrate_gbps_gain":
                        res["topo_migrate_gbps_gain"],
                    "ok": ok,
                }), flush=True)
            return 0 if rt.broadcast(ok, 0) else 1
        if args.preset != "auto":
            topo = _preset(args.preset, n, args.link_gbps)
        else:
            from tpu_p2p_torch.parallel import collectives as C

            staged = rt.device.type == "cuda" \
                and rt.mesh.device_group is None
            with C.host_staged(staged):
                topo = Topology.best_available(
                    n, artifacts_dir=args.artifacts_dir,
                    mesh=rt.submesh(tuple(range(n))) if n >= 2 else None,
                    probe_kwargs={
                        "msg_bytes": parse_size(args.probe_msg_size),
                        "iters": args.probe_iters,
                    })
            if args.write_artifact and topo.source == "probe" and first:
                from tpu_p2p_torch.obs.regress import write_probe_artifact

                # Only the MEASURED cells: median-inherited cells are not
                # probe data and must not enter the history as if they
                # were.
                raw = [[topo.gbps[i][j]
                        if topo.provenance[i][j] == "probe" else None
                        for j in range(n)] for i in range(n)]
                path = write_probe_artifact(raw, n, args.artifacts_dir)
                print(f"# wrote {path} (source: probe)")
        if first:
            _render(topo, args)
        return 0
    finally:
        rt.close()


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _build_parser().parse_args(argv)
    from tpu_p2p_torch.utils.errors import fail_fast

    try:
        if args.cpu_mesh and not args.smoke and args.preset != "auto":
            _render(_preset(args.preset, args.cpu_mesh, args.link_gbps),
                    args)
            return 0
        if args.cpu_mesh and "RANK" not in os.environ:
            from tpu_p2p_torch.parallel.launch import spawn

            return max(spawn(args.cpu_mesh,
                             ["-m", "tpu_p2p_torch", "topo", *argv]))
        return _on_world(args)
    except KeyboardInterrupt:
        print("interrupted", file=sys.stderr)
        return 130
    except SystemExit:
        raise
    except BaseException as e:  # noqa: BLE001 — single fail-fast exit
        return fail_fast(e)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
