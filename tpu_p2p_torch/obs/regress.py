"""Regression gate and ``python -m tpu_p2p_torch obs`` — the port of
``tpu_p2p/obs/regress.py``.

The gate loads the repo's bench trajectory (``BENCH_r*.json`` artifacts
and ``BASELINE.json``), compares a *current* headline against it with
per-key tolerances, prints a verdict table and exits nonzero on a
regression. It is host logic over the repo's files, so its output is the
reference's byte for byte. Artifact formats understood:

- ``parsed`` holds the full result dict, headline keys under
  ``parsed["detail"]``;
- ``parsed`` is null: the keys are recovered from the stdout ``tail``
  by regex, the last occurrence winning;
- ``parsed`` holds the compact line, keys under ``parsed["headline"]``;
- ``--current`` may also name a ``BENCH_detail.json`` (keys under
  ``detail``) or a raw compact-line file.

Per key in :data:`TOLERANCES`, the reference is the BEST prior value
(max for higher-better, min for lower-better) and the current value
regresses when it is worse than ``rel`` beyond it. Keys missing from the
current artifact or from every prior are SKIP, never a failure.

``python -m tpu_p2p_torch obs`` first prints the LIVE report — the
collective-ledger capture on the world of ranks
(:func:`tpu_p2p_torch.obs.ledger.live_capture`, joined against each
rank's ``torch.profiler`` window into the per-link achieved-bandwidth
matrix; totals only without a device track) and the schedule bubbles —
then runs the gate. ``--no-live`` / ``--no-gate`` select one half;
``--cpu-mesh N`` spawns N gloo ranks, and under a launcher every rank
takes part while the first prints. ``obs watch`` and ``obs smoke``
dispatch to :mod:`tpu_p2p_torch.obs.health`.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Tolerance", "TOLERANCES", "headline_from_artifact",
           "load_trajectory", "load_multichip_history", "compare",
           "write_multichip_artifact", "write_probe_artifact",
           "print_schedule_bubbles", "main"]


@dataclass(frozen=True)
class Tolerance:
    better: str  # "higher" | "lower"
    rel: float  # allowed fractional regression vs the best prior
    # "lower" keys only: values at or below this absolute level never
    # regress, whatever the best prior ratcheted down to.
    abs_floor: float = 0.0


# Per-key gate tolerances, the reference's table in its order: loose
# where the measurement rides host noise (latency floors, host-loop
# tails), tight where a device slope is stable; integer step counts get
# 100 % (one extra step allowed).
TOLERANCES: Dict[str, Tolerance] = {
    "hbm_gbytes_per_s": Tolerance("higher", 0.15),
    "flash_attention_tflops": Tolerance("higher", 0.15),
    "flash_bwd_tflops": Tolerance("higher", 0.15),
    "flagship_large_step_ms": Tolerance("lower", 0.15),
    "flagship_large_mfu": Tolerance("higher", 0.10),
    "latency_8b_p50_us": Tolerance("lower", 0.50),
    "fsdp_overlap_frac": Tolerance("higher", 0.25),
    "fsdp_step_ms_overlap_prefetch": Tolerance("lower", 0.25),
    "tp_overlap_frac": Tolerance("higher", 0.25),
    "tp_step_ms_overlap_ring": Tolerance("lower", 0.25),
    "ep_overlap_frac": Tolerance("higher", 0.25),
    "ep_step_ms_overlap_ring": Tolerance("lower", 0.25),
    "pp_overlap_frac": Tolerance("higher", 0.25),
    "pp_step_ms_overlap_wave": Tolerance("lower", 0.25),
    "pp_zb_vs_fused_ratio": Tolerance("lower", 0.25),
    "pp_bubble_frac_measured_zb": Tolerance("lower", 0.25),
    "obs_step_ms_p50": Tolerance("lower", 0.30),
    "ring_gbps_pallas": Tolerance("higher", 0.25),
    "health_detect_steps": Tolerance("lower", 1.00),
    "serve_tokens_per_s": Tolerance("higher", 0.25),
    "serve_tok_ms_p99": Tolerance("lower", 0.50),
    "ckpt_recover_steps": Tolerance("lower", 1.00),
    "serve_disagg_tokens_per_s": Tolerance("higher", 0.25),
    "serve_kv_migrate_gbps": Tolerance("higher", 0.25),
    "topo_route_gain": Tolerance("higher", 0.50),
    "topo_migrate_gbps_gain": Tolerance("higher", 0.50),
    # A TTFT ratio at or below 0.5 passes outright: an unusually
    # deep-sharing run must not ratchet an unpassable bar.
    "serve_ttft_prefix_ratio": Tolerance("lower", 0.25, abs_floor=0.5),
    "serve_spec_accept_rate": Tolerance("higher", 0.25),
}

_TAIL_KV = re.compile(
    r'"([A-Za-z0-9_]+)":\s*(-?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?)'
)


def _numeric(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _headline_from_tail(tail: str) -> Dict[str, float]:
    """Gate keys recovered from a (possibly truncated) stdout tail; the
    last occurrence wins."""
    out: Dict[str, float] = {}
    for m in _TAIL_KV.finditer(tail or ""):
        if m.group(1) in TOLERANCES:
            out[m.group(1)] = float(m.group(2))
    return out


def headline_from_artifact(data: dict) -> Dict[str, float]:
    """Flatten one artifact (any format of the module docstring) to
    ``{gate_key: value}``, numeric values only."""
    out: Dict[str, float] = {}
    candidates: List[dict] = []
    if isinstance(data.get("parsed"), dict):
        parsed = data["parsed"]
        for sub in ("detail", "headline"):
            if isinstance(parsed.get(sub), dict):
                candidates.append(parsed[sub])
        candidates.append(parsed)
    elif "parsed" in data:  # a bench artifact with parsed: null
        return _headline_from_tail(data.get("tail", ""))
    for sub in ("detail", "headline", "published"):
        if isinstance(data.get(sub), dict):
            candidates.append(data[sub])
    if not candidates:
        candidates.append(data)
    for cand in candidates:
        for k in TOLERANCES:
            if k not in out and _numeric(cand.get(k)):
                out[k] = float(cand[k])
    return out


def load_trajectory(artifacts_dir: str,
                    current: Optional[str] = None):
    """→ ``(current_name, current_headline, priors)``, ``priors`` as
    ``[(name, headline), ...]`` in round order.

    ``BENCH_r*.json`` files sort by round; ``current`` (a path or a bare
    filename, resolved under ``artifacts_dir`` first) defaults to the
    newest. Rounds after the current are ignored (gating an old round
    replays history). ``BASELINE.json``'s ``published`` dict, when not
    empty, joins the priors first.
    """
    rounds = sorted(glob.glob(os.path.join(artifacts_dir,
                                           "BENCH_r*.json")))
    cur_path = None
    if current:
        in_dir = os.path.join(artifacts_dir, current)
        cur_path = (in_dir if os.path.sep not in current
                    and os.path.exists(in_dir) else current)
    elif rounds:
        cur_path = rounds[-1]
    if cur_path is None or not os.path.exists(cur_path):
        raise FileNotFoundError(
            f"no current artifact (looked for BENCH_r*.json under "
            f"{artifacts_dir!r}" + (f" and {current!r}" if current
                                    else "") + ")"
        )
    with open(cur_path) as fh:
        cur_head = headline_from_artifact(json.load(fh))
    cur_name = os.path.basename(cur_path)
    # Basenames: an explicit --current path may spell the same file
    # differently than the glob.
    cur_is_round = any(os.path.basename(p) == cur_name for p in rounds)
    priors: List[Tuple[str, Dict[str, float]]] = []
    base = os.path.join(artifacts_dir, "BASELINE.json")
    if os.path.exists(base):
        with open(base) as fh:
            pub = headline_from_artifact(json.load(fh))
        if pub:
            priors.append(("BASELINE.json", pub))
    for p in rounds:
        name = os.path.basename(p)
        if name == cur_name or (cur_is_round and name >= cur_name):
            continue
        with open(p) as fh:
            head = headline_from_artifact(json.load(fh))
        if head:
            priors.append((name, head))
    return cur_name, cur_head, priors


def compare(current: Dict[str, float],
            priors: Sequence[Tuple[str, Dict[str, float]]]):
    """→ a row dict a key: key, current, ref (best prior), ratio and
    verdict in {"OK", "REGRESSED", "SKIP"}."""
    rows = []
    for key, tol in TOLERANCES.items():
        cur = current.get(key)
        vals = [h[key] for _, h in priors if _numeric(h.get(key))]
        if cur is None or not vals:
            rows.append({"key": key, "current": cur, "ref": None,
                         "ratio": None, "verdict": "SKIP"})
            continue
        ref = max(vals) if tol.better == "higher" else min(vals)
        ratio = (cur / ref) if ref else None
        if tol.better == "higher":
            bad = ref > 0 and cur < ref * (1.0 - tol.rel)
        else:
            floor = max(ref * (1.0 + tol.rel), tol.abs_floor)
            bad = (ref > 0 or tol.abs_floor > 0) and cur > floor
        rows.append({"key": key, "current": cur, "ref": ref,
                     "ratio": ratio,
                     "verdict": "REGRESSED" if bad else "OK"})
    return rows


def _fmt(v) -> str:
    if v is None:
        return "-"
    return f"{v:.4g}" if isinstance(v, float) else str(v)


def print_gate(cur_name: str, rows, priors, stream=None) -> int:
    """Print the verdict table → the exit code (1 on any REGRESSED)."""
    out = stream if stream is not None else sys.stdout
    out.write(f"# obs regress: current={cur_name} vs "
              f"{len(priors)} prior artifact(s)\n")
    out.write("# %-30s %10s %10s %7s  %s\n"
              % ("key", "current", "ref", "ratio", "verdict"))
    for r in rows:
        out.write("# %-30s %10s %10s %7s  %s\n" % (
            r["key"], _fmt(r["current"]), _fmt(r["ref"]),
            _fmt(r["ratio"]), r["verdict"],
        ))
    n_reg = sum(r["verdict"] == "REGRESSED" for r in rows)
    n_ok = sum(r["verdict"] == "OK" for r in rows)
    n_skip = sum(r["verdict"] == "SKIP" for r in rows)
    out.write(f"# verdict: {'REGRESSED' if n_reg else 'OK'} "
              f"({n_reg} regressions, {n_ok} keys compared, "
              f"{n_skip} skipped)\n")
    out.flush()
    return 1 if n_reg else 0


def _nan_to_none(matrix):
    # NaN and None both mean "unmeasured", never 0.
    return [[None if v is None or (isinstance(v, float) and v != v)
             else round(v, 3)
             for v in row] for row in matrix]


def _next_multichip_path(artifacts_dir: str) -> str:
    """The next free ``MULTICHIP_r*.json`` path: one past the highest
    existing index, never overwriting a file."""
    existing = []
    for p in glob.glob(os.path.join(artifacts_dir, "MULTICHIP_r*.json")):
        m = re.search(r"MULTICHIP_r(\d+)\.json$", p)
        if m:
            existing.append(int(m.group(1)))
    idx = max(existing, default=0) + 1
    path = os.path.join(artifacts_dir, f"MULTICHIP_r{idx:02d}.json")
    while os.path.exists(path):
        idx += 1
        path = os.path.join(artifacts_dir, f"MULTICHIP_r{idx:02d}.json")
    return path


def write_multichip_artifact(join, n: int, artifacts_dir: str = ".",
                             extra: Optional[dict] = None, *,
                             matrix=None, matrix_dma=None):
    """Persist the per-link N×N achieved-Gbps matrix as a
    ``MULTICHIP_r*.json`` artifact (``source: "trace"``), written only
    when a device trace joined edge-carrying traffic (→ None otherwise,
    nothing touched). ``matrix`` / ``matrix_dma``: the world's merged
    matrices (default: this join's). With peer-push rows, the library
    and the peer-push matrices are split (``matrix_gbps`` /
    ``matrix_gbps_dma``). → the path written, or None."""
    if join.no_device_track:
        return None
    edged = [j for j in join.joined if j.issue.edges]
    if not edged and matrix is None:
        return None
    from tpu_p2p_torch.obs.ledger import non_dma_kinds

    has_dma = matrix_dma is not None or any(
        j.issue.kind == "dma" for j in edged)
    lib = matrix if matrix is not None else join.link_matrix(
        n, kinds=non_dma_kinds() if has_dma else None)
    art = {
        "kind": "obs_link_matrix",
        "n_devices": int(n),
        "source": "trace",
        "matrix_gbps": _nan_to_none(lib),
        "per_kind": join.per_kind(),
        "per_axis": join.per_axis(),
        "unmatched": join.unmatched,
        "ragged": list(join.ragged),
    }
    if has_dma:
        art["matrix_gbps_dma"] = _nan_to_none(
            matrix_dma if matrix_dma is not None
            else join.link_matrix(n, kinds=("dma",)))
    if extra:
        art.update(extra)
    path = _next_multichip_path(artifacts_dir)
    with open(path, "w") as fh:
        json.dump(art, fh, indent=1)
        fh.write("\n")
    return path


def write_probe_artifact(matrix, n: int, artifacts_dir: str = ".",
                         extra: Optional[dict] = None):
    """Persist one :func:`tpu_p2p_torch.obs.health.probe_link_matrix`
    result as a ``MULTICHIP_r*.json`` artifact with ``source: "probe"``,
    through the same numbering and schema as the trace writer. → the
    path written."""
    art = {
        "kind": "obs_link_matrix",
        "n_devices": int(n),
        "source": "probe",
        "matrix_gbps": _nan_to_none(matrix),
    }
    if extra:
        art.update(extra)
    path = _next_multichip_path(artifacts_dir)
    with open(path, "w") as fh:
        json.dump(art, fh, indent=1)
        fh.write("\n")
    return path


_SOURCE_RANK = {"probe": 1, "trace": 2}


def load_multichip_history(artifacts_dir: str = ".",
                           with_sources: bool = False):
    """Per-link historical baseline from the ``MULTICHIP_r*.json``
    sequence: the elementwise best achieved Gbps each directed link ever
    published (the link detector's ``baseline=``). Only
    ``obs_link_matrix`` artifacts count; a trace-measured cell (or a
    legacy one without ``source``) outranks a host-timed probe cell
    whatever the values, and within one source the max wins; the matrix
    grows to the largest mesh seen. → N×N list of lists with None where
    no artifact measured the link (and, with ``with_sources``, the
    winning source a cell), or None without usable history."""
    best: Optional[List[List[float]]] = None
    srcs: Optional[List[List[Optional[str]]]] = None
    for p in sorted(glob.glob(os.path.join(artifacts_dir,
                                           "MULTICHIP_r*.json"))):
        try:
            with open(p) as fh:
                art = json.load(fh)
        except (OSError, json.JSONDecodeError):
            continue
        m = art.get("matrix_gbps")
        if art.get("kind") != "obs_link_matrix" or not m:
            continue
        source = art.get("source", "trace")
        rank = _SOURCE_RANK.get(source, _SOURCE_RANK["trace"])
        n = max(len(m), max((len(r) for r in m), default=0),
                len(best) if best is not None else 0)
        if best is None:
            best = [[None] * n for _ in range(n)]
            srcs = [[None] * n for _ in range(n)]
        elif n > len(best):
            for row in best:
                row.extend([None] * (n - len(row)))
            best.extend([None] * n for _ in range(n - len(best)))
            for row in srcs:
                row.extend([None] * (n - len(row)))
            srcs.extend([None] * n for _ in range(n - len(srcs)))
        for i, row in enumerate(m):
            for j, v in enumerate(row):
                if not _numeric(v):
                    continue
                cur = best[i][j]
                cur_rank = _SOURCE_RANK.get(srcs[i][j], 0)
                if cur is None or rank > cur_rank \
                        or (rank == cur_rank and v > cur):
                    best[i][j] = v
                    srcs[i][j] = ("trace" if rank
                                  == _SOURCE_RANK["trace"] else "probe")
    if with_sources:
        return None if best is None else (best, srcs)
    return best


def print_schedule_bubbles(n: int, cur_head: Optional[dict] = None,
                           microbatches: int = 2,
                           stream=None) -> None:
    """The per-rank pipeline bubble of the fused 1F1B and zero-bubble
    programs at the live capture's shape (M=2, S=n), from
    :func:`tpu_p2p_torch.models.schedule.price_program`'s idle spans,
    and the span ratio a cost-proportional run of the two would show;
    beside it the measured pair or ratio the gated artifact carries."""
    out = stream if stream is not None else sys.stdout
    from tpu_p2p_torch.models import schedule as SCH

    progs = [SCH.compile_1f1b(microbatches, n),
             SCH.compile_zb(microbatches, n)]
    spans = {}
    out.write(f"# schedule bubble per rank (tick IR @ M={microbatches}"
              f" S={n}; analytic idle share under the IR cost model)\n")
    for prog in progs:
        bill = SCH.price_program(prog, payload_bytes=1024)
        fracs = " ".join(f"{r['bubble_frac']:.2f}"
                         for r in bill["per_rank"])
        idle_ticks = sum(e - s for r in bill["per_rank"]
                         for s, e in r["idle_spans"])
        rank0 = bill["per_rank"][0]
        spans[prog.name] = rank0["busy_cost"] + rank0["idle_cost"]
        out.write(f"#   {prog.name:<5}: {fracs}  (program "
                  f"{bill['bubble_frac']:.2f}, {idle_ticks} idle "
                  f"rank-ticks over {bill['ticks']} ticks)\n")
    ratio = spans["zb"] / spans["1f1b"] if spans.get("1f1b") else None
    out.write(
        f"#   analytic span ratio zb/1f1b: {ratio:.2f} under "
        "cost-proportional execution\n"
    )
    head = cur_head or {}
    ms_1 = head.get("pp_step_ms_sched_1f1b")
    ms_z = head.get("pp_step_ms_sched_zb")
    r_m = head.get("pp_zb_vs_fused_ratio")
    if ms_1 and ms_z:
        suffix = f" (ratio {r_m})" if r_m is not None else ""
        out.write(
            f"#   measured bench pair: zb route (switch lowering) "
            f"{ms_z} ms vs fused production step (masked) {ms_1} ms"
            f"{suffix}\n"
        )
    elif r_m is not None:
        out.write(
            f"#   measured bench pair: zb/fused wall-clock ratio "
            f"{r_m} (absolutes in BENCH_detail.json)\n"
        )
    else:
        out.write(
            "#   measured bench pair: n/a (current artifact carries "
            "no pp_step_ms_sched pair)\n"
        )
    mb = head.get("pp_bubble_frac_measured_zb")
    if mb is not None:
        out.write(
            f"#   measured zb bubble (flight recorder): {mb} — "
            "per-rank mean, host tick stamps joined to the IR "
            "(docs/tracing.md; `obs trace` for the full table)\n"
        )
    out.flush()


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_p2p_torch obs",
        description="Observability report + bench regression gate: live "
                    "collective-ledger capture on the world of ranks, "
                    "then the BENCH_r*.json trajectory gate.",
    )
    p.add_argument("--artifacts-dir", default=".", metavar="DIR",
                   help="where BENCH_r*.json / BASELINE.json live, and "
                        "where a MULTICHIP_r*.json is written (default: "
                        "cwd)")
    p.add_argument("--current", default=None, metavar="PATH",
                   help="artifact to gate (default: newest BENCH_r*); "
                        "also accepts a BENCH_detail.json or a raw "
                        "compact-line file")
    p.add_argument("--msg-size", default="4MiB", metavar="SIZE",
                   help="live-capture payload per message")
    p.add_argument("--count", type=int, default=8,
                   help="live-capture chain hops")
    p.add_argument("--no-live", action="store_true",
                   help="skip the live ledger capture/report")
    p.add_argument("--no-gate", action="store_true",
                   help="skip the trajectory gate")
    p.add_argument("--cpu-mesh", type=int, default=None, metavar="N",
                   help="spawn N CPU ranks (gloo)")
    p.add_argument("--device", default=None,
                   help="each rank's device (default: a card a rank; "
                        "cuda:0 puts every rank of a launched world on "
                        "one card)")
    return p


def _live(args, out) -> None:
    """The live half on this rank's world; the first rank prints."""
    from tpu_p2p_torch.config import parse_size
    from tpu_p2p_torch.obs import ledger as L
    from tpu_p2p_torch.parallel.runtime import make_runtime

    rt = make_runtime(device="cpu" if args.cpu_mesh else args.device)
    try:
        n = rt.world
        first = rt.rank == 0
        if first:
            print(f"# obs live capture: {n} device(s), "
                  f"{args.msg_size} payload, {args.count}-hop chains",
                  file=out, flush=True)
        cap = L.live_capture(rt, msg_bytes=parse_size(args.msg_size),
                             count=args.count)
        if not first:
            return
        if n < 2:
            print("# single device: no inter-chip link exists — ledger "
                  "capture skipped", file=out)
            return
        L.print_report(cap.ledger, cap.join, n=n, stream=out,
                       matrix=cap.matrix, matrix_dma=cap.matrix_dma,
                       host_only=cap.host_only)
        written = write_multichip_artifact(
            cap.join, n, artifacts_dir=args.artifacts_dir,
            matrix=cap.matrix, matrix_dma=cap.matrix_dma,
            extra={"time_sliced": True} if cap.host_only else None)
        if written:
            print(f"# wrote {os.path.basename(written)} (per-link "
                  "achieved-Gbps matrix artifact)", file=out)
        cur_head = None
        try:
            _, cur_head, _ = load_trajectory(args.artifacts_dir,
                                             args.current)
        except Exception:  # noqa: BLE001 — no trajectory (a fresh
            # checkout) must not take the live report down
            pass
        print_schedule_bubbles(n, cur_head, stream=out)
    finally:
        rt.close()


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "watch":
        from tpu_p2p_torch.obs.health import watch_main

        return watch_main(argv[1:])
    if argv and argv[0] == "smoke":
        from tpu_p2p_torch.obs.health import smoke_main

        return smoke_main(argv[1:])
    if argv and argv[0] == "trace":
        from tpu_p2p_torch.obs.tickprof import trace_main

        return trace_main(argv[1:])
    if argv and argv[0] == "ckpt-smoke":
        from tpu_p2p_torch.obs.ckpt import ckpt_smoke_main

        return ckpt_smoke_main(argv[1:])
    args = _build_parser().parse_args(argv)
    if args.cpu_mesh and not args.no_live and "RANK" not in os.environ:
        from tpu_p2p_torch.parallel.launch import spawn

        return max(spawn(args.cpu_mesh, ["-m", "tpu_p2p_torch", "obs",
                                         *argv]))
    from tpu_p2p_torch.utils.errors import fail_fast

    try:
        if not args.no_live:
            _live(args, sys.stdout)
        rc = 0
        first = int(os.environ.get("RANK", "0")) == 0
        if not args.no_gate and first:
            cur_name, cur_head, priors = load_trajectory(
                args.artifacts_dir, args.current
            )
            rc = print_gate(cur_name, compare(cur_head, priors), priors)
        return rc
    except KeyboardInterrupt:
        print("interrupted", file=sys.stderr)
        return 130
    except SystemExit:
        raise
    except BaseException as e:  # noqa: BLE001 — the one fail-fast exit
        return fail_fast(e)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
