"""The all-pairs P2P bandwidth matrix — the reference program itself.
The port's copy of ``tpu_p2p/workloads/pairwise.py``.

Both sweeps of ``p2p_matrix.cc``: uni-directional (``:141-186``), a
single-edge transfer per ordered pair with a drain per message, then
bi-directional (``:196-267``), both directed edges in one transfer,
throughput ×2 (``:258``). Two isolation modes:

- ``full``: every rank of the world takes part in each pair's transfer,
  the others with no edge (over ``pallas_dma`` they push dummy edges of
  the completed permutation, whose arrivals are zeroed);
- ``submesh``: only the pair, over a process group of its own; the
  other ranks wait at the cell's broadcast.
"""

from __future__ import annotations

import sys

from tpu_p2p_torch.config import format_size
from tpu_p2p_torch.parallel import collectives as C
from tpu_p2p_torch.utils.report import MatrixReporter
from tpu_p2p_torch.workloads.base import (
    WorkloadContext,
    cell_record,
    measure_edges,
    verify_edges,
    workload,
)


def _pair_edges(direction: str, src: int, dst: int):
    if direction == "uni":
        return C.unidir_edges(src, dst), 1
    return C.bidir_edges(src, dst), 2


def device_word(rt) -> str:
    """The matrix titles' device word: ``GPU`` on the card; on the CPU
    world the reference's ``TPU``, so the text stays byte-equal to the
    reference's goldens."""
    return "GPU" if rt.device.type == "cuda" else "TPU"


def _run_matrix(ctx: WorkloadContext, direction: str, msg_bytes: int) -> dict:
    rt, cfg = ctx.rt, ctx.cfg
    n = rt.num_devices
    via = "" if cfg.transport == "xla" else f" via {cfg.transport}"
    title = (
        f"Evaluating the {'Uni' if direction == 'uni' else 'Bi'}-Directional "
        f"{device_word(rt)} P2P Bandwidth{via} (Gbps)"
    )
    rep = MatrixReporter(n, title,
                         sys.stdout if ctx.is_printer else _NullStream())
    rep.header()
    for src, dst in C.all_pairs(n):
        if dst == 0:
            rep.row_label(src)
        rt.barrier()  # p2p_matrix.cc:146/:201 — align before each cell
        if src == dst:
            rep.diagonal(src)  # p2p_matrix.cc:147-151
            if dst == n - 1:
                rep.end_row()
            continue
        key = ("pairwise", direction, src, dst, msg_bytes, cfg.mode,
               cfg.transport)
        prev = ctx.previously_done(key)
        if prev is not None:
            rep.cell(src, dst, prev)
            if dst == n - 1:
                rep.end_row()
            continue
        edges, directions = _pair_edges(direction, src, dst)
        mesh = rt.mesh
        if cfg.isolation == "submesh":
            mesh = rt.submesh([src, dst])
            local = {src: 0, dst: 1}
            edges = tuple((local[a], local[b]) for a, b in edges)
        gbps_val, samples = measure_edges(ctx, mesh, "d", edges, msg_bytes,
                                          directions=directions)
        if cfg.check:
            verify_edges(ctx, mesh, "d", edges, msg_bytes)
        gbps_val, samples = rt.broadcast((gbps_val, samples), src)
        rep.cell(src, dst, gbps_val)
        ctx.record(
            cell_record(
                ctx, workload="pairwise", direction=direction, src=src,
                dst=dst, msg_bytes=msg_bytes, gbps_val=gbps_val,
                samples=samples, isolation=cfg.isolation,
            )
        )
        if dst == n - 1:
            rep.end_row()
    summary = rep.print_summary(
        f"pairwise {direction}-dir {format_size(msg_bytes)} {cfg.mode}"
        + ("" if cfg.transport == "xla" else f" {cfg.transport}")
    )
    return {"direction": direction, "msg_bytes": msg_bytes, **summary}


class _NullStream:
    def write(self, _):
        pass

    def flush(self):
        pass


@workload("pairwise")
def run_pairwise(ctx: WorkloadContext) -> list:
    """Full sweep: uni then bi (reference order, p2p_matrix.cc:141,196),
    over every size in the sweep."""
    results = []
    for msg_bytes in ctx.cfg.sizes():
        if ctx.cfg.direction in ("uni", "both"):
            results.append(_run_matrix(ctx, "uni", msg_bytes))
        if ctx.cfg.direction in ("bi", "both"):
            if ctx.is_printer and ctx.cfg.direction == "both":
                sys.stdout.write("\n")  # p2p_matrix.cc:189 leading newline
            results.append(_run_matrix(ctx, "bi", msg_bytes))
    return results
