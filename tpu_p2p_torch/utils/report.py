"""Reporting — the port's copy of ``tpu_p2p/utils/report.py``.

The matrix text is the reference program's product contract and is
reproduced byte for byte: the section title, the ``   D\\D`` header with
``%6d ``-formatted column ids (``p2p_matrix.cc:134-139,189-194``), the
``%6d `` row label (``:143,198``), ``%6.02f `` Gbps cells with ``0.00``
on the diagonal (``:147-151,179,202-206,260``), a flush after every cell
(``:180,261``) and a newline per row (``:183-185,264-266``). Beside it, a
min/avg/max summary over the off-diagonal cells and one JSONL record per
cell, which doubles as the resume checkpoint.
"""

from __future__ import annotations

import json
import math
import os
import sys
from dataclasses import dataclass, field
from typing import IO, Optional

from tpu_p2p_torch.utils import native as _native


class MatrixReporter:
    """Streams one N×N matrix in the reference's exact format."""

    def __init__(self, n: int, title: str,
                 stream: Optional[IO] = None) -> None:
        self.n = n
        self.title = title
        self.stream = stream if stream is not None else sys.stdout
        self.values = [[math.nan] * n for _ in range(n)]

    def _w(self, text: str) -> None:
        self.stream.write(text)

    def header(self) -> None:
        # p2p_matrix.cc:134-139 — title line, then "   D\D" + "%6d " ids.
        # Once per matrix, so the native snprintf path (byte-equal to the
        # Python one) runs here; the per-cell path stays %-formatting.
        text = _native.format_header(self.title, self.n)
        if text is None:
            text = f"{self.title}\n   D\\D" + "".join(
                "%6d " % i for i in range(self.n)) + "\n"
        self._w(text)

    def row_label(self, src: int) -> None:
        self._w("%6d " % src)  # p2p_matrix.cc:143

    def cell(self, src: int, dst: int, value: float) -> None:
        # p2p_matrix.cc:179-181 — "%6.02f " then fflush for live progress.
        self.values[src][dst] = value
        self._w("%6.02f " % value)
        self.stream.flush()

    def diagonal(self, i: int) -> None:
        self.cell(i, i, 0.0)  # p2p_matrix.cc:147-151

    def end_row(self) -> None:
        self._w("\n")  # p2p_matrix.cc:184

    def off_diagonal(self):
        return [
            self.values[i][j]
            for i in range(self.n)
            for j in range(self.n)
            if i != j and not math.isnan(self.values[i][j])
        ]

    def summary(self) -> dict:
        cells = self.off_diagonal()
        if not cells:
            return {"min": math.nan, "avg": math.nan, "max": math.nan,
                    "cells": 0}
        return {
            "min": min(cells),
            "avg": sum(cells) / len(cells),
            "max": max(cells),
            "cells": len(cells),
        }

    def print_summary(self, label: str) -> dict:
        s = self.summary()
        self._w(
            f"# {label}: min {s['min']:.2f}  avg {s['avg']:.2f}  "
            f"max {s['max']:.2f}  over {s['cells']} cells\n"
        )
        self.stream.flush()
        return s


def render_matrix(values, title: str,
                  stream: Optional[IO] = None) -> MatrixReporter:
    """Render a complete N×N matrix in one call, in the streaming
    reporter's byte format. NaN or None cells (unmeasured links) print
    as a field-width ``--`` and stay NaN in ``reporter.values``, so a
    dead link (~0.00) stays distinguishable from an unmeasured one."""
    n = len(values)
    rep = MatrixReporter(n, title, stream)
    rep.header()
    for src in range(n):
        rep.row_label(src)
        for dst in range(n):
            v = values[src][dst]
            if src == dst:
                rep.diagonal(src)
            elif v is None or math.isnan(v):
                rep._w("%6s " % "--")
            else:
                rep.cell(src, dst, v)
        rep.end_row()
    return rep


@dataclass
class CellRecord:
    """One measured cell — the JSONL twin of one ``%6.02f`` print."""

    workload: str
    direction: str
    src: int
    dst: int
    msg_bytes: int
    iters: int
    mode: str
    gbps: float
    mean_s: float = math.nan
    p50_s: float = math.nan
    p99_s: float = math.nan
    min_s: float = math.nan
    timed_out: bool = False
    hops: Optional[int] = None
    extra: dict = field(default_factory=dict)

    def key(self) -> tuple:
        return (self.workload, self.direction, self.src, self.dst,
                self.msg_bytes, self.mode)

    def to_json(self) -> str:
        d = dict(self.__dict__)
        extra = d.pop("extra")
        d.update(extra)
        return json.dumps(d, allow_nan=True)


class JsonlWriter:
    """Append-per-cell structured log; the resume checkpoint."""

    def __init__(self, path: Optional[str]) -> None:
        self.path = path
        self._fh = open(path, "a") if path else None

    def write(self, rec: CellRecord) -> None:
        if self._fh:
            self._fh.write(rec.to_json() + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


def load_done_cells(path: Optional[str]) -> dict:
    """Completed cells from a previous run's JSONL → ``{key: gbps}``,
    keyed ``(workload, direction, src, dst, msg_bytes, mode,
    transport)``. Timed-out cells and torn lines are skipped, so a
    rerun with ``--resume`` measures them again."""
    done = {}
    if not path or not os.path.exists(path):
        return done
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
                if d.get("timed_out"):
                    continue
                # Records without a transport were measured over xla.
                key = (d["workload"], d["direction"], d["src"], d["dst"],
                       d["msg_bytes"], d["mode"],
                       d.get("transport", "xla"))
                done[key] = d.get("gbps", math.nan)
            except (json.JSONDecodeError, KeyError):
                continue  # torn write from an interrupted run
    return done
