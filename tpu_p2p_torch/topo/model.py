"""The topology model: per-link Gbps + per-cell provenance — the port
of ``tpu_p2p/topo/model.py`` (host code: equal output on equal input).

One object (:class:`Topology`) answers "how fast is the directed link
``s → d``?" for every consumer that routes bytes — the ring-order
optimizer, the KV-migration placer (:mod:`tpu_p2p_torch.topo.place`), and
the per-link tick pricer
(:func:`tpu_p2p_torch.models.schedule.price_program`). It is constructed
from the best available source over an explicit provenance ladder:

1. **trace** — a measured device-trace link matrix (a ledger join's
   :meth:`~tpu_p2p_torch.obs.ledger.TraceJoin.link_matrix`, or a
   ``MULTICHIP_r*.json`` artifact written from one): the paper's own
   deliverable, device-timed per directed link.
2. **history** — the elementwise best over the repo's
   ``MULTICHIP_r*.json`` sequence
   (:func:`tpu_p2p_torch.obs.regress.load_multichip_history`), with
   trace-measured cells preferred over host-timed probe cells
   whatever their magnitudes (artifacts carry ``source: "trace" |
   "probe"``; legacy artifacts count as trace). Only
   ``obs_link_matrix`` artifacts count: the repo's own
   ``MULTICHIP_r01``–``r05`` are TPU runs of another kind, so they yield
   no history and never price or order a ring of cards.
3. **probe** — :func:`tpu_p2p_torch.obs.health.probe_link_matrix`,
   the host-timed per-edge chains of the world's ranks. The probe
   issues its per-edge chains UNDER the active
   :class:`~tpu_p2p_torch.obs.faults.FaultPlan`, so an injected link
   throttle is visible to the model — which is what makes the whole
   subsystem gradeable on a gloo world of CPU ranks.
4. **preset** — analytic fallbacks: ``uniform`` (every link equal) and
   ``ring`` (cells scale with minimal ring hop distance);
   :func:`Topology.preset_torus` takes any object with ``coords`` and
   ``hops(s, d)`` (the reference's ``TorusInfo``; one card has no
   torus, so the port builds none itself).

Whatever the rung, **unmeasured cells inherit the fleet median, never
0** (provenance ``"median"``): an unprobed link is *unknown*, not
*dead* — the same NaN-vs-slow distinction the health detector draws
(:func:`tpu_p2p_torch.obs.health.fleet_median`). Degraded links flagged
by :func:`tpu_p2p_torch.obs.health.detect_degraded_links` verdicts are
marked
via :meth:`Topology.mark_degraded`; the optimizers consult
:meth:`Topology.effective_gbps`, which scales a flagged link by
:data:`DEGRADED_PENALTY` so placement avoids it whenever ANY
alternative exists, while keeping a total order when none does
(avoidance is a preference, never a refusal — starvation-free).

Host-pure by design: this module imports no torch at module scope and
issues no device work itself (:meth:`Topology.from_probe` defers to
the health probe).
"""

from __future__ import annotations

import math
import statistics
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Set, Tuple

__all__ = ["Topology", "DEGRADED_PENALTY", "PROVENANCE_LETTERS"]

# Effective-bandwidth multiplier for links the health layer flagged
# degraded: small enough that a min-link or bottleneck objective
# avoids the edge whenever any alternative exists, nonzero so the
# ordering among all-degraded options stays meaningful (avoidance is
# a preference, not a refusal).
DEGRADED_PENALTY = 1e-6

# One-letter render codes (the CLI matrix).
PROVENANCE_LETTERS = {
    "trace": "T",
    "probe": "P",
    "preset": "A",
    "median": "M",
}


def _finite(v) -> bool:
    return (isinstance(v, (int, float)) and not isinstance(v, bool)
            and v == v and not math.isinf(v) and v > 0)


@dataclass
class Topology:
    """Per-link Gbps + provenance for an ``n``-device mesh.

    ``gbps[s][d]`` is the modeled achieved Gbps of the directed link
    ``s → d`` (diagonal 0.0 — a self-edge is not a link);
    ``provenance[s][d]`` names where each off-diagonal cell came from
    (``"trace" | "probe" | "preset" | "median"``); ``source`` names
    the ladder rung the whole model was built from (``"trace" |
    "history" | "probe" | "preset"``). ``degraded`` is the set of
    directed edges the health layer flagged (:meth:`mark_degraded`).
    """

    n: int
    gbps: List[List[float]]
    provenance: List[List[str]]
    source: str
    degraded: Set[Tuple[int, int]] = field(default_factory=set)

    # ------------------------------------------------------ builders

    @classmethod
    def from_matrix(cls, matrix, source: str,
                    n: Optional[int] = None) -> "Topology":
        """Build from one N×N matrix (NaN/None = unmeasured, the
        ``link_matrix`` contract). Unmeasured off-diagonal cells
        inherit the fleet median over the measured cells (provenance
        ``"median"``); a matrix with NO measured off-diagonal cell is
        refused — a model with nothing behind it would silently rank
        every placement equal."""
        if n is None:
            n = max(len(matrix),
                    max((len(r) for r in matrix), default=0))
        cells = []
        for i in range(min(n, len(matrix))):
            row = matrix[i]
            for j in range(min(n, len(row))):
                if i != j and _finite(row[j]):
                    cells.append(float(row[j]))
        if not cells:
            raise ValueError(
                f"no measured off-diagonal link in the {source} "
                "matrix — nothing to model (probe or preset instead)"
            )
        med = float(statistics.median(cells))
        g = [[0.0] * n for _ in range(n)]
        prov = [["-"] * n for _ in range(n)]
        for i in range(n):
            for j in range(n):
                if i == j:
                    continue
                v = None
                if i < len(matrix) and j < len(matrix[i]):
                    v = matrix[i][j]
                if _finite(v):
                    g[i][j] = float(v)
                    prov[i][j] = source
                else:
                    g[i][j] = float(med)
                    prov[i][j] = "median"
        return cls(n=n, gbps=g, provenance=prov, source=source)

    @classmethod
    def from_history(cls, artifacts_dir: str = ".",
                     n: Optional[int] = None) -> Optional["Topology"]:
        """Build from the ``MULTICHIP_r*.json`` sequence: per-cell
        best with trace-measured cells preferred over probe cells
        (:func:`tpu_p2p_torch.obs.regress.load_multichip_history`
        ``with_sources=True``). → None when no usable history exists
        (the ladder falls through to the probe)."""
        from tpu_p2p_torch.obs.regress import load_multichip_history

        got = load_multichip_history(artifacts_dir, with_sources=True)
        if got is None:
            return None
        best, sources = got
        try:
            topo = cls.from_matrix(best, "trace", n=n)
        except ValueError:
            return None
        # Re-stamp per-cell provenance from the artifact sources (the
        # builder stamped everything measured as its rung name).
        for i in range(topo.n):
            for j in range(topo.n):
                if topo.provenance[i][j] in ("trace",) \
                        and i < len(sources) and j < len(sources[i]) \
                        and sources[i][j] is not None:
                    topo.provenance[i][j] = sources[i][j]
        topo.source = "history"
        return topo

    @classmethod
    def from_probe(cls, mesh, *, edges=None,
                   msg_bytes: int = 1024 * 1024, iters: int = 8,
                   repeats: int = 2) -> "Topology":
        """Probe the mesh's links host-timed and model the result
        (every rank of the 1-D process ``mesh`` calls it; the matrix is
        the same on every rank).

        Defers to :func:`tpu_p2p_torch.obs.health.probe_link_matrix`,
        which issues each per-edge chain under the active
        :class:`~tpu_p2p_torch.obs.faults.FaultPlan` — an injected
        throttle is therefore visible in the model (the smoke's grade).
        ``edges`` defaults to the shift-by-1 ring; pass the union of
        every edge set a consumer routes over (the smoke probes ring
        ∪ prefill×decode bipartite) for full coverage — unprobed
        cells inherit the fleet median like any unmeasured cell.
        """
        from tpu_p2p_torch.obs.health import probe_link_matrix

        mat = probe_link_matrix(mesh, edges=edges,
                                msg_bytes=msg_bytes, iters=iters,
                                repeats=repeats)
        return cls.from_matrix(mat, "probe")

    @classmethod
    def preset_uniform(cls, n: int,
                       link_gbps: float = 100.0) -> "Topology":
        """Every directed link equal — the no-information analytic
        fallback (uniform cost: exactly what the repo priced before
        this subsystem existed)."""
        if n < 1:
            raise ValueError(f"need n >= 1, got {n}")
        g = [[0.0 if i == j else float(link_gbps) for j in range(n)]
             for i in range(n)]
        prov = [["-" if i == j else "preset" for j in range(n)]
                for i in range(n)]
        return cls(n=n, gbps=g, provenance=prov, source="preset")

    @classmethod
    def preset_ring(cls, n: int,
                    link_gbps: float = 100.0) -> "Topology":
        """1D ring/torus preset: cell ``s → d`` scales inversely
        with the minimal ring hop distance (nearest neighbors at
        ``link_gbps``, a k-hop pair at ``link_gbps / k`` — the
        store-and-forward bound on a wrap ring)."""
        if n < 1:
            raise ValueError(f"need n >= 1, got {n}")
        g = [[0.0] * n for _ in range(n)]
        prov = [["-" if i == j else "preset" for j in range(n)]
                for i in range(n)]
        for i in range(n):
            for j in range(n):
                if i == j:
                    continue
                d = abs(i - j)
                hops = min(d, n - d) if n > 1 else 1
                g[i][j] = float(link_gbps) / max(hops, 1)
        return cls(n=n, gbps=g, provenance=prov, source="preset")

    @classmethod
    def preset_torus(cls, torus,
                     link_gbps: float = 100.0) -> "Topology":
        """Torus preset from an object with ``coords`` and ``hops(s,
        d)`` (the reference's ``TorusInfo``): cell ``s → d`` =
        ``link_gbps / hops(s, d)`` (wraparound Manhattan distance)."""
        n = len(torus.coords)
        g = [[0.0] * n for _ in range(n)]
        prov = [["-" if i == j else "preset" for j in range(n)]
                for i in range(n)]
        for i in range(n):
            for j in range(n):
                if i != j:
                    g[i][j] = float(link_gbps) / max(torus.hops(i, j),
                                                     1)
        return cls(n=n, gbps=g, provenance=prov, source="preset")

    @classmethod
    def best_available(cls, n: int, *, trace_matrix=None,
                       artifacts_dir: str = ".", mesh=None,
                       probe_kwargs: Optional[dict] = None
                       ) -> "Topology":
        """The provenance ladder: measured device-trace matrix >
        ``MULTICHIP_r*.json`` history floors > host-timed probe (needs
        a 1-D process ``mesh`` of >= 2 ranks; runs under the active
        FaultPlan) >
        analytic uniform preset. Each rung is tried in order and the
        first that yields a model wins; ``topology.source`` names it."""
        if trace_matrix is not None:
            try:
                return cls.from_matrix(trace_matrix, "trace", n=n)
            except ValueError:
                pass
        topo = cls.from_history(artifacts_dir, n=n)
        if topo is not None:
            return topo
        if mesh is not None and n >= 2:
            try:
                return cls.from_probe(mesh, **(probe_kwargs or {}))
            except ValueError:
                pass
        return cls.preset_uniform(n)

    # ------------------------------------------------------- queries

    def link_gbps(self, s: int, d: int) -> float:
        """Modeled Gbps of the directed link ``s → d`` (0.0 on the
        diagonal — a self-edge is not a link)."""
        return self.gbps[s][d]

    def effective_gbps(self, s: int, d: int) -> float:
        """The optimizer-facing bandwidth: the modeled Gbps, scaled
        by :data:`DEGRADED_PENALTY` when the health layer flagged the
        edge — degraded-link avoidance without ever refusing
        placement outright."""
        v = self.gbps[s][d]
        if (s, d) in self.degraded:
            return v * DEGRADED_PENALTY
        return v

    def fleet_median(self) -> Optional[float]:
        """Median modeled Gbps over the off-diagonal cells."""
        cells = [self.gbps[i][j] for i in range(self.n)
                 for j in range(self.n) if i != j]
        return float(statistics.median(cells)) if cells else None

    def worst_links(self, k: int = 3) -> List[Tuple[int, int, float]]:
        """The ``k`` slowest directed links by *effective* Gbps
        (degraded-flagged links sort first) — the CLI's hot list."""
        cells = [(i, j, self.gbps[i][j])
                 for i in range(self.n) for j in range(self.n)
                 if i != j]
        cells.sort(key=lambda c: (self.effective_gbps(c[0], c[1]),
                                  c[0], c[1]))
        return cells[:max(0, int(k))]

    def mark_degraded(self, flags: Sequence[dict]) -> int:
        """Feed health verdicts into the model: ``flags`` is the
        :func:`tpu_p2p_torch.obs.health.detect_degraded_links` output (or
        a ``degraded_link`` verdict's ``detail["links"]`` list) —
        each ``{"src", "dst", ...}`` edge joins :attr:`degraded`.
        → how many new edges were marked."""
        before = len(self.degraded)
        for f in flags:
            s, d = int(f["src"]), int(f["dst"])
            if 0 <= s < self.n and 0 <= d < self.n and s != d:
                self.degraded.add((s, d))
        return len(self.degraded) - before

    def ship_time_s(self, nbytes: int,
                    edges: Sequence[Tuple[int, int]],
                    effective: bool = True) -> float:
        """Predicted wall time of ONE concurrent ship of ``nbytes``
        per directed edge over ``edges`` — the slowest link bounds the
        whole transfer (a hop's library send/recv and the peer-push
        kernels run every edge of a hop concurrently, the
        :meth:`~tpu_p2p_torch.obs.ledger.TraceJoin.link_matrix`
        convention),
        so the hop costs ``nbytes*8 / min(link Gbps)``.

        ``effective=True`` (the ROUTING view) applies the degraded
        penalty so optimizers steer away from flagged links;
        ``effective=False`` (the REPORTING view) prices the modeled
        physical bandwidth — published gains and bills must state
        what the wire would actually do, not the avoidance bias."""
        worst = None
        for s, d in edges:
            g = (self.effective_gbps(int(s), int(d)) if effective
                 else self.gbps[int(s)][int(d)])
            t = (int(nbytes) * 8 / (g * 1e9)) if g > 0 else math.inf
            worst = t if worst is None else max(worst, t)
        return worst if worst is not None else 0.0

    def bottleneck_edge(self, edges: Sequence[Tuple[int, int]],
                        effective: bool = True
                        ) -> Optional[Tuple[int, int]]:
        """The slowest edge of a hop's edge set — the link whose wall
        clock the hop is. ``effective`` as in :meth:`ship_time_s`:
        routing view (penalty applied) vs reporting view (modeled
        physical Gbps)."""
        best = None
        for s, d in edges:
            g = (self.effective_gbps(int(s), int(d)) if effective
                 else self.gbps[int(s)][int(d)])
            if best is None or g < best[0]:
                best = (g, (int(s), int(d)))
        return best[1] if best is not None else None
