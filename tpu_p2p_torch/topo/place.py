"""Pure host-side placement optimizers over a :class:`Topology` — the
port of ``tpu_p2p/topo/place.py`` (host code: equal output on equal
input).

Two consumers, one model:

**Ring order** (:func:`ring_order`). Every ring transport of the port
— :func:`~tpu_p2p_torch.parallel.collectives.ring_allgather_matmul`,
the shift rings, the pipeline stage hops through
:func:`~tpu_p2p_torch.parallel.collectives.chunked_ppermute_compute` —
ships the shift-by-1 edge set ``(i, i+1 mod n)`` over the MESH order,
so the mesh order IS the physical routing decision (Pope et al.,
arXiv:2211.05102: ring order decides achieved collective bandwidth).
The optimizer picks the permutation maximizing the **minimum effective
link on the directed cycle** — a ring hop runs all its edges
concurrently, so the slowest link is the hop's wall clock
(:meth:`Topology.ship_time_s`). The permutation is applied by
REORDERING THE MESH POSITIONS (:func:`ordered_devices`): on a world of
processes, the ranks handed to the 1-D ``Mesh``
(:func:`~tpu_p2p_torch.parallel.runtime.make_runtime`), so mesh index
``i`` is global rank ``order[i]``; edge sets are never rewritten —
logical position ``i`` still talks to logical position ``i+1`` through
the identical program, so every payload stays BITWISE (a library sum
over more than 2 ranks adds in rank order, so it reassociates). Exact
search up to :data:`EXACT_MAX` positions (the first fixed — rotations
are the same cycle), greedy fastest-next beyond it.

**KV-migration placement** (:func:`topo_migration_placement`). The
disagg engine's migration of one request ships each prefill rank's
KV head-slice over its own directed link ``(p, n_prefill + shard)``
concurrently (:class:`tpu_p2p_torch.serve.disagg.KvMigrator`), so a
migration to ``shard`` costs the slice bytes over the SLOWEST of that
shard's prefill links — the phase-split KV transfer Splitwise
(arXiv:2311.18677) argues must land on the fast interconnect. The
policy picks the candidate shard with the smallest predicted ship
time; free-pages-first — the whole placement rule without a topology —
demotes to tie-break (then lowest shard index). Degraded links flagged
by the health layer are avoided through :meth:`Topology.effective_gbps`
whenever any alternative shard exists.

Both optimizers read only host data (the model + dry-visible batcher
state), so the disagg dry twin stays event-exact under an injected
policy. When every link is equal (the uniform preset) every order and
every shard ties and both optimizers return the naive choice.
"""

from __future__ import annotations

from itertools import permutations
from typing import Callable, List, Sequence, Tuple

from tpu_p2p_torch.topo.model import Topology

__all__ = [
    "EXACT_MAX",
    "ring_order",
    "ring_order_edges",
    "ring_min_gbps",
    "ordered_devices",
    "free_pages_first",
    "migration_edges",
    "predict_migrate_time_s",
    "topo_migration_placement",
    "rank_decode_shards",
]

# Exact ring-order search bound: (n-1)! permutations with position 0
# fixed — 5040 at n=8, instant on a host; past it the greedy
# fastest-next heuristic takes over.
EXACT_MAX = 8


def ring_order_edges(order: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """The PHYSICAL directed edges a shift-by-1 ring rides when the
    mesh devices are ordered ``order``: logical hop ``i → i+1``
    crosses physical link ``order[i] → order[i+1 mod n]``."""
    n = len(order)
    return tuple((int(order[i]), int(order[(i + 1) % n]))
                 for i in range(n))


def ring_min_gbps(topo: Topology, order: Sequence[int],
                  effective: bool = True) -> float:
    """The ring objective: min Gbps over the cycle's directed edges —
    the bottleneck link every hop waits on. ``effective=True`` is the
    routing view (degraded penalty applied — what the optimizer
    maximizes); ``effective=False`` is the reporting view (modeled
    physical bandwidth — what a published gain must be denominated
    in; :meth:`Topology.ship_time_s` draws the same line)."""
    return min(topo.effective_gbps(s, d) if effective
               else topo.link_gbps(s, d)
               for s, d in ring_order_edges(order))


def _greedy_ring_order(topo: Topology) -> Tuple[int, ...]:
    """Fastest-next construction: from device 0, repeatedly append
    the unvisited device with the fastest effective link from the
    cycle's current tail (ties to the lowest index)."""
    n = topo.n
    order = [0]
    left = set(range(1, n))
    while left:
        cur = order[-1]
        nxt = max(sorted(left),
                  key=lambda d: (topo.effective_gbps(cur, d), -d))
        order.append(nxt)
        left.remove(nxt)
    return tuple(order)


def ring_order(topo: Topology,
               exact_max: int = EXACT_MAX) -> Tuple[int, ...]:
    """The position order whose shift-by-1 ring maximizes the minimum
    effective link on the directed cycle.

    Position 0 is fixed first (a rotation is the same cycle; direction
    is NOT canonicalized — the matrix is directed). Exhaustive for
    ``n <= exact_max`` with ties broken to the lexicographically
    smallest order (deterministic across runs — the golden/CLI
    contract); greedy fastest-next beyond. ``n <= 2`` has one cycle —
    the identity returns unchanged (the degenerate-mesh contract the
    bench nulls name)."""
    n = topo.n
    if n <= 2:
        return tuple(range(n))
    if n <= exact_max:
        best_order = tuple(range(n))
        best_val = ring_min_gbps(topo, best_order)
        for rest in permutations(range(1, n)):
            order = (0,) + rest
            val = ring_min_gbps(topo, order)
            # Strict improvement only: iteration is lexicographic, so
            # the first optimum seen (the lex-smallest) is kept.
            if val > best_val:
                best_order, best_val = order, val
        return best_order
    greedy = _greedy_ring_order(topo)
    # Keep whichever of {identity, greedy} bottlenecks less — the
    # heuristic must never do worse than doing nothing.
    if ring_min_gbps(topo, greedy) > ring_min_gbps(
            topo, tuple(range(n))):
        return greedy
    return tuple(range(n))


def ordered_devices(devices, order: Sequence[int]) -> list:
    """Permute a device (or rank) list by a ring order — the list a 1-D
    mesh is laid over, so the logical shift-by-1 ring rides the chosen
    physical links. Pure relabeling of which physical device backs which
    logical position: the program (and therefore every computed value)
    is unchanged."""
    devices = list(devices)
    if sorted(order) != list(range(len(devices))):
        raise ValueError(
            f"order {tuple(order)} is not a permutation of "
            f"0..{len(devices) - 1}"
        )
    return [devices[i] for i in order]


# ------------------------------------------------- migration placement


def free_pages_first(blocks: int,
                     candidates: Sequence[Tuple[int, int]],
                     block_bytes: int) -> int:
    """The pre-topology placement rule, verbatim: most free pages
    first, ties to the lowest shard index. The ``placement=None``
    default of :class:`tpu_p2p_torch.serve.disagg.DisaggBatcher` — and
    the topo policy's tie-break."""
    return min(candidates, key=lambda c: (-c[1], c[0]))[0]


def migration_edges(n_prefill: int,
                    shard: int) -> Tuple[Tuple[int, int], ...]:
    """The directed mig-mesh links one migration to decode ``shard``
    exercises: each prefill rank ships its head-slice over its own
    edge ``(p, n_prefill + shard)`` (the
    :class:`~tpu_p2p_torch.serve.disagg.KvMigrator` ship bodies)."""
    dst = int(n_prefill) + int(shard)
    return tuple((p, dst) for p in range(int(n_prefill)))


def predict_migrate_time_s(topo: Topology, n_prefill: int, shard: int,
                           block_bytes: int,
                           effective: bool = True) -> float:
    """Predicted wall seconds of one migration of ``block_bytes``
    (full heads, K+V — :meth:`KvMigrator.block_bytes`) to decode
    ``shard``: each prefill link carries its ``1/n_prefill`` head
    slice concurrently, so the slowest of the shard's prefill links
    bounds the move. ``effective`` as in :func:`ring_min_gbps` —
    routing view vs reporting view."""
    slice_bytes = max(1, int(block_bytes) // max(int(n_prefill), 1))
    return topo.ship_time_s(slice_bytes,
                            migration_edges(n_prefill, shard),
                            effective=effective)


def topo_migration_placement(topo: Topology, n_prefill: int
                             ) -> Callable[[int, Sequence[Tuple[int, int]], int], int]:
    """→ a placement policy for
    :class:`tpu_p2p_torch.serve.disagg.DisaggBatcher`: among the candidate
    ``(shard, free_pages)`` pairs (shards with a free slot AND enough
    pages — the batcher's dry-visible eligibility), pick the smallest
    predicted ship time; ties fall back to free-pages-first (most
    free, then lowest shard — zero behavior change on a symmetric
    mesh, where every prediction ties)."""
    n_prefill = int(n_prefill)

    def place(blocks: int, candidates: Sequence[Tuple[int, int]],
              block_bytes: int) -> int:
        return min(
            candidates,
            key=lambda c: (predict_migrate_time_s(
                topo, n_prefill, c[0], block_bytes), -c[1], c[0]),
        )[0]

    return place


def rank_decode_shards(topo: Topology, n_prefill: int, n_decode: int,
                       block_bytes: int) -> List[Tuple[int, float]]:
    """Every decode shard with its predicted migration Gbps for a
    ``block_bytes`` move, best first — the CLI's recommendation table
    (``python -m tpu_p2p_torch topo``). Ranked in the ROUTING view (a
    degraded shard sorts last, like the placer would place) but the
    Gbps shown is the REPORTING view — published magnitudes state
    what the wire would do, never the avoidance bias
    (:func:`ring_min_gbps` draws the same line)."""
    rows = []
    for s in range(int(n_decode)):
        t_route = predict_migrate_time_s(topo, n_prefill, s,
                                         block_bytes)
        t_phys = predict_migrate_time_s(topo, n_prefill, s,
                                        block_bytes, effective=False)
        gbps = (int(block_bytes) * 8 / t_phys / 1e9) if t_phys > 0 \
            else 0.0
        rows.append((s, gbps, t_route))
    rows.sort(key=lambda r: (r[2], r[0]))
    return [(s, gbps) for s, gbps, _ in rows]
