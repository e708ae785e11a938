"""Topology engine: the measured N×N link matrix as a placement and
routing subsystem — the port of ``tpu_p2p/topo``.

The repo measures the per-link matrix three ways (the ledger's
device-trace join, ``health.probe_link_matrix``, the
``MULTICHIP_r*.json`` history); this package is what *consumes* it:

- :mod:`tpu_p2p_torch.topo.model` — the :class:`Topology` object:
  per-link Gbps with per-cell provenance, built from the best available
  source over an explicit ladder (trace > history > probe > preset),
  unmeasured cells inheriting the fleet median (never 0), degraded links
  fed by :mod:`tpu_p2p_torch.obs.health` verdicts.
- :mod:`tpu_p2p_torch.topo.place` — pure host-side optimizers: ring-order
  selection (maximize the min link on the cycle; the chosen permutation
  reorders the ranks' mesh positions, so payloads stay bitwise) and
  matrix-driven KV-migration placement for
  :mod:`tpu_p2p_torch.serve.disagg` (predicted ship time replaces
  free-pages-first, which demotes to tie-break).
- :mod:`tpu_p2p_torch.topo.smoke` — the graded injected-throttle smoke.
- :mod:`tpu_p2p_torch.topo.cli` — ``python -m tpu_p2p_torch topo``.

Pricing lives where pricing already lives:
``tpu_p2p_torch.models.schedule.price_program(topology=...)`` bills each
tick's hops per link instead of uniform busbw units.
"""

from tpu_p2p_torch.topo.model import Topology
from tpu_p2p_torch.topo.place import (
    ordered_devices,
    ring_min_gbps,
    ring_order,
    ring_order_edges,
    topo_migration_placement,
)

__all__ = [
    "Topology",
    "ring_order",
    "ring_order_edges",
    "ring_min_gbps",
    "ordered_devices",
    "topo_migration_placement",
]
