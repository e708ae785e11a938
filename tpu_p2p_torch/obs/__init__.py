"""Observability, health and fault injection of the port — the port of
``tpu_p2p/obs``:

- :mod:`~tpu_p2p_torch.obs.ledger`: the collective ledger, recorded where
  every collective of :mod:`tpu_p2p_torch.parallel.collectives` and
  :mod:`~tpu_p2p_torch.parallel.fsdp` issues, and its join against a
  rank's ``torch.profiler`` window (per-kind and per-link achieved Gbps);
- :mod:`~tpu_p2p_torch.obs.timeline`: span-timed step rows and the
  profiled window's record behind ``train --obs-jsonl``;
- :mod:`~tpu_p2p_torch.obs.health`: the degraded-link, straggler and
  lost-host detectors, the monitor, ``obs watch`` and ``obs smoke``;
- :mod:`~tpu_p2p_torch.obs.regress`: the bench trajectory gate and
  ``python -m tpu_p2p_torch obs``;
- :mod:`~tpu_p2p_torch.obs.faults`: the deterministic fault plans;
- :mod:`~tpu_p2p_torch.obs.trace`: the Chrome-trace exporter.

Import-light: :mod:`~tpu_p2p_torch.parallel.collectives` imports the
ledger at load, so nothing here imports the parallel or model layers at
module scope.
"""
