"""Rank-side case of the port's flight-recorder tests — this file imports
torch, numpy and the port only, never JAX.

``recorder_case`` runs on every rank of a spawned gloo world
(``tpu_p2p_torch.parallel.launch.run_world(n, "<this file>:
recorder_case", kwargs)``): :func:`tpu_p2p_torch.obs.tickprof.
run_flight_recorder` once a run, on the world's pp line, and returns the
first rank's reports.
"""

from tpu_p2p_torch.obs import tickprof as TP
from tpu_p2p_torch.parallel.runtime import make_runtime


def recorder_case(runs):
    """``runs``: name → ``run_flight_recorder`` keywords → name → report
    (rank 0; None elsewhere)."""
    rt = make_runtime(device="cpu")
    out = {name: TP.run_flight_recorder(rt, **kw)
           for name, kw in runs.items()}
    rank = rt.rank
    rt.close()
    return out if rank == 0 else None
