"""Rank-side case of the port's detection-latency pin — this file
imports torch, numpy and the port only, never JAX.

``straggler_case`` runs on every rank of a spawned gloo world
(``tpu_p2p_torch.parallel.launch.run_world(n, "<this file>:
straggler_case", kwargs)``): the training loop with the obs stream on,
rank 1 sleeping from a known step on, as the health smoke's straggler
scenario runs it.
"""

import json
import os
import tempfile

from tpu_p2p_torch.models import flagship as F
from tpu_p2p_torch.obs import faults
from tpu_p2p_torch.parallel.runtime import make_runtime
from tpu_p2p_torch.train import run_training


def straggler_case(cfg_kw, steps, start, slow_ms):
    """→ the first rank's straggler verdict steps; None elsewhere."""
    rt = make_runtime(device="cpu")
    mesh = F.build_mesh(rt.world, runtime=rt)
    first = rt.rank == 0
    td = rt.broadcast(tempfile.mkdtemp() if first else None, 0)
    path = os.path.join(td, "obs.jsonl")
    run_training(F.FlagshipConfig(**cfg_kw), steps=steps, lr=1e-2,
                 log_every=0, mesh=mesh, obs_jsonl=path,
                 fault_plan=faults.FaultPlan(slow_rank=1, slow_ms=slow_ms,
                                             start_step=start))
    out = None
    if first:
        with open(path) as fh:
            recs = [json.loads(line) for line in fh if line.strip()]
        out = [r["step"] for r in recs if r.get("verdict") == "straggler"]
    rt.close()
    return out
