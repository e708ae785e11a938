"""Rank-side case of the port's checkpoint-chaos tests — this file imports
torch, numpy and the port only, never JAX.

``heal_case`` runs on every rank of a spawned gloo world of 8
(``tpu_p2p_torch.parallel.launch.run_world(8, "<this file>:heal_case",
kwargs)``): the heal over a checkpoint ladder whose newest generation
was rotted, on the five-axis mesh over the world.
"""

import os

from tpu_p2p_torch.models import flagship as F
from tpu_p2p_torch.obs import faults
from tpu_p2p_torch.parallel.runtime import make_runtime
from tpu_p2p_torch.train import run_training, run_training_with_heal


def heal_case(cfg_kw, ckpt_dir):
    """Seed generations 2 and 4, rot the newest, then a heal-protected
    resumed run that loses host 7 at step 3 → the first rank's summary
    (``heal`` and ``ckpt_resume``); None elsewhere."""
    rt = make_runtime(device="cpu")
    mesh = F.build_mesh(rt.world, runtime=rt)
    cfg = F.FlagshipConfig(**cfg_kw)
    run_training(cfg, steps=4, lr=1e-2, log_every=0, ckpt_dir=ckpt_dir,
                 ckpt_every=2, mesh=mesh)
    if rt.rank == 0:
        fp = os.path.join(ckpt_dir, "gen-000004", "params.npz")
        with open(fp, "rb") as fh:
            data = bytearray(fh.read())
        data[len(data) // 2] ^= 1
        with open(fp, "wb") as fh:
            fh.write(bytes(data))
    rt.barrier()
    out = run_training_with_heal(
        cfg, steps=8, lr=1e-2, log_every=0, ckpt_dir=ckpt_dir,
        ckpt_every=10, mesh=mesh, resume=True,
        obs_jsonl=os.path.join(ckpt_dir, "obs.jsonl"),
        fault_plan=faults.FaultPlan(lost_host=7, start_step=3))
    first = rt.rank == 0
    res = ({"heal": out["heal"], "ckpt_resume": out.get("ckpt_resume")}
           if first else None)
    rt.close()
    return res
