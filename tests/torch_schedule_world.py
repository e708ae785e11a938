"""Rank-side cases of the port's tick-IR tests — this file imports torch,
numpy and the port only, never JAX.

``schedule_case`` runs on every rank of a spawned gloo world
(``tpu_p2p_torch.parallel.launch.run_world(n, "<this file>:
schedule_case", kwargs)``): one ``make_tick_train_step`` SGD step a
case on the generic residual-MLP pipeline, on a mesh laid over the
world, and returns what the parent compares with the JAX reference and
across the port's own runs. ``flagship_case`` does the same for
``make_flagship_train_step_1f1b`` on five-axis meshes.
"""

import numpy as np
import torch

from tpu_p2p_torch.models import flagship as F
from tpu_p2p_torch.models import pipeline as PL
from tpu_p2p_torch.models import pipeline_interleaved as IL
from tpu_p2p_torch.models import schedule as S
from tpu_p2p_torch.parallel.runtime import make_runtime


def pipeline_problem(stages, m, b=8, t=8, d=16, f=32, seed=0):
    """The reference's ``pipeline_setup`` (tests/conftest.py) in torch:
    (cfg, stage-major params, x, target), the same draws."""
    cfg = PL.PipelineConfig(d_model=d, d_ff=f, stages=stages,
                            microbatches=m)
    params = PL.init_pipeline_params(cfg, seed=seed)
    rng = np.random.default_rng(seed + 1)
    x = torch.from_numpy(rng.standard_normal((b, t, d))).float()
    target = torch.from_numpy(rng.standard_normal((b, t, d))).float()
    return cfg, params, x, target


def _program(kind, m, n, v):
    return {"gpipe": lambda: S.compile_gpipe(m, n),
            "1f1b": lambda: S.compile_1f1b(m, n),
            "interleaved": lambda: S.compile_interleaved(m, n, v),
            "zb": lambda: S.compile_zb(m, n)}[kind]()


def schedule_case(meshes, cases):
    """``meshes``: name → (dims, axis names) laid over the world;
    ``cases``: dicts with ``name``, ``mesh``, ``program`` (gpipe, 1f1b,
    interleaved or zb), ``chunks`` (interleaved), ``stages``, ``m`` and
    the step's ``lowering``, ``pp_overlap``, ``pp_chunks`` and
    ``transport`` → name → ``{"loss", "params"}``: the step's loss and
    the updated params, stage-major float32 numpy (rank 0; None
    elsewhere)."""
    made, rt = {}, None
    for name, (dims, axes) in meshes.items():
        rt = make_runtime(device="cpu", mesh_shape=tuple(dims),
                          axis_names=tuple(axes))
        made[name] = rt.mesh
    out = {}
    for c in cases:
        mesh = made[c["mesh"]]
        n = mesh.line("pp").size
        v = c.get("chunks", 1)
        cfg, params, x, target = pipeline_problem(c["stages"], c["m"])
        placed = (IL.place_interleaved_params(params, mesh, v) if v > 1
                  else PL.place_pipeline_params(params, mesh))
        step = S.make_tick_train_step(
            mesh, cfg, _program(c["program"], c["m"], n, v), lr=5e-2,
            pp_overlap=c.get("pp_overlap", "none"),
            pp_chunks=c.get("pp_chunks", 1),
            transport=c.get("transport", "xla"),
            tick_lowering=c.get("lowering", "masked"))
        new, loss = step(placed, x, target)
        full = IL.unplace_interleaved_params(new, mesh, v)
        out[c["name"]] = {
            "loss": float(loss),
            "params": full if mesh.index == 0 else None,
        }
    rt.close()
    return out


def flagship_case(cases):
    """``cases``: dicts with ``name``, ``dims`` (dp, pp, sp, tp, ep),
    ``cfg`` (FlagshipConfig keywords) and ``chunks`` → name → ``{"loss",
    "params"}``: one ``make_flagship_train_step_1f1b`` step from the
    seeded init on the seeded batch, the updated params gathered and
    stage-major (rank 0; None elsewhere)."""
    out, mesh = {}, None
    for c in cases:
        mesh = F.build_mesh(int(np.prod(c["dims"])), device="cpu",
                            dims=c["dims"])
        cfg = F.FlagshipConfig(**c["cfg"])
        chunks = c.get("chunks", 1)
        fp = F.FlagshipPipelined(mesh, cfg, chunks=chunks, lr=1e-2)
        params = fp.place(F.init_flagship_params(cfg, device="cpu"))
        spec = F.flagship_data_spec(mesh)
        x, t = (F.local_shard(a, mesh, spec).contiguous()
                for a in F.flagship_host_batch(cfg,
                                               np.random.default_rng(1)))
        new, loss = fp.step(params, x, t)
        full = fp.unplace(new)
        out[c["name"]] = {
            "loss": float(loss),
            "params": ({k: v.float().numpy() for k, v in full.items()}
                       if mesh.index == 0 else None),
        }
    mesh.runtime.close()
    return out
