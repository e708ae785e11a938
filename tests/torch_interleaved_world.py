"""Rank-side case of the port's legacy interleaved executor tests — this
file imports torch, numpy and the port only, never JAX.

``legacy_case`` runs on every rank of a spawned gloo world of 8
(``tpu_p2p_torch.parallel.launch.run_world(8, "<this file>:legacy_case",
kwargs)``): for each case one SGD step of the legacy interleaved executor
(``make_interleaved_train_step_reference``) and of the tick-IR path on a
``dp x pp`` mesh over the world (each dp row its own pipeline), the
legacy GPipe step where the stage count divides the world, and a short
training run → rank 0's losses and stage-major params.
"""

import torch

from tpu_p2p_torch.models import pipeline as PL
from tpu_p2p_torch.models import pipeline_interleaved as IL
from tpu_p2p_torch.parallel.runtime import make_runtime


def _problem(p):
    cfg = PL.PipelineConfig(**p["cfg"])
    params = {k: torch.from_numpy(v) for k, v in p["params"].items()}
    x, t = (torch.from_numpy(a) for a in p["batch"])
    return cfg, params, x, t


def _mesh(world, pp):
    return make_runtime(device="cpu", mesh_shape=(world // pp, pp),
                        axis_names=("dp", "pp")).mesh


def legacy_case(cases, train):
    """``cases``: dicts with ``name``, ``n``, ``v`` and ``problem``
    (``cfg`` keywords, stage-major numpy ``params``, numpy ``batch``);
    ``train``: the same for a 5-step legacy training run → rank 0's
    ``{name: {"legacy", "ir", "gpipe"}}`` (each ``(loss, params)`` or
    None) and the training losses."""
    world = 8
    out = {}
    for c in cases:
        n, v = c["n"], c["v"]
        cfg, params, x, t = _problem(c["problem"])
        mesh = _mesh(world, n)
        res = {}
        for key, make in (("legacy", IL.make_interleaved_train_step_reference),
                          ("ir", IL.make_interleaved_train_step)):
            placed = IL.place_interleaved_params(params, mesh, v)
            new, loss = make(mesh, cfg, v, lr=5e-2)(placed, x, t)
            res[key] = (float(loss),
                        IL.unplace_interleaved_params(new, mesh, v))
        res["gpipe"] = None
        if world % (n * v) == 0:
            gmesh = _mesh(world, n * v)
            placed = PL.place_pipeline_params(params, gmesh)
            new, loss = PL.make_pipeline_train_step_reference(
                gmesh, cfg, lr=5e-2)(placed, x, t)
            ir, ir_loss = PL.make_pipeline_train_step(gmesh, cfg, lr=5e-2)(
                PL.place_pipeline_params(params, gmesh), x, t)
            res["gpipe"] = (float(loss),
                            IL.unplace_interleaved_params(new, gmesh, 1))
            res["gpipe_ir"] = (float(ir_loss),
                               IL.unplace_interleaved_params(ir, gmesh, 1))
        out[c["name"]] = res
    cfg, params, x, t = _problem(train["problem"])
    mesh = _mesh(world, train["n"])
    step = IL.make_interleaved_train_step_reference(mesh, cfg, train["v"],
                                                    lr=5e-2)
    placed = IL.place_interleaved_params(params, mesh, train["v"])
    losses = []
    for _ in range(5):
        placed, loss = step(placed, x, t)
        losses.append(float(loss))
    out["train_losses"] = losses
    rank = mesh.rank
    mesh.runtime.close()
    return out if rank == 0 else None
