"""Rank-side cases of the port's RingTransformer and SP-attention
tests — this file imports torch, numpy and the port only, never JAX.

:func:`model_case` runs on every rank of a spawned gloo world
(``run_world(8, "<this file>:model_case", {"cases": ...})``). Each case
lays its (dp, sp, tp) mesh over the world with a leading ``rep`` axis
that takes the ranks the mesh does not use (the model never reads it:
every ``rep`` group computes the same step), carries the parent's numpy
params and batch in, and returns this rank's results with its mesh
coordinates, so the parent cuts the JAX reference's global arrays to
the same blocks.
"""

import numpy as np
import torch

from tpu_p2p_torch.models import ring_transformer as M
from tpu_p2p_torch.ops import attention as A
from tpu_p2p_torch.ops import ulysses as U
from tpu_p2p_torch.parallel.runtime import local_shard, make_runtime
from tpu_p2p_torch.workloads.sp_common import stage_qkv

BUILDERS = {"ring": A.ring_attention, "ulysses": U.ulysses_attention}


def model_case(cases):
    """``cases``: dicts with ``name``, ``kind`` ("forward", "step" or
    "train"), ``shape`` and ``axes`` (the model's mesh), ``cfg``
    (ModelConfig keywords), ``params`` (global numpy), ``batch`` (two
    global numpy arrays), and ``lr`` / ``steps`` for the steps →
    name → ``{"coords", "shape", "axes", ...}`` with ``out`` (this
    rank's output block), or ``loss`` and ``params`` (this rank's
    shards after the step), or ``losses`` (one a step)."""
    rt = make_runtime(device="cpu")
    out = {}
    for c in cases:
        rep = rt.world // int(np.prod(c["shape"]))
        mesh = rt.axis_mesh((rep, *c["shape"]), ("rep", *c["axes"]))
        cfg = M.ModelConfig(**c["cfg"])
        params = M.params_from_reference(c["params"], "cpu", mesh)
        x, t = (torch.from_numpy(np.ascontiguousarray(
            local_shard(a, mesh, M.data_spec(mesh)))) for a in c["batch"])
        res = {"coords": mesh.coords, "shape": mesh.shape,
               "axes": mesh.axis_names}
        if c["kind"] == "forward":
            res["out"] = M.make_forward(mesh, cfg)(params, x).numpy()
        else:
            step = M.make_train_step(mesh, cfg, lr=c["lr"])
            losses = []
            for _ in range(c.get("steps", 1)):
                params, loss = step(params, x, t)
                losses.append(float(loss))
            res["losses"] = losses
            res["params"] = {k: v.numpy() for k, v in params.items()}
        out[c["name"]] = res
    rt.close()
    return out


def sp_attention_case(cfg, seed, cases):
    """The SP patterns' attention on a line of the world's ranks:
    ``cfg`` (ModelConfig keywords), q, k and v staged as the benchmark
    stages them from ``seed``; ``cases``: ``(name, builder, use_flash,
    window)`` with builder "ring" or "ulysses" → ``{"index": this
    rank's place on the line, name: this rank's output block}``."""
    rt = make_runtime(device="cpu")
    mesh = rt.mesh
    axis = mesh.axis_names[0]
    mc = M.ModelConfig(**cfg)
    q, k, v = stage_qkv(mc, seed, mesh, axis, "cpu")
    out = {"index": mesh.index}
    for name, builder, flash, window in cases:
        fn = BUILDERS[builder](mesh, axis, mc.causal, use_flash=flash,
                               window=window)
        out[name] = fn(q, k, v).numpy()
    rt.close()
    return out
