"""Rank-side cases of the port's flagship mesh tests — this file imports
torch, numpy and the port only, never JAX.

Each ``*_case`` function runs on every rank of a spawned gloo world
(``tpu_p2p_torch.parallel.launch.run_world(n, "<this file>:<case>",
kwargs)``), builds one five-axis mesh a case over the same world, and
returns what the parent compares with the JAX reference it computed on
its 8-device CPU mesh from the same numpy inputs.
"""

import os

import numpy as np
import torch

from tpu_p2p_torch.models import flagship as F
from tpu_p2p_torch.ops.attention import ring_attention_local
from tpu_p2p_torch.ops.ulysses import ulysses_attention_local
from tpu_p2p_torch.parallel.runtime import local_shard


def _close(mesh):
    """Leave the world once the last case is done."""
    mesh.runtime.close()


def step_case(cases):
    """One SGD step a case: ``cases`` is a list of dicts with ``name``,
    ``dims`` (dp, pp, sp, tp, ep), ``cfg`` (FlagshipConfig keywords),
    ``params`` (numpy, global), ``batch`` (two global numpy arrays) and
    ``lr`` → name → ``{"loss", "params"}``: the step's loss on this rank
    and, on rank 0, the updated params gathered to global arrays (the
    config's specs: ZeRO shards included). A case with ``"grads":
    True`` runs the grad function instead: ``params`` are then the
    gathered gradients, and ``shapes`` each leaf's (grad, param) shard
    shapes on this rank."""
    out, mesh = {}, None
    for c in cases:
        mesh = F.build_mesh(int(np.prod(c["dims"])), device="cpu",
                            dims=c["dims"])
        cfg = F.FlagshipConfig(**c["cfg"])
        params = F.place_flagship_params(c["params"], mesh, cfg)
        spec = F.flagship_data_spec(mesh)
        x, t = (torch.from_numpy(np.ascontiguousarray(
            local_shard(a, mesh, spec[:a.ndim]))) for a in c["batch"])
        res = {}
        if c.get("grads"):
            make = (F.make_flagship_lm_grad_fn if cfg.vocab
                    else F.make_flagship_grad_fn)
            new, loss = make(cfg, mesh=mesh)(params, x, t)
            res["shapes"] = {k: (tuple(new[k].shape), tuple(v.shape))
                             for k, v in params.items()}
        else:
            make = (F.make_flagship_lm_train_step if cfg.vocab
                    else F.make_flagship_train_step)
            new, loss = make(cfg, lr=c["lr"], mesh=mesh)(params, x, t)
        full = F.gather_flagship_params(new, mesh, cfg)
        res["loss"] = float(loss)
        res["params"] = ({k: v.numpy() for k, v in full.items()}
                         if mesh.rank == 0 else None)
        out[c["name"]] = res
    _close(mesh)
    return out


def bucket_case(cases):
    """:func:`bucketed_all_gather` over the dp line of a world of dp
    ranks: ``cases`` is a list of dicts with ``name``, ``leaves``
    (name → (global numpy array, gather dim)), ``bf16`` (the leaves
    cast to bfloat16), ``bucket_bytes`` and ``cot`` (name → numpy ``[world, *global shape]``, rank ``r``'s
    cotangent at ``[r]``) → name → ``(bucketed, per_leaf, grads)``:
    the gathered leaves in one collective a bucket and one a leaf, and
    the shards' gradients of ``sum(out * cot[r])``, as float32 (exact
    for bfloat16 leaves)."""
    from tpu_p2p_torch.parallel.collectives import bucketed_all_gather

    n = int(os.environ["WORLD_SIZE"])
    mesh = F.build_mesh(n, device="cpu", dims=(n, 1, 1, 1, 1))
    line = mesh.line("dp")
    out = {}
    for c in cases:
        shards = {}
        for k, (a, d) in c["leaves"].items():
            spec = [None] * a.ndim
            spec[d] = "dp"
            t = torch.from_numpy(np.ascontiguousarray(
                local_shard(a, mesh, spec)))
            if k in c["bf16"]:
                t = t.bfloat16()
            shards[k] = (t.requires_grad_(True), d)
        got = bucketed_all_gather(shards, line, c["bucket_bytes"])
        one = {k: bucketed_all_gather({k: sd}, line)[k]
               for k, sd in shards.items()}
        loss = sum(torch.sum(got[k] * torch.from_numpy(c["cot"][k][line.index]))
                   for k in got)
        grads = torch.autograd.grad(loss, [v for v, _ in shards.values()])
        out[c["name"]] = tuple(
            {k: v.detach().float().numpy() for k, v in d.items()}
            for d in (got, one, dict(zip(shards, grads))))
    _close(mesh)
    return out


def attention_case(cases, world=8):
    """Sequence-parallel attention alone on a world of ``world`` ranks:
    ``cases`` is a list of dicts
    with ``name``, ``sp`` (the line's size; the rest of the world is
    dp), ``kind`` (``ring`` or ``ulysses``), ``layout``, ``use_flash``,
    ``causal``, ``window`` and global numpy ``q, k, v, g`` (``[B, H, T,
    D]``, the sequence in the layout's order) → name → this rank's
    ``(sp index, out, dq, dk, dv)`` blocks, the grads of ``sum(out *
    g)``."""
    out, mesh = {}, None
    for c in cases:
        dims = (world // c["sp"], 1, c["sp"], 1, 1)
        mesh = F.build_mesh(world, device="cpu", dims=dims)
        line = mesh.line("sp")
        spec = (None, None, "sp", None)
        q, k, v, g = (torch.from_numpy(np.ascontiguousarray(
            local_shard(c[n], mesh, spec))) for n in "qkvg")
        q, k, v = (a.requires_grad_(True) for a in (q, k, v))
        if c["kind"] == "ring":
            o = ring_attention_local(q, k, v, line, causal=c["causal"],
                                     use_flash=c["use_flash"],
                                     layout=c["layout"], window=c["window"])
        else:
            o = ulysses_attention_local(q, k, v, line, causal=c["causal"],
                                        use_flash=c["use_flash"],
                                        window=c["window"])
        dq, dk, dv = torch.autograd.grad(o, (q, k, v), g)
        out[c["name"]] = (line.index, o.detach().numpy(), dq.numpy(),
                          dk.numpy(), dv.numpy())
    _close(mesh)
    return out


def mesh_case(shapes):
    """What ``build_mesh`` forms on this rank for each of ``shapes``: its
    coordinates, its line along each axis, its data plane, and the rank
    sets that got groups."""
    out, mesh = {}, None
    for dims in shapes:
        mesh = F.build_mesh(int(np.prod(dims)), device="cpu", dims=dims)
        out[tuple(dims)] = {
            "coords": mesh.coords,
            "lines": {a: mesh.line(a).ranks for a in F.AXES},
            "line_groups": {a: mesh.line(a).host_group is not None
                            for a in F.AXES},
            "plane": mesh.plane(F._data_axes(F.AXES)).ranks,
            "groups": sorted(mesh.runtime._groups),
        }
    _close(mesh)
    return out


def shared_card_case(dims=(1, 1, 2, 1, 1)):
    """A step on ranks that share cuda:0 → the BackendError text each
    rank raised (None if the step ran): NCCL needs a card a rank."""
    from tpu_p2p_torch.utils.errors import BackendError

    mesh = F.build_mesh(int(np.prod(dims)), device="cuda:0", dims=dims)
    try:
        cfg = F.FlagshipConfig(batch=2, seq=256, heads=4, kv_heads=2,
                               head_dim=64, stages=2, microbatches=1,
                               dense_ffn=True, vocab=256, use_flash=True,
                               dtype="bfloat16")
        params = F.place_flagship_params(
            F.init_flagship_params(cfg, seed=0, device="cpu"), mesh)
        toks, tgts = (local_shard(a, mesh, F._lm_token_spec(mesh)).to(
            mesh.device) for a in F.flagship_token_batch(cfg, seed=1))
        F.make_flagship_lm_train_step(cfg, mesh=mesh)(params, toks, tgts)
        return None
    except BackendError as e:
        return str(e)
    finally:
        _close(mesh)


def moe_case(cases):
    """The MoE layer alone with its experts split over an ep line of the
    whole world: ``cases`` is a list of dicts with ``name``, ``cfg``
    (MoEConfig keywords), global numpy ``params`` (``router``, ``w1``,
    ``w2``) and tokens ``x [G, D]`` → name → this rank's ``(out, dx,
    d_router, dw1, dw2)``: its token block's output and the grads of
    ``sum(out ** 2)`` (the router's a partial sum over the line)."""
    from tpu_p2p_torch.models.moe import MoEConfig, moe_layer_local

    out, mesh = {}, None
    for c in cases:
        n = int(os.environ["WORLD_SIZE"])
        mesh = F.build_mesh(n, device="cpu", dims=(1, 1, 1, 1, n))
        line = mesh.line("ep")
        spec = {"router": (None, None), "w1": ("ep", None, None),
                "w2": ("ep", None, None)}
        params = {k: torch.from_numpy(np.ascontiguousarray(
            local_shard(v, mesh, spec[k]))).requires_grad_(True)
            for k, v in c["params"].items()}
        x = torch.from_numpy(np.ascontiguousarray(
            local_shard(c["x"], mesh, ("ep", None)))).requires_grad_(True)
        y = moe_layer_local(params, x, MoEConfig(**c["cfg"]), line)
        grads = torch.autograd.grad(torch.sum(y ** 2),
                                    (x, params["router"], params["w1"],
                                     params["w2"]))
        out[c["name"]] = (y.detach().numpy(),
                          *(g.numpy() for g in grads))
    _close(mesh)
    return out
