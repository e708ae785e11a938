"""The port's rematerialization (``cfg.remat``, ``cfg.remat_policy``)
against the JAX reference (``tests/test_remat.py``'s cases).

Remat trades memory, not values: on the CPU in float32 the port's remat
step, under every policy name, is bitwise its own plain step; against
the reference's same step it holds the sharded-step tolerances of
``tests/test_torch_flagship_mesh.py`` (loss relative 1e-4, every leaf
atol = rtol = 2e-4).

- a world of one: remat and each policy, dense and MoE FFN;
- the policy acts: during the backward a dispatch-mode counter sees
  which marked products the recompute runs — under
  ``dots_with_no_batch_dims_saveable`` the expert FFN and the dense
  attention's products, no projection; under full remat every product
  the backward needs; under ``dots_saveable`` and
  ``everything_saveable`` none;
- gloo worlds of 4: remat through the recomputed collectives — the
  zigzag flash ring on sp 4, the MoE's all-to-alls on sp 2 x ep 2 (with
  a policy), GPipe's hops on pp 2 x dp 2, the tp joins on sp 2 x tp 2;
  each against the reference and bitwise against the port's plain step
  on the same mesh. A rank that recomputed its collectives in another
  order would hang: the world has its own timeout;
- the accepted ``remat_policy`` names are the set the reference's
  validator accepts over ``dir(jax.checkpoint_policies)``.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch.utils._python_dispatch import TorchDispatchMode

from tpu_p2p.models import flagship as JF
from tpu_p2p_torch.models import flagship as TF
from tpu_p2p_torch.parallel.launch import run_world
from tpu_p2p_torch.utils import remat as R

WORLD = os.path.join(os.path.dirname(__file__), "torch_flagship_world.py")
LOSS_RTOL = 1e-4
LEAF = dict(atol=2e-4, rtol=2e-4)
LR = 1e-2
BASE = dict(batch=8, seq=32, heads=4, head_dim=8, stages=2, microbatches=2,
            num_experts=2, capacity_factor=4.0, norm=True, rope=True)
POLICIES = sorted(R.REMAT_POLICIES)


def _numpy_case(cfg_kw, seed=0):
    cfg = JF.FlagshipConfig(**cfg_kw)
    params = {k: np.asarray(v)
              for k, v in JF.init_flagship_params(cfg, seed=seed).items()}
    rng = np.random.default_rng(seed + 1)
    shape = (cfg.batch, cfg.seq, cfg.model_dim)
    batch = (rng.standard_normal(shape).astype(np.float32),
             rng.standard_normal(shape).astype(np.float32))
    return params, batch


def reference_step(cfg_kw, params, batch, dims=(1,)):
    """The reference's step on a mesh of its axes of size > 1 (one
    device: ``("dp",)`` of 1) → (loss, params as numpy)."""
    axes = tuple(a for a, n in zip(JF.AXES, dims) if n > 1) or ("dp",)
    shape = tuple(n for n in dims if n > 1) or (1,)
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                axes)
    cfg = JF.FlagshipConfig(**cfg_kw)
    placed = JF.place_flagship_params(
        {k: jnp.asarray(v) for k, v in params.items()}, mesh, cfg)
    new, loss = JF.make_flagship_train_step(mesh, cfg, lr=LR)(
        placed, *(jnp.asarray(a) for a in batch))
    return float(loss), {k: np.asarray(v) for k, v in new.items()}


def port_step(cfg_kw, params, batch):
    """The port's step on a world of one → (loss, params as numpy)."""
    tp = TF.params_from_numpy(params, "cpu")
    x, t = (torch.from_numpy(a) for a in batch)
    new, loss = TF.make_flagship_train_step(
        TF.FlagshipConfig(**cfg_kw), lr=LR)(tp, x, t)
    return float(loss), {k: v.numpy() for k, v in new.items()}


# --------------------------------------------------- a world of one


FFNS = {"dense": {"dense_ffn": True}, "moe": {}}


@pytest.fixture(scope="module")
def plain():
    """The port's plain step of each FFN → (inputs, loss, params)."""
    out = {}
    for name, ffn in FFNS.items():
        kw = {**BASE, **ffn}
        params, batch = _numpy_case(kw)
        out[name] = (kw, params, batch, port_step(kw, params, batch))
    return out


REF_POLICY = "dots_with_no_batch_dims_saveable"


@pytest.fixture(scope="module")
def ref_steps():
    """The reference's step under full remat and under ``REF_POLICY``,
    each FFN, computed once: the other policies are held to the
    reference's full remat (its own test holds a policy to full remat),
    which spares a compile a policy."""
    return {}


@pytest.mark.parametrize("policy", ["full"] + POLICIES)
@pytest.mark.parametrize("ffn", sorted(FFNS))
def test_remat_step_is_plain_step_and_matches_reference(plain, ref_steps,
                                                       ffn, policy):
    kw, params, batch, (loss0, new0) = plain[ffn]
    kw = {**kw, "remat": True,
          "remat_policy": "" if policy == "full" else policy}
    loss, new = port_step(kw, params, batch)
    assert loss == loss0
    for k in new0:
        np.testing.assert_array_equal(new[k], new0[k], err_msg=k)
    ref_policy = REF_POLICY if policy == REF_POLICY else ""
    key = (ffn, ref_policy)
    if key not in ref_steps:
        ref_steps[key] = reference_step(
            {**kw, "remat_policy": ref_policy}, params, batch)
    want_loss, want = ref_steps[key]
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    for k in want:
        np.testing.assert_allclose(new[k], want[k], err_msg=k, **LEAF)


class _RecomputedProducts(TorchDispatchMode):
    """Counts each marked product's GEMM as it runs (what the
    recompute runs, when installed around the backward)."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        mark = R.current_product()
        if mark is not None and func in R.GEMM_OPS:
            self.counts[mark[0]] = self.counts.get(mark[0], 0) + 1
        return func(*args, **(kwargs or {}))


PROJECTIONS = {"wq", "wk", "wv", "wo", "router"}
ATTENTION = {"attn_scores", "attn_values"}
EXPERTS = {"we1", "we2"}
RECOMPUTED = {  # policy -> the products the backward recomputes (MoE)
    "full": PROJECTIONS | ATTENTION | EXPERTS,
    "nothing_saveable": PROJECTIONS | ATTENTION | EXPERTS,
    "dots_with_no_batch_dims_saveable": ATTENTION | EXPERTS,
    "checkpoint_dots_with_no_batch_dims": ATTENTION | EXPERTS,
    "dots_saveable": set(),
    "checkpoint_dots": set(),
    "everything_saveable": set(),
}


@pytest.mark.parametrize("policy", sorted(RECOMPUTED))
def test_policy_decides_which_products_are_recomputed(policy):
    kw = {**BASE, "remat": True,
          "remat_policy": "" if policy == "full" else policy}
    cfg = TF.FlagshipConfig(**kw)
    params, batch = _numpy_case(kw)
    leaves = {k: v.requires_grad_(True)
              for k, v in TF.params_from_numpy(params, "cpu").items()}
    x, t = (torch.from_numpy(a) for a in batch)
    loss = torch.sum((TF._forward_local(leaves, x, cfg) - t) ** 2)
    with _RecomputedProducts() as seen:
        torch.autograd.grad(loss, list(leaves.values()))
    assert set(seen.counts) == RECOMPUTED[policy], seen.counts
    # each recomputed product once a block a microbatch
    per = cfg.stages * cfg.microbatches
    assert all(n == per for n in seen.counts.values()), seen.counts


def test_remat_policy_names_are_the_references():
    accepted = set()
    for name in dir(jax.checkpoint_policies):
        if name.startswith("_"):
            continue
        try:
            JF.FlagshipConfig(remat=True, remat_policy=name)
        except ValueError:
            continue
        accepted.add(name)
    assert accepted == set(R.REMAT_POLICIES)
    for name in accepted:
        assert TF.FlagshipConfig(remat=True, remat_policy=name)
    for bad in ("no_such_policy", "save_only_these_names",
                "save_from_both_policies", "save_any_names_but_these"):
        with pytest.raises(ValueError, match="remat_policy"):
            TF.FlagshipConfig(remat=True, remat_policy=bad)
    with pytest.raises(ValueError, match="requires remat"):
        TF.FlagshipConfig(remat_policy="dots_saveable")


# ------------------------------------------------- gloo worlds of 4


def _world_case(name, dims, seed=0, **kw):
    cfg_kw = {**BASE, **kw}
    params, batch = _numpy_case(cfg_kw, seed)
    return {"name": name, "dims": tuple(dims), "cfg": cfg_kw,
            "params": params, "batch": batch, "lr": LR}


MESH_CASES = {  # name -> (dims, config keywords)
    "zigzag_flash_sp4": ((1, 1, 4, 1, 1), dict(
        sp_strategy="ring_zigzag", use_flash=True, dense_ffn=True)),
    "moe_sp2xep2_policy": ((1, 1, 2, 1, 2), dict(
        remat_policy="dots_with_no_batch_dims_saveable")),
    "gpipe_pp2xdp2": ((2, 2, 1, 1, 1), dict(dense_ffn=True)),
    "tp_joins_sp2xtp2": ((1, 1, 2, 2, 1), dict(dense_ffn=True,
                                               use_flash=True)),
}


def _remat_cases():
    cases = []
    for i, (name, (dims, kw)) in enumerate(MESH_CASES.items()):
        plain_kw = {k: v for k, v in kw.items() if k != "remat_policy"}
        cases.append(_world_case("plain_" + name, dims, seed=i, **plain_kw))
        cases.append(_world_case("remat_" + name, dims, seed=i, remat=True,
                                 **kw))
    return cases


WORLD_CASES = _remat_cases()
BY_NAME = {c["name"]: c for c in WORLD_CASES}


@pytest.fixture(scope="module")
def world():
    return run_world(4, f"{WORLD}:step_case", {"cases": WORLD_CASES},
                     timeout=240)


@pytest.mark.parametrize("name", sorted(MESH_CASES))
def test_remat_on_mesh_is_plain_step(world, name):
    for res in world:
        assert res["remat_" + name]["loss"] == res["plain_" + name]["loss"]
    got, want = world[0]["remat_" + name]["params"], \
        world[0]["plain_" + name]["params"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(MESH_CASES))
def test_remat_on_mesh_matches_reference(world, name):
    case = BY_NAME["remat_" + name]
    loss, want = reference_step(case["cfg"], case["params"], case["batch"],
                                case["dims"])
    for r, res in enumerate(world):
        np.testing.assert_allclose(res[case["name"]]["loss"], loss,
                                   rtol=LOSS_RTOL, err_msg=f"rank {r}")
    ours = world[0][case["name"]]["params"]
    for k in want:
        np.testing.assert_allclose(ours[k], want[k], err_msg=k, **LEAF)


def test_remat_zigzag_ring_trains_down():
    """The reference test's own check on the ring: three steps of the
    zigzag flash ring under remat lower the loss (one process: a ring of
    one is the local flash path; the ring itself runs in the world)."""
    kw = {**BASE, "sp_strategy": "ring_zigzag", "use_flash": True,
          "remat": True}
    params, batch = _numpy_case(kw)
    tp = TF.params_from_numpy(params, "cpu")
    x, t = (torch.from_numpy(a) for a in batch)
    step = TF.make_flagship_train_step(TF.FlagshipConfig(**kw), lr=5e-2,
                                       donate=True)
    losses = []
    for _ in range(3):
        tp, loss = step(tp, x, t)
        losses.append(float(loss))
    assert all(np.isfinite(v) for v in losses)
    assert losses[-1] < losses[0]


def test_remat_block_wrapper_is_identity_without_remat():
    def fn(a):
        return a

    assert R.remat_block(fn, False) is fn
    assert R.remat_block(fn, True, "everything_saveable") is fn
    assert R.remat_block(fn, True) is not fn
    assert dataclasses.replace(TF.FlagshipConfig(), remat=True).remat
