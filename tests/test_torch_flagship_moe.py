"""The port's flagship with the MoE FFN (``dense_ffn=False``) against
the JAX reference: one SGD step of the MSE and the LM objective on the
mesh shapes of ``tests/test_flagship.py`` (three of the four split the
experts over ep 2), one step with capacity tight enough to drop tokens
on a dp x sp x ep mesh, and the MoE decode paths (the dense-cache decode
step and the paged step) on one device.

The parent computes the reference on its 8-device CPU mesh; the port's
ranks run in one gloo world of 8 (``tests/torch_flagship_world.py``,
torch only) from the same numpy params and batches. Tolerances are the
reference's own for a sharded step against the single-device one: loss
relative 1e-4, every leaf atol = rtol = 2e-4 after gathering. The
expert leaves' gradients are summed over (dp, sp) only: summing them
over ep too would add one expert's gradient into another's, which the
dp x sp x ep cases would show at every expert leaf.
"""

import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from test_torch_flagship_mesh import assert_step_matches, make_case
from test_torch_model import _jax_dense, _jax_paged, _setup, _torch_dense, \
    _torch_paged
from tpu_p2p.models import flagship as JF
from tpu_p2p_torch.models import flagship as TF
from tpu_p2p_torch.parallel.launch import run_world
from tpu_p2p_torch.parallel.runtime import Mesh

WORLD = os.path.join(os.path.dirname(__file__), "torch_flagship_world.py")
MESHES = [(2, 2, 2, 1, 1), (1, 2, 1, 2, 2), (2, 1, 2, 1, 2), (1, 1, 2, 2, 2)]
# capacity_factor == num_experts: nothing drops (the reference's own
# flagship tests); the tight case drops.
MOE = dict(dense_ffn=False, num_experts=4, capacity_factor=4.0)
TOL = dict(atol=1e-5, rtol=1e-5)

CASES = (
    [make_case(f"moe_mse{d}", d, **MOE) for d in MESHES]
    + [make_case(f"moe_lm_flash{d}", d, seed=3, vocab=64, use_flash=True,
                 rope=True, norm=True, **MOE) for d in MESHES]
    + [make_case("moe_tight_mse", (2, 1, 2, 1, 2), seed=9,
                 **{**MOE, "capacity_factor": 1.0}),
       make_case("moe_tight_lm", (1, 2, 1, 2, 2), seed=11, vocab=64,
                 **{**MOE, "capacity_factor": 1.0})]
)


@pytest.fixture(scope="module")
def world():
    return run_world(8, f"{WORLD}:step_case", {"cases": CASES},
                     timeout=240)


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_moe_step_matches_reference_on_mesh(world, case):
    assert_step_matches(case, world)


@pytest.mark.parametrize("dims", MESHES, ids=str)
def test_moe_shards_equal_the_reference_shardings(dims):
    # The ep-split leaves (we1, we2: experts over ep, stages over pp) and
    # the replicated router, on every rank of each mesh.
    jcfg = JF.FlagshipConfig(batch=8, seq=32, heads=4, head_dim=8,
                             stages=2, **MOE)
    jmesh = JMesh(np.array(jax.devices()[:8]).reshape(dims), JF.AXES)
    params = JF.init_flagship_params(jcfg, seed=0)
    placed = JF.place_flagship_params(params, jmesh, jcfg)
    host = {k: np.asarray(v) for k, v in params.items()}
    assert {"router", "we1", "we2"} <= set(host)
    devices = list(jmesh.devices.reshape(-1))
    for rank in range(8):
        mesh = Mesh(ranks=tuple(range(8)), rank=rank,
                    device=torch.device("cpu"), host_group=None,
                    axis_names=TF.AXES, dims=tuple(dims))
        ours = TF.place_flagship_params(host, mesh)
        for k, v in placed.items():
            shard = next(s for s in v.addressable_shards
                         if s.device == devices[rank])
            np.testing.assert_array_equal(ours[k].numpy(),
                                          np.asarray(shard.data), err_msg=k)


# ------------------------------------------------------------- decode


MOE_MODEL = dict(dense_ffn=False, num_experts=4, moe_mult=2)


def test_moe_dense_decode_step_matches_reference():
    jcfg, tcfg, np_params, toks = _setup(seed=5, **MOE_MODEL)
    want, want_cache = _jax_dense(jcfg, np_params, toks)
    got, cache = _torch_dense(tcfg, np_params, toks)
    np.testing.assert_allclose(got, want, **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].numpy(), want_cache[k], **TOL)


def test_moe_paged_decode_bitwise_vs_dense_teacher_forced():
    # One shared _attend_ffn body: chunk-1 paged decode routes the same
    # rows as the dense step, so the two agree bitwise per position.
    _, tcfg, np_params, toks = _setup(seed=6, **MOE_MODEL)
    dense, _ = _torch_dense(tcfg, np_params, toks)
    paged, _ = _torch_paged(tcfg, np_params, toks, chunk=1)
    np.testing.assert_array_equal(paged, dense)
