"""The port's flagship step on the five-axis mesh against the JAX
reference: one SGD step of the MSE and the LM step on the mesh shapes of
``tests/test_flagship.py`` (dense FFN), and GQA and rope + norm on one
shape each.

The parent computes the reference on its 8-device CPU mesh; the port's
ranks run in one gloo world of 8 (``tests/torch_flagship_world.py``,
torch only), one mesh a case, from the same numpy params and batches
(numpy seeds). Tolerances are the reference's own for a sharded step
against the single-device one (``tests/test_flagship.py``): loss
relative 1e-4, every leaf atol = rtol = 2e-4 after gathering.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from tpu_p2p.models import flagship as JF
from tpu_p2p_torch.parallel.launch import run_world

WORLD = os.path.join(os.path.dirname(__file__), "torch_flagship_world.py")
LOSS_RTOL = 1e-4
LEAF = dict(atol=2e-4, rtol=2e-4)
LR = 1e-2
BASE = dict(batch=8, seq=32, heads=4, head_dim=8, stages=2, microbatches=2,
            dense_ffn=True, dtype="float32")
MESHES = [(2, 2, 2, 1, 1), (1, 2, 1, 2, 2), (2, 1, 2, 1, 2), (1, 1, 2, 2, 2)]


def make_case(name, dims, seed=0, **kw):
    """A step case: the config, the reference's seeded params and a
    seeded global batch (tokens for an LM config), all numpy."""
    cfg_kw = {**BASE, **kw}
    cfg = JF.FlagshipConfig(**cfg_kw)
    params = {k: np.asarray(v)
              for k, v in JF.init_flagship_params(cfg, seed=seed).items()}
    rng = np.random.default_rng(seed + 1)
    if cfg.vocab:
        toks = rng.integers(0, cfg.vocab, (cfg.batch, cfg.seq + 1))
        toks = toks.astype(np.int32)
        batch = (toks[:, :-1], toks[:, 1:])
    else:
        shape = (cfg.batch, cfg.seq, cfg.model_dim)
        batch = (rng.standard_normal(shape).astype(np.float32),
                 rng.standard_normal(shape).astype(np.float32))
    return {"name": name, "dims": tuple(dims), "cfg": cfg_kw,
            "params": params, "batch": batch, "lr": LR}


def reference_step(case):
    """The reference's step on its mesh of ``case["dims"]`` → (loss,
    updated params as numpy)."""
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(case["dims"]), JF.AXES)
    cfg = JF.FlagshipConfig(**case["cfg"])
    placed = JF.place_flagship_params(
        {k: jnp.asarray(v) for k, v in case["params"].items()}, mesh, cfg)
    make = (JF.make_flagship_lm_train_step if cfg.vocab
            else JF.make_flagship_train_step)
    new, loss = make(mesh, cfg, lr=case["lr"])(
        placed, *(jnp.asarray(a) for a in case["batch"]))
    return float(loss), {k: np.asarray(v) for k, v in new.items()}


def assert_step_matches(case, got):
    """Every rank's loss and rank 0's gathered leaves against the
    reference, at the reference's tolerances."""
    loss, params = reference_step(case)
    name = case["name"]
    for r, res in enumerate(got):
        np.testing.assert_allclose(res[name]["loss"], loss, rtol=LOSS_RTOL,
                                   err_msg=f"{name} rank {r}")
    ours = got[0][name]["params"]
    assert sorted(ours) == sorted(params)
    for k in params:
        assert ours[k].shape == params[k].shape, (name, k)
        np.testing.assert_allclose(ours[k], params[k], err_msg=f"{name} {k}",
                                   **LEAF)


CASES = (
    [make_case(f"mse{d}", d) for d in MESHES]
    + [make_case(f"lm_flash{d}", d, seed=3, vocab=64, use_flash=True)
       for d in MESHES]
    + [make_case("gqa_lm_flash", (1, 1, 2, 2, 2), seed=5, kv_heads=2,
                 vocab=64, use_flash=True),
       make_case("rope_norm_lm", (2, 2, 2, 1, 1), seed=7, rope=True,
                 norm=True, vocab=64)]
)


@pytest.fixture(scope="module")
def world():
    return run_world(8, f"{WORLD}:step_case", {"cases": CASES},
                     timeout=240)


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_step_matches_reference_on_mesh(world, case):
    assert_step_matches(case, world)
