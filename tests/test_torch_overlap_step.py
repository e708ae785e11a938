"""The flagship step with the overlap knobs on: ``tp_overlap="ring"``,
``ep_overlap="ring"`` and ``pp_overlap="wave"`` (with ``pp_chunks``), on
five-axis meshes that put tp, ep or pp at 2 (tp at 4 once).

The port's ranks run in one gloo world of 4
(``tests/torch_flagship_world.py::step_case``, torch only), one mesh a
case, from the reference's seeded params and a seeded global batch. Three
kinds of check:

- against the reference with the same knobs on its CPU devices: the
  loss to relative 1e-4 and every updated leaf to atol = rtol = 2e-4
  (the bounds of ``tests/test_torch_flagship_mesh.py``);
- against the port's own ``none`` step, at the reference's bounds for
  the same comparison (``tests/test_tp_overlap.py:52-59``,
  ``tests/test_ep_overlap.py:58-65``): the loss to relative 1e-6, every
  updated leaf to atol = rtol = 1e-5, every gradient to atol 1e-5 of
  the leaf's largest and rtol 1e-4 (``test_tp_overlap.py:129-137``); the
  wave, and every
  knob on an axis of size 1 or with ``pp_chunks=1``, bitwise
  (``tests/test_pp_overlap.py:97``, ``test_tp_overlap.py:110``,
  ``test_ep_overlap.py:111``);
- the compositions the reference pins: a ring beside the ZeRO prefetch
  and the tp and ep rings under remat (against the port's ``none`` step:
  the reference's
  prefetch does not trace on a five-axis mesh with size-1 axes, ROADMAP
  queue 3), the tp ring beside the ep ring and beside the wave (against
  the reference).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from tpu_p2p.models import flagship as JF
from tpu_p2p_torch.models import flagship as TF
from tpu_p2p_torch.parallel.launch import run_world

WORLD = os.path.join(os.path.dirname(__file__), "torch_flagship_world.py")
REF_LOSS_RTOL, REF_LEAF = 1e-4, dict(atol=2e-4, rtol=2e-4)
SELF_LOSS_RTOL, SELF_LEAF = 1e-6, dict(atol=1e-5, rtol=1e-5)
LR = 1e-2
BASE = dict(batch=8, seq=16, heads=4, head_dim=8, stages=2, microbatches=2,
            num_experts=2, capacity_factor=4.0, dtype="float32")
DP2_TP2, DP2_EP2, DP2_PP2 = (2, 1, 1, 2, 1), (2, 1, 1, 1, 2), (2, 2, 1, 1, 1)


def make_case(name, dims, seed=0, grads=False, **kw):
    """A step case (``grads``: the gradient function instead of the
    SGD step): its config, the reference's seeded params and a seeded
    global batch (tokens for an LM config), all numpy."""
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
            "params": params, "batch": batch, "lr": LR, "grads": grads}


# Against the reference, each with its knobs.
REF_CASES = [
    make_case("tp_ep_ring_moe_tp2xep2", (1, 1, 1, 2, 2), seed=1,
              tp_overlap="ring", ep_overlap="ring"),
    make_case("tp_ring_lm_norm_pad_tp4", (1, 1, 1, 4, 1), seed=2,
              dense_ffn=True, vocab=64, norm=True, seq=18,
              tp_overlap="ring"),
    make_case("ep_ring_dp2xep2", DP2_EP2, seed=3, ep_overlap="ring"),
    make_case("tp_ring_pp_wave_tp2xpp2", (1, 2, 1, 2, 1), seed=4,
              dense_ffn=True, tp_overlap="ring", pp_overlap="wave",
              pp_chunks=3),
]
# (name, the knob's case, the none case it is held to, bitwise). A
# gradient pair is held to the reference's bound for gradients
# (tests/test_tp_overlap.py:129-137: atol 1e-5 of the largest gradient,
# rtol 1e-4), a step pair to SELF_LEAF.
PAIRS = [
    ("tp_ring_dp2xtp2",
     make_case("tp_ring", DP2_TP2, dense_ffn=True, norm=True,
               tp_overlap="ring"),
     make_case("tp_none", DP2_TP2, dense_ffn=True, norm=True), False),
    ("ep_ring_dp2xep2",
     make_case("ep_ring", DP2_EP2, ep_overlap="ring"),
     make_case("ep_none", DP2_EP2), False),
    ("tp_ring_grads_dp2xtp2",
     make_case("tp_ring_grads", DP2_TP2, grads=True, dense_ffn=True,
               norm=True, tp_overlap="ring"),
     make_case("tp_none_grads", DP2_TP2, grads=True, dense_ffn=True,
               norm=True), False),
    ("ep_ring_grads_dp2xep2",
     make_case("ep_ring_grads", DP2_EP2, grads=True, ep_overlap="ring"),
     make_case("ep_none_grads", DP2_EP2, grads=True), False),
    ("pp_wave_pad_dp2xpp2",
     make_case("pp_wave", DP2_PP2, dense_ffn=True, pp_overlap="wave",
               pp_chunks=3),
     make_case("pp_none", DP2_PP2, dense_ffn=True), True),
    ("pp_chunks1_dp2xpp2",
     make_case("pp_wave_chunks1", DP2_PP2, dense_ffn=True,
               pp_overlap="wave", pp_chunks=1),
     make_case("pp_none", DP2_PP2, dense_ffn=True), True),
    ("every_knob_on_size1_axes_dp4",
     make_case("knobs_dp4", (4, 1, 1, 1, 1), tp_overlap="ring",
               ep_overlap="ring", pp_overlap="wave"),
     make_case("none_dp4", (4, 1, 1, 1, 1)), True),
    ("tp_ring_with_prefetch_dp2xtp2",
     make_case("tp_ring_prefetch", DP2_TP2, dense_ffn=True, zero_dp=True,
               overlap="prefetch", tp_overlap="ring"),
     make_case("zero_none", DP2_TP2, dense_ffn=True, zero_dp=True), False),
    ("tp_ring_under_remat_dp2xtp2",
     make_case("tp_ring_remat", DP2_TP2, dense_ffn=True, remat=True,
               tp_overlap="ring"),
     make_case("remat_none", DP2_TP2, dense_ffn=True, remat=True), False),
    ("ep_ring_under_remat_dp2xep2",
     make_case("ep_ring_remat", DP2_EP2, remat=True, ep_overlap="ring"),
     make_case("ep_remat_none", DP2_EP2, remat=True), False),
]


def _port_cases():
    seen, out = set(), []
    for c in REF_CASES + [c for _, a, b, _ in PAIRS for c in (a, b)]:
        if c["name"] not in seen:
            seen.add(c["name"])
            out.append(c)
    return out


@pytest.fixture(scope="module")
def world():
    return run_world(4, f"{WORLD}:step_case", {"cases": _port_cases()},
                     timeout=300)


def reference_step(case):
    """The reference's step on its mesh of ``case["dims"]`` → (loss,
    updated params as numpy)."""
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(case["dims"]), JF.AXES)
    cfg = JF.FlagshipConfig(**case["cfg"])
    placed = JF.place_flagship_params(
        {k: jnp.asarray(v) for k, v in case["params"].items()}, mesh, cfg)
    make = (JF.make_flagship_lm_train_step if cfg.vocab
            else JF.make_flagship_train_step)
    new, loss = make(mesh, cfg, lr=case["lr"])(
        placed, *(jnp.asarray(a) for a in case["batch"]))
    return float(loss), {k: np.asarray(v) for k, v in new.items()}


@pytest.mark.parametrize("case", REF_CASES, ids=[c["name"] for c in REF_CASES])
def test_knob_step_matches_reference(world, case):
    loss, params = reference_step(case)
    name = case["name"]
    for r, res in enumerate(world):
        np.testing.assert_allclose(res[name]["loss"], loss,
                                   rtol=REF_LOSS_RTOL,
                                   err_msg=f"{name} rank {r}")
    ours = world[0][name]["params"]
    assert sorted(ours) == sorted(params)
    for k in params:
        np.testing.assert_allclose(ours[k], params[k], err_msg=f"{name} {k}",
                                   **REF_LEAF)


@pytest.mark.parametrize("pair", PAIRS, ids=[p[0] for p in PAIRS])
def test_knob_step_matches_the_none_step(world, pair):
    _, knob, none, bitwise = pair
    for r, res in enumerate(world):
        got, want = res[knob["name"]], res[none["name"]]
        if bitwise:
            assert got["loss"] == want["loss"], r
        else:
            np.testing.assert_allclose(got["loss"], want["loss"],
                                       rtol=SELF_LOSS_RTOL, err_msg=str(r))
        if knob["grads"]:
            # Each rank's gradient keeps its param shard's shape.
            assert all(g == p for g, p in got["shapes"].values())
    got, want = world[0][knob["name"]]["params"], \
        world[0][none["name"]]["params"]
    assert sorted(got) == sorted(want)
    for k in want:
        if bitwise:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        elif knob["grads"]:
            scale = max(1.0, float(np.max(np.abs(want[k]))))
            np.testing.assert_allclose(got[k], want[k], atol=1e-5 * scale,
                                       rtol=1e-4, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                       **SELF_LEAF)


@pytest.mark.parametrize("name,bad", [("tp_overlap", "rings"),
                                      ("ep_overlap", "Ring"),
                                      ("pp_overlap", "waves")])
def test_overlap_knob_is_validated(name, bad):
    # The reference's test_*_overlap_knob_is_validated, on the port's
    # FlagshipConfig and BenchConfig.
    from tpu_p2p_torch.config import BenchConfig

    with pytest.raises(ValueError, match=name):
        TF.FlagshipConfig(**{name: bad})
    with pytest.raises(ValueError, match=name):
        BenchConfig(**{name: bad})
    cfg = TF.FlagshipConfig(zero_dp=True, overlap="prefetch",
                            tp_overlap="ring", ep_overlap="ring",
                            pp_overlap="wave", pp_chunks=2)
    assert (cfg.overlap, cfg.tp_overlap, cfg.ep_overlap, cfg.pp_overlap) \
        == ("prefetch", "ring", "ring", "wave")
    assert cfg.moe().ep_overlap == "ring"
    with pytest.raises(ValueError, match="pp_chunks"):
        TF.FlagshipConfig(pp_chunks=0)
