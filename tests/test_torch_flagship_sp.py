"""The port's sequence parallelism against the JAX reference: the
flagship step under Ulysses, the flash ring (the reference's Pallas
kernels in interpret mode) and the zigzag ring on sp 2 and sp 4, with a
window; ``ring_attention_local`` (flash and dense) and
``ulysses_attention_local`` alone with their gradients; the mesh
factoring of ``build_mesh``; and the one-process ring that
``chip_smoke.py`` drives on the card, here on the plain versions.

World cases run in gloo worlds of 8 (``tests/torch_flagship_world.py``,
torch only); the parent computes the reference on its 8-device CPU mesh
from the same numpy inputs. Tolerances: the step's as
``tests/test_torch_flagship_mesh.py`` (loss 1e-4, leaves atol = rtol =
2e-4); attention alone as ``tests/test_ring_flash.py`` holds the ring
against dense attention (output 2e-5, gradients 2e-4).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import chip_smoke
from test_torch_flagship_mesh import assert_step_matches, make_case
from tpu_p2p.models import flagship as JF
from tpu_p2p.ops import attention as JA
from tpu_p2p.ops import ulysses as JU
from tpu_p2p_torch.models import flagship as TF
from tpu_p2p_torch.ops import flash_attention as TFA
from tpu_p2p_torch.ops.attention import dense_attention, from_zigzag, \
    to_zigzag
from tpu_p2p_torch.parallel.launch import run_world

WORLD = os.path.join(os.path.dirname(__file__), "torch_flagship_world.py")
OUT = dict(atol=2e-5, rtol=2e-5)
GRAD = dict(atol=2e-4, rtol=2e-4)

# ------------------------------------------------------- steps on sp

STEPS = [
    make_case("ulysses_mse", (2, 1, 2, 1, 2), sp_strategy="ulysses"),
    make_case("ulysses_lm_flash", (1, 2, 2, 2, 1), seed=2,
              sp_strategy="ulysses", vocab=64, use_flash=True),
    make_case("ring_flash_sp4", (1, 2, 4, 1, 1), seed=4, vocab=64,
              use_flash=True, rope=True),
    make_case("zigzag_flash_sp2", (2, 2, 2, 1, 1), seed=6,
              sp_strategy="ring_zigzag", vocab=64, use_flash=True,
              rope=True, norm=True),
    make_case("zigzag_flash_sp4", (2, 1, 4, 1, 1), seed=8,
              sp_strategy="ring_zigzag", use_flash=True),
    make_case("zigzag_dense_sp4", (1, 2, 4, 1, 1), seed=9,
              sp_strategy="ring_zigzag"),
    make_case("window6_flash_sp4", (2, 1, 4, 1, 1), seed=11, vocab=64,
              use_flash=True, rope=True, norm=True, attn_window=6),
    make_case("window12_zigzag_flash_sp2", (2, 2, 2, 1, 1), seed=12,
              sp_strategy="ring_zigzag", vocab=64, use_flash=True,
              attn_window=12),
]


@pytest.fixture(scope="module")
def step_world():
    return run_world(8, f"{WORLD}:step_case", {"cases": STEPS}, timeout=240)


@pytest.mark.parametrize("case", STEPS, ids=[c["name"] for c in STEPS])
def test_sp_step_matches_reference(step_world, case):
    assert_step_matches(case, step_world)


# --------------------------------------------------- attention alone

B, H, T, D = 2, 8, 64, 8


def _attention_cases():
    cases = []
    for sp in (2, 4):
        for name, kind, layout, flash, causal, window, h_kv in (
                ("ring_flash", "ring", "contiguous", True, True, None, H),
                ("ring_flash_zigzag_gqa", "ring", "zigzag", True, True,
                 None, 2),
                ("ring_flash_window", "ring", "contiguous", True, True, 12,
                 H),
                ("ring_flash_noncausal", "ring", "contiguous", True, False,
                 None, H),
                ("ring_dense_zigzag_window", "ring", "zigzag", False, True,
                 20, H),
                ("ulysses_flash", "ulysses", "contiguous", True, True, None,
                 H),
                ("ulysses_dense_gqa", "ulysses", "contiguous", False, True,
                 None, 4)):
            rng = np.random.default_rng(len(cases))
            q, g = (rng.standard_normal((B, H, T, D)).astype(np.float32)
                    for _ in range(2))
            k, v = (rng.standard_normal((B, h_kv, T, D)).astype(np.float32)
                    for _ in range(2))
            cases.append({"name": f"{name}_sp{sp}", "sp": sp, "kind": kind,
                          "layout": layout, "use_flash": flash,
                          "causal": causal, "window": window,
                          "q": q, "k": k, "v": v, "g": g})
    return cases


ATTENTION = _attention_cases()


@pytest.fixture(scope="module")
def attention_world():
    return run_world(8, f"{WORLD}:attention_case", {"cases": ATTENTION},
                     timeout=240)


def _reference_attention(case):
    """The reference's jitted global ring / Ulysses attention on an
    sp-only mesh, its output and the vjp of ``g``."""
    mesh = Mesh(np.array(jax.devices()[:case["sp"]]), ("sp",))
    if case["kind"] == "ring":
        fn = JA.ring_attention(mesh, "sp", case["causal"],
                               case["use_flash"], case["layout"],
                               case["window"])
    else:
        fn = JU.ulysses_attention(mesh, "sp", case["causal"],
                                  case["use_flash"], case["window"])
    args = [jnp.asarray(case[n]) for n in "qkv"]
    out, vjp = jax.vjp(fn, *args)
    return (np.asarray(out),) + tuple(np.asarray(x) for x in
                                      vjp(jnp.asarray(case["g"])))


@pytest.mark.parametrize("case", ATTENTION, ids=[c["name"] for c in
                                                 ATTENTION])
def test_sp_attention_matches_reference(attention_world, case):
    want = _reference_attention(case)
    name, sp = case["name"], case["sp"]
    blocks = {}
    for res in attention_world:
        idx, *parts = res[name]
        if idx in blocks:  # the dp replicas agree
            for a, b in zip(blocks[idx], parts):
                np.testing.assert_array_equal(a, b)
        blocks[idx] = parts
    assert sorted(blocks) == list(range(sp))
    got = [np.concatenate([blocks[i][j] for i in range(sp)], axis=2)
           for j in range(4)]
    for what, a, w, tol in zip(("out", "dq", "dk", "dv"), got, want,
                               (OUT, GRAD, GRAD, GRAD)):
        np.testing.assert_allclose(a, w, err_msg=f"{name} {what}", **tol)


# ---------------------------------------------------- mesh factoring


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_dims_equal_the_reference_factoring(n):
    want = JF.build_mesh(n, devices=jax.devices()[:n]).devices.shape
    assert TF.mesh_dims(n) == tuple(want)
    assert TF.AXES == JF.AXES


# --------------------------------------- the smoke's one-process ring


@pytest.mark.parametrize("n", chip_smoke.RING_SIZES)
@pytest.mark.parametrize("layout,window", chip_smoke.RING_VARIANTS,
                         ids=["contiguous", "zigzag", "contiguous_window",
                              "zigzag_window"])
def test_one_process_ring_equals_dense_attention(n, layout, window):
    # chip_smoke.py's phase 10 at a small size on the CPU (the wrappers'
    # plain versions): the assembled ring against dense attention and
    # its gradients, and the calls against ring_calls.
    t, window = 32, window and 10
    gen = torch.Generator().manual_seed(n)
    q, g = (torch.randn((2, 4, t, 8), generator=gen) for _ in range(2))
    k, v = (torch.randn((2, 2, t, 8), generator=gen) for _ in range(2))
    calls = {"carry": 0, "bwd": 0}

    def counted(fn, key):
        def call(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return call

    args = [to_zigzag(x, n) if layout == "zigzag" else x
            for x in (q, k, v, g)]
    got = chip_smoke.ring_in_one_process(
        *args, n, causal=True, layout=layout, window=window,
        carry_block=counted(TFA.flash_carry_block, "carry"),
        bwd_block=counted(TFA.flash_bwd_block, "bwd"))
    plain = chip_smoke.ring_in_one_process(
        *args, n, causal=True, layout=layout, window=window,
        carry_block=TFA.flash_carry_block_plain,
        bwd_block=TFA.flash_bwd_block_plain)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)  # on the CPU both are the plain version
    if layout == "zigzag":
        got = tuple(from_zigzag(x, n) for x in got)
    qd, kd, vd = (x.clone().requires_grad_(True) for x in (q, k, v))
    out = dense_attention(qd, kd, vd, causal=True, window=window)
    want = (out,) + torch.autograd.grad(out, (qd, kd, vd), g)
    for what, a, w, tol in zip(("out", "dq", "dk", "dv"), got, want,
                               (OUT, GRAD, GRAD, GRAD)):
        np.testing.assert_allclose(a.detach().numpy(), w.detach().numpy(),
                                   err_msg=what, **tol)
    want_calls = chip_smoke.ring_calls(n, t // n, layout, window)
    assert calls == {"carry": want_calls, "bwd": want_calls}


@pytest.mark.parametrize("dims", [(2, 2, 2, 1, 1), (1, 2, 1, 2, 2),
                                  (2, 1, 2, 1, 2), (1, 1, 2, 2, 2)], ids=str)
def test_tiny_config_equals_the_reference(dims):
    from tpu_p2p_torch.parallel.runtime import Mesh as TMesh

    jmesh = Mesh(np.array(jax.devices()[:8]).reshape(dims), JF.AXES)
    tmesh = TMesh(ranks=tuple(range(8)), rank=0, device=torch.device("cpu"),
                  host_group=None, axis_names=TF.AXES, dims=dims)
    for kw in ({}, {"heads": 16, "kv_heads": 8}, {"kv_heads": 2}):
        kw = {**kw, "dense_ffn": True}
        want = JF.FlagshipConfig(**kw).tiny(jmesh)
        got = TF.FlagshipConfig(**kw).tiny(tmesh)
        for name in ("batch", "seq", "heads", "kv_heads", "head_dim",
                     "stages", "num_experts", "capacity_factor"):
            assert getattr(got, name) == getattr(want, name), (kw, name)
