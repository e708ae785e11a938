"""The port's MoE layer (``tpu_p2p_torch/models/moe.py``) against the
JAX reference (``tpu_p2p/models/moe.py``) on the cases of
``tests/test_moe.py``: top-1 and top-2 routing, capacity tight enough
to drop (dropped tokens give exact zeros), padding rows that take no
capacity, grouped routing with a padded tail group, renormalised top-2
gates; then the experts split over ep lines of 2 and 4 gloo ranks
(``tests/torch_flagship_world.py:moe_case``) against the reference's
ep-sharded layer, outputs and gradients.

Params and tokens are made once from numpy seeds and fed to both sides.
Routing state — dispatch slots, drops, expert choices — is integer
state and must be equal; each routing test prints the smallest
top-1/top-2 router-logit margin among its tokens and asserts it above
1e-6, so that a flip would be a port fault and not a rounding tie.
Outputs and gradients agree within 1e-5 relative (float32; the gates
come from two softmax implementations).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding

from tpu_p2p.models import flagship as JF
from tpu_p2p.models import moe as JM
from tpu_p2p_torch.models import flagship as TF
from tpu_p2p_torch.models import moe as TM
from tpu_p2p_torch.parallel.launch import run_world

WORLD = os.path.join(os.path.dirname(__file__), "torch_flagship_world.py")
TOL = dict(atol=1e-5, rtol=1e-5)
MARGIN_MIN = 1e-6


def _setup(g=64, d=16, f=32, e=8, cf=None, seed=0, **kw):
    """Both configs, the reference's params as numpy and seeded tokens
    (capacity_factor defaults to num_experts: nothing drops)."""
    fields = dict(d_model=d, d_ff=f, num_experts=e,
                  capacity_factor=cf if cf is not None else float(e), **kw)
    jcfg, tcfg = JM.MoEConfig(**fields), TM.MoEConfig(**fields)
    params = {k: np.array(v)
              for k, v in JM.init_moe_params(jcfg, seed=seed).items()}
    x = np.random.default_rng(seed + 1).standard_normal((g, d)).astype(
        np.float32)
    return jcfg, tcfg, params, x


def _t(params):
    return {k: torch.from_numpy(v.copy()) for k, v in params.items()}


def _j(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


def _assert_margin(x, router):
    """The smallest top-1/top-2 router-logit margin (float64) over the
    tokens, printed and held above ``MARGIN_MIN``."""
    logits = np.sort(x.astype(np.float64) @ router.astype(np.float64), -1)
    margin = float((logits[:, -1] - logits[:, -2]).min())
    print(f"smallest top-1/top-2 router-logit margin: {margin:.3e}")
    assert margin > MARGIN_MIN, margin


# ----------------------------------------------------------- configs


def test_config_capacity_and_init_match_reference():
    for kw in (dict(), dict(num_experts=4, capacity_factor=1.25,
                            router_top_k=2, group_size=8)):
        j, t = JM.MoEConfig(**kw), TM.MoEConfig(**kw)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        for tokens in (1, 7, 16, 52, 256, 16384):
            assert t.capacity(tokens) == j.capacity(tokens)
    jcfg, tcfg, params, _ = _setup(seed=4)
    own = TM.init_moe_params(tcfg, seed=4)
    assert list(own) == list(params)
    for k in params:
        np.testing.assert_array_equal(own[k].numpy(), params[k], err_msg=k)
    kw = dict(heads=16, kv_heads=8, head_dim=128, stages=8, moe_mult=4,
              vocab=32768, dtype="bfloat16")
    assert dataclasses.asdict(TF.FlagshipConfig(**kw).moe()) \
        == dataclasses.asdict(JF.FlagshipConfig(**kw).moe())
    assert TF.FlagshipConfig(**kw).moe().capacity(256) == 128


def test_ep_overlap_ring_is_ported_and_validated():
    # FlagshipConfig.moe() carries the knob into the layer's config, as
    # the reference's does; a bad value is refused by both configs.
    assert TM.MoEConfig(ep_overlap="ring").ep_overlap == "ring"
    assert TF.FlagshipConfig(ep_overlap="ring").moe() == \
        dataclasses.replace(TF.FlagshipConfig().moe(), ep_overlap="ring")
    assert dataclasses.asdict(TF.FlagshipConfig(ep_overlap="ring").moe()) \
        == dataclasses.asdict(JF.FlagshipConfig(ep_overlap="ring").moe())
    with pytest.raises(ValueError, match="ep_overlap"):
        TM.MoEConfig(ep_overlap="rings")
    with pytest.raises(ValueError, match="ep_overlap"):
        TF.FlagshipConfig(ep_overlap="Ring")


# ----------------------------------------------------------- routing


ROUTES = {  # name -> (tokens, experts, capacity, k)
    "ample_k1": (64, 8, 64, 1),
    "ample_k2": (64, 8, 64, 2),
    "tight_k1": (32, 4, 3, 1),
    "tight_k2": (32, 4, 3, 2),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_route_topk_matches_reference(name):
    g, e, cap, k = ROUTES[name]
    _, _, params, x = _setup(g=g, e=e)
    _assert_margin(x, params["router"])
    d_j, c_j = JM._route_topk(jnp.asarray(x), jnp.asarray(params["router"]),
                              e, cap, k=k)
    d_t, c_t = TM._route_topk(torch.from_numpy(x),
                              torch.from_numpy(params["router"]), e, cap, k=k)
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), **TOL)
    if name.startswith("tight"):
        assert d_t.sum() < g * k        # drops are live
    route = TM._route(torch.from_numpy(x), torch.from_numpy(params["router"]),
                      e, cap, k)
    assert int(route.keep.sum()) == int(np.asarray(d_j).sum())


def test_top2_gates_renormalised():
    _, _, params, x = _setup(g=16)
    _assert_margin(x, params["router"])
    d, c = TM._route_topk(torch.from_numpy(x),
                          torch.from_numpy(params["router"]), 8, 16, k=2)
    np.testing.assert_allclose(c.sum(dim=(1, 2)).numpy(), np.ones(16),
                               atol=1e-6)
    np.testing.assert_array_equal(d.sum(dim=(1, 2)).numpy(), np.full(16, 2.))


def test_padding_rows_take_no_capacity():
    # As the reference pins it: masked rows take no slot, and the real
    # tokens' allocation is the one they get routed alone (top-2, where
    # an unmasked pad's first choice would steal a second choice's slot).
    _, _, params, x = _setup(g=8, e=4, cf=0.5)
    _assert_margin(x, params["router"])
    xp = np.concatenate([x, np.zeros_like(x)])
    valid = np.concatenate([np.ones(8), np.zeros(8)]).astype(np.float32)
    router = torch.from_numpy(params["router"])
    d_m, c_m = TM._route_topk(torch.from_numpy(xp), router, 4, 2, k=2,
                              valid=torch.from_numpy(valid))
    d_a, c_a = TM._route_topk(torch.from_numpy(x), router, 4, 2, k=2)
    d_j, c_j = JM._route_topk(jnp.asarray(xp), jnp.asarray(params["router"]),
                              4, 2, k=2, valid=jnp.asarray(valid))
    assert not d_m[8:].any()
    np.testing.assert_array_equal(d_m[:8].numpy(), d_a.numpy())
    np.testing.assert_array_equal(d_m.numpy(), np.asarray(d_j))
    np.testing.assert_allclose(c_m.numpy(), np.asarray(c_j), **TOL)


@pytest.mark.parametrize("k", [1, 2])
def test_index_dispatch_and_combine_equal_the_one_hot_einsums(k):
    # The port writes tokens into their slots and gathers them back by
    # index where the reference multiplies by one-hot tensors; each slot
    # holds at most one token, so the slots are bitwise the reference's
    # dispatch einsum, and the combine agrees to float32 rounding.
    jcfg, tcfg, params, x = _setup(g=20, e=4, cf=1.0, router_top_k=k,
                                   group_size=8)
    _assert_margin(x, params["router"])
    gs, ng, cap, e = 8, 3, jcfg.capacity(8), 4
    xg = np.concatenate([x, np.zeros((4, 16), np.float32)])
    valid = (np.arange(24) < 20).astype(np.float32).reshape(ng, gs)
    disp, comb = jax.vmap(lambda xx, vv: JM._route_topk(
        xx, jnp.asarray(params["router"]), e, cap, k=k, valid=vv))(
            jnp.asarray(xg.reshape(ng, gs, 16)), jnp.asarray(valid))
    want = np.asarray(jnp.einsum("Ngec,Ngd->eNcd", disp,
                                 jnp.asarray(xg.reshape(ng, gs, 16))))
    route = TM._route(torch.from_numpy(xg.reshape(ng, gs, 16)),
                      torch.from_numpy(params["router"]), e, cap, k,
                      torch.from_numpy(valid))
    slot = TM._slot_ids(route, e, cap)
    slots = TM._dispatch(torch.from_numpy(xg), slot, e * ng * cap)
    np.testing.assert_array_equal(slots.numpy(), want.reshape(-1, 16))
    y = np.random.default_rng(3).standard_normal(want.shape).astype(
        np.float32)
    out_j = np.asarray(jnp.einsum("Ngec,eNcd->Ngd", comb, jnp.asarray(y)))
    out_t = TM._combine(torch.from_numpy(y.reshape(-1, 16)), slot,
                        route.gates.reshape(ng * gs, k))
    np.testing.assert_allclose(out_t.numpy(), out_j.reshape(-1, 16), **TOL)
    assert not out_t[20:].any()                     # padding rows


# ------------------------------------------------------------- layer


LAYERS = {  # name -> _setup keywords
    "ample_k1": dict(),
    "ample_k2": dict(router_top_k=2),
    "tight_k1": dict(g=32, cf=0.125),
    "tight_k2": dict(g=64, cf=0.5, router_top_k=2),
    "grouped_tail_k1": dict(g=20, group_size=8),
    "grouped_tail_k2": dict(g=52, group_size=8, router_top_k=2),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_and_grads_match_reference(name):
    jcfg, tcfg, params, x = _setup(**LAYERS[name])
    _assert_margin(x, params["router"])

    def loss_j(p, xx):
        return jnp.sum(JM.moe_layer_local(p, xx, jcfg) ** 2)

    want = np.asarray(JM.moe_layer_local(_j(params), jnp.asarray(x), jcfg))
    g_j = jax.grad(loss_j, argnums=(0, 1))(_j(params), jnp.asarray(x))
    p_t = {k: v.requires_grad_(True) for k, v in _t(params).items()}
    x_t = torch.from_numpy(x.copy()).requires_grad_(True)
    got = TM.moe_layer_local(p_t, x_t, tcfg)
    g_t = torch.autograd.grad(torch.sum(got ** 2), [*p_t.values(), x_t])
    got = got.detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # Dropped tokens come back as exact zeros, on both sides alike.
    np.testing.assert_array_equal(np.all(got == 0, -1), np.all(want == 0, -1))
    if name.startswith("tight"):
        assert np.all(got == 0, -1).any()
    else:
        ref = TM.moe_reference(_t(params), torch.from_numpy(x), tcfg)
        np.testing.assert_allclose(got, ref.numpy(), **TOL)
    for k, g in zip(p_t, g_t):
        np.testing.assert_allclose(g.numpy(), np.asarray(g_j[0][k]),
                                   atol=1e-4, rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(g_t[-1].numpy(), np.asarray(g_j[1]),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("k", [1, 2])
def test_capacity_free_oracle_matches_reference(k):
    jcfg, tcfg, params, x = _setup(router_top_k=k)
    want = np.asarray(JM.moe_reference(_j(params), jnp.asarray(x), jcfg))
    got = TM.moe_reference(_t(params), torch.from_numpy(x), tcfg).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_bad_expert_shard_count_raises():
    _, tcfg, params, x = _setup(e=8)
    p = _t(params)
    p["w1"], p["w2"] = p["w1"][:3], p["w2"][:3]
    with pytest.raises(ValueError, match="expert shards"):
        TM.moe_layer_local(p, torch.from_numpy(x), tcfg)


# ------------------------------------------------- ep lines of gloo ranks


EP_CASES = {  # name -> _setup keywords
    "ample_k1": dict(),
    "grouped_tail_k2": dict(g=52, group_size=8, router_top_k=2),
    "tight_k1": dict(g=64, cf=0.5),
    "tight_k2": dict(g=64, cf=0.5, router_top_k=2),
}


def _ep_case(name):
    _, tcfg, params, x = _setup(**EP_CASES[name])
    return {"name": name, "cfg": dataclasses.asdict(tcfg),
            "params": params, "x": x}


@pytest.fixture(scope="module", params=[2, 4], ids=["ep2", "ep4"])
def ep_world(request):
    n = request.param
    cases = [_ep_case(name) for name in EP_CASES]
    return n, run_world(n, f"{WORLD}:moe_case", {"cases": cases},
                        timeout=120)


@pytest.mark.parametrize("name", sorted(EP_CASES))
def test_ep_split_layer_matches_reference(ep_world, name):
    n, got = ep_world
    jcfg, _, params, x = _setup(**EP_CASES[name])
    _assert_margin(x, params["router"])
    mesh = Mesh(np.array(jax.devices()[:n]), ("ep",))
    specs = JM.ep_param_specs(mesh)
    placed = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, specs[k]))
              for k, v in params.items()}
    layer = JM.make_moe_layer(mesh, jcfg)

    def loss(p, xx):
        return jnp.sum(layer(p, xx) ** 2)

    want = np.asarray(layer(placed, jnp.asarray(x)))
    g_p, g_x = jax.grad(loss, argnums=(0, 1))(placed, jnp.asarray(x))
    ranks = [r[name] for r in got]
    out = np.concatenate([r[0] for r in ranks])
    np.testing.assert_allclose(out, want, **TOL)
    np.testing.assert_array_equal(np.all(out == 0, -1), np.all(want == 0, -1))
    if name.startswith("tight"):
        assert np.all(out == 0, -1).any()           # drops are live
    grads = {"x": np.concatenate([r[1] for r in ranks]),
             "router": np.sum([r[2] for r in ranks], axis=0),
             "w1": np.concatenate([r[3] for r in ranks]),
             "w2": np.concatenate([r[4] for r in ranks])}
    want_g = {"x": g_x, **g_p}
    for k, g in grads.items():
        np.testing.assert_allclose(g, np.asarray(want_g[k]), atol=1e-4,
                                   rtol=1e-4, err_msg=k)
