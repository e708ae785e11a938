"""The port's copy of optax (``tpu_p2p_torch/utils/optim.py``) against
optax 0.2.6, and the optimizer step against the reference's
``make_flagship_optax_step``.

Every transformation and schedule runs 8 steps from numpy-seeded params
and gradients on both sides. bfloat16 states and params agree within 1
ulp; float32 ones within rtol 1e-6 (XLA rewrites ``m / bc / (sqrt(v) +
eps)`` into ``m / (bc * (sqrt(v) + eps))``, divisions by a constant
into products, and evaluates ``cos`` with its own polynomial, so those
steps round differently; the bias corrections and the bf16 arithmetic
match bitwise). The state's leaf paths equal ``jax.tree_util.keystr``
for the four chain shapes the training loop builds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_p2p.models import flagship as JF
from tpu_p2p_torch.models import flagship as TF
from tpu_p2p_torch.utils import optim as O

F32 = dict(rtol=1e-6, atol=1e-9)
LR = 1e-2
SHAPES = {"wq": (3, 5), "emb": (4, 2, 3), "ln1": (7,)}


def _ulps(a: np.ndarray, b: torch.Tensor) -> int:
    """Largest distance in bfloat16 ulps (same-sign values)."""
    x = np.asarray(a).view(np.int16).astype(np.int64)
    y = b.view(torch.int16).numpy().astype(np.int64)
    return int(np.abs(x - y).max()) if x.size else 0


def _assert_close(want, got: torch.Tensor, what: str):
    if got.dtype == torch.bfloat16:
        assert _ulps(want, got) <= 1, what
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=what, **F32)


TRANSFORMS = {
    "adamw": (lambda: optax.adamw(LR, weight_decay=0.01),
              lambda: O.adamw(LR, weight_decay=0.01)),
    "adamw_no_decay": (lambda: optax.adamw(LR, weight_decay=0.0),
                       lambda: O.adamw(LR, weight_decay=0.0)),
    "clip_adamw_cosine": (
        lambda: optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
            optax.warmup_cosine_decay_schedule(0.0, LR, 1, decay_steps=8),
            weight_decay=0.01)),
        lambda: O.chain(O.clip_by_global_norm(1.0), O.adamw(
            O.warmup_cosine_decay_schedule(0.0, LR, 1, 8),
            weight_decay=0.01))),
    "sgd_warmup": (
        lambda: optax.sgd(optax.schedules.join_schedules(
            [optax.schedules.linear_schedule(0.0, LR, 3),
             optax.schedules.constant_schedule(LR)], [3])),
        lambda: O.sgd(O.join_schedules(
            [O.linear_schedule(0.0, LR, 3), O.constant_schedule(LR)], [3]))),
    "clip_sgd": (
        lambda: optax.chain(optax.clip_by_global_norm(0.5), optax.sgd(LR)),
        lambda: O.chain(O.clip_by_global_norm(0.5), O.sgd(LR))),
    "sgd_cosine": (
        lambda: optax.sgd(optax.warmup_cosine_decay_schedule(
            0.0, LR, 0, decay_steps=6)),
        lambda: O.sgd(O.warmup_cosine_decay_schedule(0.0, LR, 0, 6))),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_optax_over_8_steps(name, dtype):
    make_j, make_t = TRANSFORMS[name]
    rng = np.random.default_rng(0)
    host = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}
    jp = {k: jnp.asarray(v).astype(dtype) for k, v in host.items()}
    tp = TF.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                              "cpu")
    jtx, ttx = make_j(), make_t()
    js, ts = jtx.init(jp), ttx.init(tp)

    @jax.jit
    def jstep(p, s, g):
        u, s = jtx.update(g, s, p)
        return optax.apply_updates(p, u), s

    for i in range(8):
        scale = 3.0 if i % 2 else 0.2  # clipping engages on odd steps
        g = {k: (rng.standard_normal(s) * scale).astype(np.float32)
             for k, s in SHAPES.items()}
        jg = {k: jnp.asarray(v).astype(dtype) for k, v in g.items()}
        tg = TF.params_from_numpy({k: np.asarray(v) for k, v in jg.items()},
                                  "cpu")
        jp, js = jstep(jp, js, jg)
        u, ts = ttx.update(tg, ts, tp)
        tp = O.apply_updates(tp, u)
        for k in SHAPES:
            assert tp[k].dtype == TF.torch_dtype(dtype)
            _assert_close(jp[k], tp[k], f"step {i} {k}")
    jflat = jax.tree_util.tree_flatten_with_path(js)[0]
    tflat = O.tree_flatten_with_path(ts)
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == \
        [p for p, _ in tflat]
    for (path, jv), (_, tv) in zip(jflat, tflat):
        if tv.dtype == torch.int32:
            assert tv.device.type == "cpu" and tv.shape == ()
            assert int(tv) == int(jv) == 8, path
        else:
            _assert_close(jv, tv, path)


SCHEDULES = {
    "constant": (lambda: optax.schedules.constant_schedule(LR),
                 lambda: O.constant_schedule(LR)),
    "linear": (lambda: optax.schedules.linear_schedule(0.0, LR, 5),
               lambda: O.linear_schedule(0.0, LR, 5)),
    "warmup_join": (
        lambda: optax.schedules.join_schedules(
            [optax.schedules.linear_schedule(0.0, LR, 3),
             optax.schedules.constant_schedule(LR)], [3]),
        lambda: O.join_schedules([O.linear_schedule(0.0, LR, 3),
                                  O.constant_schedule(LR)], [3])),
    "warmup_cosine": (
        lambda: optax.warmup_cosine_decay_schedule(0.0, LR, 2,
                                                   decay_steps=10),
        lambda: O.warmup_cosine_decay_schedule(0.0, LR, 2, 10)),
    "cosine_no_warmup": (
        lambda: optax.warmup_cosine_decay_schedule(0.0, LR, 0,
                                                   decay_steps=6),
        lambda: O.warmup_cosine_decay_schedule(0.0, LR, 0, 6)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_optax(name):
    make_j, make_t = SCHEDULES[name]
    jfn, tfn = jax.jit(make_j()), make_t()
    for count in range(14):  # past the horizon too
        want = np.float32(jfn(jnp.int32(count)))
        got = tfn(torch.tensor(count, dtype=torch.int32))
        got = np.float32(got.item() if isinstance(got, torch.Tensor)
                         else got)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0,
                                   err_msg=f"count {count}")


@pytest.mark.parametrize("decay", [0.9, 0.999])
def test_bias_correction_is_bitwise_optax(decay):
    for count in range(1, 40):
        want = np.float32(jax.jit(lambda c: 1 - decay ** c)(jnp.int32(count)))
        got = O._bias_correction(decay, torch.tensor(count, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert np.float32(got.item()) == want, count


def test_count_saturates_at_int32_max():
    top = torch.tensor(2**31 - 1, dtype=torch.int32)
    assert int(O.safe_increment(top)) == 2**31 - 1
    assert int(O.safe_increment(torch.tensor(4, dtype=torch.int32))) == 5


# -------------------------------------------------------- leaf paths

CHAINS = {
    "clip_adamw_cosine": (
        lambda: optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
            optax.warmup_cosine_decay_schedule(0.0, LR, 1, decay_steps=4),
            weight_decay=0.01)),
        lambda: O.make_optimizer("adamw", LR, steps=4, weight_decay=0.01,
                                 clip_norm=1.0, warmup_steps=1,
                                 schedule="cosine")),
    "adamw_lr": (lambda: optax.adamw(LR, weight_decay=0.0),
                 lambda: O.make_optimizer("adamw", LR, steps=4)),
    "sgd_warmup": (
        lambda: optax.sgd(optax.schedules.join_schedules(
            [optax.schedules.linear_schedule(0.0, LR, 2),
             optax.schedules.constant_schedule(LR)], [2])),
        lambda: O.make_optimizer("sgd", LR, steps=4, warmup_steps=2)),
    "clip_sgd_lr": (
        lambda: optax.chain(optax.clip_by_global_norm(1.0), optax.sgd(LR)),
        lambda: O.make_optimizer("sgd", LR, steps=4, clip_norm=1.0)),
}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_leaf_paths_equal_keystr(name):
    cfg = dict(batch=2, seq=16, heads=2, head_dim=8, stages=2,
               microbatches=1, dense_ffn=True, vocab=32)
    jp = JF.init_flagship_params(JF.FlagshipConfig(**cfg), seed=0)
    tp = TF.init_flagship_params(TF.FlagshipConfig(**cfg), seed=0,
                                 device="cpu")
    make_j, make_t = CHAINS[name]
    js, ts = make_j().init(jp), make_t().init(tp)
    want = [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(js)[0]]
    assert O.leaf_paths(ts) == want
    if name == "clip_sgd_lr":
        assert want == [] and ts is not None   # no leaves, still a state
    if name == "clip_adamw_cosine":
        assert want[0] == "[1][0].count" and want[-1] == "[1][2].count"
        assert want[1] == "[1][0].mu['emb']"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moments_take_the_param_dtype(dtype):
    cfg = TF.FlagshipConfig(batch=2, seq=16, heads=2, head_dim=8, stages=2,
                            microbatches=1, dense_ffn=True, dtype=dtype)
    params = TF.init_flagship_params(cfg, seed=0, device="cpu")
    state = TF.init_optimizer(O.make_optimizer("adamw", LR, steps=4),
                              params)
    adam = state[0]
    assert adam.count.dtype == torch.int32 and adam.count.shape == ()
    for k, p in params.items():
        assert adam.mu[k].dtype == adam.nu[k].dtype == p.dtype
        assert adam.mu[k].shape == adam.nu[k].shape == p.shape


@pytest.mark.parametrize("pdt,udt", [("bfloat16", "bfloat16"),
                                     ("float32", "bfloat16"),
                                     ("float32", "float32")])
def test_apply_updates_is_bitwise_optax(pdt, udt):
    rng = np.random.default_rng(3)
    jp = jnp.asarray(rng.standard_normal(4096).astype(np.float32)).astype(pdt)
    ju = jnp.asarray((rng.standard_normal(4096) * 1e-2).astype(
        np.float32)).astype(udt)
    want = np.asarray(jax.jit(optax.apply_updates)({"w": jp}, {"w": ju})["w"])
    tp = TF.params_from_numpy({"w": np.asarray(jp)}, "cpu")
    tu = TF.params_from_numpy({"w": np.asarray(ju)}, "cpu")
    got = O.apply_updates(tp, tu)["w"]
    assert got.dtype == tp["w"].dtype            # no widening of p
    assert np.array_equal(got.view(torch.int16).numpy() if pdt == "bfloat16"
                          else got.numpy(),
                          want.view(np.int16) if pdt == "bfloat16" else want)
    assert O.apply_updates(tp, tu, in_place=True) is tp
    assert torch.equal(tp["w"], got)


def test_optax_sgd_path_stays_apart_from_the_plain_sgd_update():
    # The plain step computes p - lr*g/denom (widened to float32); the
    # optax path divides g by denom first, scales by -lr and adds in the
    # param dtype. The two round differently; each holds to its
    # reference (the plain one bitwise, tests/test_torch_train.py).
    rng = np.random.default_rng(4)
    denom = 4 * 32 * 3
    host = {"w": rng.standard_normal(8192).astype(np.float32)}
    grad = {"w": rng.standard_normal(8192).astype(np.float32)}
    tp = TF.params_from_numpy(host, "cpu")
    tg = TF.params_from_numpy(grad, "cpu")
    plain = TF._sgd_update(tp, tg, LR, denom)["w"]
    jtx = optax.sgd(LR)

    @jax.jit
    def jstep(p, g):
        g = jax.tree.map(lambda x: x / denom, g)
        u, _ = jtx.update(g, jtx.init(p), p)
        return optax.apply_updates(p, u)

    ttx = O.sgd(LR)
    u, _ = ttx.update({"w": tg["w"] / torch.tensor(denom)}, ttx.init(tp), tp)
    via_optax = O.apply_updates(tp, u)["w"]
    want = jstep({"w": jnp.asarray(host["w"])},
                 {"w": jnp.asarray(grad["w"])})["w"]
    np.testing.assert_allclose(via_optax.numpy(), np.asarray(want), **F32)
    assert not torch.equal(plain, via_optax)


def test_clip_reduce_sees_every_leaf_sum():
    seen = {}

    def reduce(sums):
        seen.update({k: float(v) for k, v in sums.items()})
        for v in sums.values():
            v.mul_(4.0)   # as if four ranks held equal shards

    g = {"a": torch.full((2, 2), 1.0), "b": torch.full((3,), 2.0)}
    out, _ = O.clip_by_global_norm(1.0, reduce).update(g, O.EmptyState())
    assert seen == {"a": 4.0, "b": 12.0}
    norm = np.sqrt(4 * 16.0)
    np.testing.assert_allclose(out["a"].numpy(), 1.0 / norm, rtol=1e-6)


# ------------------------------------------- the step and the carry

LM = dict(batch=4, seq=32, heads=4, kv_heads=2, head_dim=8, stages=2,
          microbatches=2, dense_ffn=True, rope=True, norm=True, vocab=64,
          use_flash=True)


def test_optax_step_matches_reference_and_carries_state():
    jcfg, tcfg = JF.FlagshipConfig(**LM), TF.FlagshipConfig(**LM)
    mesh = JF.build_mesh(1, devices=jax.devices()[:1])
    jtx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
        optax.warmup_cosine_decay_schedule(0.0, LR, 1, decay_steps=4),
        weight_decay=0.01))
    ttx = O.make_optimizer("adamw", LR, steps=4, weight_decay=0.01,
                           clip_norm=1.0, warmup_steps=1, schedule="cosine")
    jp = JF.place_flagship_params(JF.init_flagship_params(jcfg, seed=0),
                                  mesh, jcfg)
    js = JF.init_optimizer(jtx, jp)
    jstep = JF.make_flagship_optax_step(mesh, jcfg, jtx, lm=True)
    rng = np.random.default_rng(5)

    def toks():
        t = rng.integers(0, 64, (4, 33)).astype(np.int32)
        return t[:, :-1], t[:, 1:]

    x, t = toks()
    jp, js, _ = jstep(jp, js, jnp.asarray(x), jnp.asarray(t))
    # Carry the reference's state after one step into the port, then
    # take a step on each side from the same params and state.
    tp = TF.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                              "cpu")
    flat = jax.tree_util.tree_flatten_with_path(js)[0]
    ts = TF.opt_state_from_numpy(
        [np.asarray(v) for _, v in flat], TF.init_optimizer(ttx, tp),
        paths=[jax.tree_util.keystr(p) for p, _ in flat])
    for (_, jv), tv in zip(flat, O.tree_leaves(ts)):
        assert np.array_equal(np.asarray(jv), tv.numpy())   # bitwise
    tstep = TF.make_flagship_optax_step(tcfg, ttx, lm=True, donate=True)
    for _ in range(2):
        x, t = toks()
        jp, js, jl = jstep(jp, js, jnp.asarray(x), jnp.asarray(t))
        got = tstep(tp, ts, torch.from_numpy(x), torch.from_numpy(t))
        assert got[0] is tp                      # donated: in place
        tp, ts, tl = got
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for k in tp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=2e-5, rtol=2e-5, err_msg=k)
    assert int(ts[1][0].count) == int(js[1][0].count) == 3
    with pytest.raises(ValueError, match="leaf paths"):
        TF.opt_state_from_numpy([np.asarray(v) for _, v in flat], ts,
                                paths=["[0].count"] * len(flat))
