"""The port's ZeRO-3 / FSDP against the JAX reference
(``tpu_p2p/parallel/fsdp.py``, ``tests/test_fsdp.py``'s cases).

- the plan functions, on the reference's own inputs and on every
  flagship leaf of the five-axis meshes dp 4, dp 2 x tp 2, dp 2 x pp 2
  and dp 2 x ep 2: equal output;
- ``bucketed_all_gather`` on a gloo world of 4: bitwise the per-leaf
  gather and the reference's, mixed dtypes and a ``bucket_bytes`` cap;
  its backward bitwise the reference's ``psum_scatter`` transpose
  (integer cotangents, so every order of the sum is exact);
- one SGD step of ``zero_dp`` (bulk gather) and of ``overlap=
  "prefetch"`` against the reference's same step on the same mesh,
  prefetch under remat, the LM step, ZeRO on an ep mesh, and the grad
  function (grads shaped like the shards). Tolerances are those of
  ``tests/test_torch_flagship_mesh.py`` for a sharded step: loss
  relative 1e-4, every leaf atol = rtol = 2e-4;
- the port against itself: ZeRO against replicated dp within the
  reference test's 1e-5, prefetch against the bulk gather bitwise where
  both sum in the same order (dp 2, one microbatch, one pp stage: a
  reduce-scatter of two addends) and within 1e-5 where they do not (dp
  4, or several microbatches: the prefetch sums each microbatch's
  gradient over dp before adding microbatches, the bulk gather after),
  and a dp axis of size 1 a bitwise no-op;
- the knob's validation, and ``train --cpu-mesh 4 --zero-dp --overlap
  prefetch --remat`` against the reference's ``run_training``.

The parent computes the reference on its 8-device CPU mesh; the port's
ranks run in gloo worlds (``tests/torch_flagship_world.py``, torch
only), each with its own timeout.
"""

import io
import json
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from tpu_p2p import train as JT
from tpu_p2p.models import flagship as JF
from tpu_p2p.parallel import collectives as JC
from tpu_p2p.parallel import fsdp as JFS
from tpu_p2p_torch.models import flagship as TF
from tpu_p2p_torch.parallel import fsdp as TFS
from tpu_p2p_torch.parallel.launch import run_world

REPO = pathlib.Path(__file__).resolve().parents[1]
WORLD = os.path.join(os.path.dirname(__file__), "torch_flagship_world.py")
LOSS_RTOL = 1e-4
LEAF = dict(atol=2e-4, rtol=2e-4)
SELF = dict(atol=1e-5, rtol=1e-5)   # tests/test_fsdp.py's own tolerance
LR = 1e-2
BASE = dict(batch=8, seq=16, heads=4, head_dim=8, stages=2, microbatches=2,
            num_experts=2, capacity_factor=4.0)
PLAN_MESHES = {"dp4": (4, 1, 1, 1, 1), "dp2xtp2": (2, 1, 1, 2, 1),
               "dp2xpp2": (2, 2, 1, 1, 1), "dp2xep2": (2, 1, 1, 1, 2)}
PLAN_CFGS = {"moe": {}, "dense": {"dense_ffn": True},
             "lm_norm": {"vocab": 64, "norm": True}}


def _spec(p) -> tuple:
    """A reference PartitionSpec as the port's tuple."""
    return tuple(p)


# ------------------------------------------------------------ the plan


def test_fsdp_plan_picks_first_free_divisible_dim():
    shapes = {"a": (4, 6, 8), "b": (3, 5), "c": (8, 2)}
    specs = {"a": ("tp", None, None), "b": (None, None), "c": (None, None)}
    plan = TFS.fsdp_plan(shapes, specs, axis_size=4)
    assert plan == JFS.fsdp_plan(
        shapes, {k: P(*v) for k, v in specs.items()}, axis_size=4)
    assert plan == {"a": 2, "b": None, "c": 0}
    out = TFS.fsdp_specs(specs, plan, "dp")
    want = JFS.fsdp_specs({k: P(*v) for k, v in specs.items()}, plan, "dp")
    assert out == {k: _spec(v) for k, v in want.items()}
    assert TFS.fsdp_plan({"a": (4, 4)}, {"a": (None, None)}, 1) == \
        JFS.fsdp_plan({"a": (4, 4)}, {"a": P(None, None)}, 1) == {"a": None}


def test_fsdp_specs_rejects_already_sharded_dim():
    with pytest.raises(ValueError, match="already sharded"):
        TFS.fsdp_specs({"a": ("tp", None)}, {"a": 0}, "dp")


def test_split_plan_for_prefetch_matches_reference():
    plan = {"wq": 2, "we1": 3, "emb": 0, "lnf": None, "odd": 0}
    stage = ("wq", "we1", "odd")
    assert TFS.split_plan_for_prefetch(plan, stage) == \
        JFS.split_plan_for_prefetch(plan, stage)


@pytest.mark.parametrize("cfg_name", sorted(PLAN_CFGS))
@pytest.mark.parametrize("mesh_name", sorted(PLAN_MESHES))
def test_flagship_plan_and_specs_match_reference(mesh_name, cfg_name):
    dims = PLAN_MESHES[mesh_name]
    kw = {**BASE, **PLAN_CFGS[cfg_name], "zero_dp": True}
    jmesh = Mesh(np.array(jax.devices()[:int(np.prod(dims))]).reshape(dims),
                 JF.AXES)
    tmesh = SimpleNamespace(axis_names=TF.AXES,
                            shape=dict(zip(TF.AXES, dims)))
    jcfg, tcfg = JF.FlagshipConfig(**kw), TF.FlagshipConfig(**kw)
    plan = TF._fsdp_plan(tmesh, tcfg)
    assert plan == JF._fsdp_plan(jmesh, jcfg)
    assert plan and any(d is not None for d in plan.values())
    assert TF.flagship_param_specs(tmesh, tcfg) == {
        k: _spec(v) for k, v in JF.flagship_param_specs(jmesh, jcfg).items()}
    stage = set(plan) - set(TF.STAGELESS_LEAVES)
    assert TFS.split_plan_for_prefetch(plan, stage) == \
        JFS.split_plan_for_prefetch(plan, stage)


def test_zero_dp_without_dp_or_on_one_rank_is_no_plan():
    cfg = TF.FlagshipConfig(**BASE, zero_dp=True)
    assert TF._fsdp_plan(None, cfg) is None
    one = SimpleNamespace(axis_names=TF.AXES, shape=dict.fromkeys(TF.AXES, 1))
    assert TF._fsdp_plan(one, cfg) is None
    no_dp = SimpleNamespace(axis_names=("tp",), shape={"tp": 2})
    assert TF._fsdp_plan(no_dp, cfg) is None
    assert TF.flagship_param_specs(no_dp, cfg) == {
        k: v for k, v in TF._base_param_specs(no_dp).items()
        if k in TF.flagship_param_shapes(cfg)}


def test_overlap_and_remat_knobs_are_validated():
    with pytest.raises(ValueError, match="overlap"):
        TF.FlagshipConfig(overlap="prefetched")
    with pytest.raises(ValueError, match="zero_dp"):
        TF.FlagshipConfig(overlap="prefetch")
    cfg = TF.FlagshipConfig(zero_dp=True, overlap="prefetch", remat=True,
                            remat_policy="dots_saveable")
    jcfg = JF.FlagshipConfig(zero_dp=True, overlap="prefetch", remat=True,
                             remat_policy="dots_saveable")
    for f in ("zero_dp", "overlap", "remat", "remat_policy"):
        assert getattr(cfg, f) == getattr(jcfg, f)


# ------------------------------------------------- the bucketed gather


def _bucket_cases():
    rng = np.random.default_rng(0)

    def ints(shape):
        return rng.integers(-8, 9, (4,) + shape).astype(np.float32)

    leaves = {"a": (rng.standard_normal((16, 3)).astype(np.float32), 0),
              "b": (rng.standard_normal((5, 24)).astype(np.float32), 1),
              "c": (rng.standard_normal((2, 8, 4)).astype(np.float32), 1)}
    bf = {"d": (rng.standard_normal((8, 4)).astype(np.float32), 0)}
    cases = []
    for name, ls, cap in (("one_bucket", leaves, None),
                          ("capped_8_bytes", leaves, 8),
                          ("mixed_dtypes", {**leaves, **bf}, 96)):
        cases.append({"name": name, "leaves": ls, "bucket_bytes": cap,
                      "bf16": sorted(bf) if ls is not leaves else [],
                      "cot": {k: ints(a.shape) for k, (a, _) in ls.items()}})
    return cases


BUCKET_CASES = _bucket_cases()


@pytest.fixture(scope="module")
def bucket_world():
    return run_world(4, f"{WORLD}:bucket_case", {"cases": BUCKET_CASES},
                     timeout=120)


def _reference_bucketed(c):
    """The reference's bucketed gather and its vjp inside a 4-device
    ``shard_map`` over "dp" → (gathered, shard grads), as float32."""
    names = sorted(c["leaves"])
    dims = [c["leaves"][k][1] for k in names]
    dtypes = [jnp.bfloat16 if k in c["bf16"] else jnp.float32 for k in names]
    mesh = Mesh(np.array(jax.devices()[:4]), ("dp",))

    def spec(d, ndim):
        e = [None] * ndim
        e[d] = "dp"
        return P(*e)

    def f(*args):
        shards, cots = args[:len(names)], args[len(names):]

        def gather(*sh):
            out = JC.bucketed_all_gather(
                {k: (s, d) for k, s, d in zip(names, sh, dims)}, "dp",
                bucket_bytes=c["bucket_bytes"])
            return tuple(out[k] for k in names)

        full, vjp = jax.vjp(gather, *shards)
        grads = vjp(tuple(g[0].astype(v.dtype) for g, v in zip(cots, full)))
        return tuple(v[None] for v in full) + tuple(grads)

    arrs = [jnp.asarray(c["leaves"][k][0], dt) for k, dt in zip(names, dtypes)]
    cots = [jnp.asarray(c["cot"][k]) for k in names]
    in_specs = tuple(spec(d, a.ndim) for d, a in zip(dims, arrs)) + tuple(
        P("dp", *([None] * a.ndim)) for a in arrs)
    out_specs = tuple(P("dp", *([None] * a.ndim)) for a in arrs) + tuple(
        spec(d, a.ndim) for d, a in zip(dims, arrs))
    outs = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs))(*arrs, *cots)
    full = {k: np.asarray(o, np.float32) for k, o in zip(names, outs)}
    grads = {k: np.asarray(o, np.float32)
             for k, o in zip(names, outs[len(names):])}
    return full, grads, {k: a for k, a in zip(names, arrs)}


@pytest.mark.parametrize("case", BUCKET_CASES,
                         ids=[c["name"] for c in BUCKET_CASES])
def test_bucketed_all_gather_bitwise(bucket_world, case):
    full, grads, arrs = _reference_bucketed(case)
    for r, res in enumerate(bucket_world):
        got, one, g = res[case["name"]]
        for k, (a, d) in case["leaves"].items():
            whole = np.asarray(arrs[k], np.float32)
            # every rank holds the whole leaf, bitwise the per-leaf
            # gather and the reference's rows
            np.testing.assert_array_equal(got[k], whole, err_msg=k)
            np.testing.assert_array_equal(one[k], whole, err_msg=k)
            np.testing.assert_array_equal(got[k], full[k][r], err_msg=k)
            # the backward: this rank's block of the summed cotangents
            summed = case["cot"][k].sum(0)
            n = summed.shape[d] // 4
            block = np.take(summed, range(r * n, (r + 1) * n), axis=d)
            np.testing.assert_array_equal(g[k], block, err_msg=k)
            np.testing.assert_array_equal(
                g[k], np.take(grads[k], range(r * n, (r + 1) * n), axis=d),
                err_msg=k)


def test_bucketed_all_gather_rejects_bad_dim_on_one_rank():
    import torch

    from tpu_p2p_torch.parallel.collectives import bucketed_all_gather

    with pytest.raises(ValueError, match="gather dim 2 out of range"):
        bucketed_all_gather({"a": (torch.zeros(2, 2), 2)}, None)
    x = torch.ones(3)
    assert bucketed_all_gather({"a": (x, 0)}, None)["a"] is x


# ------------------------------------------------------ the step


def make_case(name, dims, seed=0, grads=False, **kw):
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
    return {"name": name, "dims": tuple(dims), "cfg": cfg_kw, "grads": grads,
            "params": params, "batch": batch, "lr": LR}


def reference_mesh(dims):
    """The reference's mesh for the port's ``dims``: its axes of size >
    1 alone, as ``tests/test_fsdp.py`` builds them. (The reference's
    prefetch does not trace on the five-axis mesh with size-1 axes: the
    gathered params' varying axes include tp, and its pipeline scan
    carry's do not, ``tpu_p2p/models/pipeline.py:157``.) Size-1 axes
    change no value."""
    axes = tuple(a for a, n in zip(JF.AXES, dims) if n > 1) or ("dp",)
    shape = tuple(n for n in dims if n > 1) or (1,)
    return Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                axes)


def reference(case):
    """The reference's step (or grad function) on its mesh of
    ``case["dims"]`` → (loss, params or grads as numpy)."""
    mesh = reference_mesh(case["dims"])
    cfg = JF.FlagshipConfig(**case["cfg"])
    placed = JF.place_flagship_params(
        {k: jnp.asarray(v) for k, v in case["params"].items()}, mesh, cfg)
    batch = [jnp.asarray(a) for a in case["batch"]]
    if case["grads"]:
        make = (JF.make_flagship_lm_grad_fn if cfg.vocab
                else JF.make_flagship_grad_fn)
        new, loss = make(mesh, cfg)(placed, *batch)
    else:
        make = (JF.make_flagship_lm_train_step if cfg.vocab
                else JF.make_flagship_train_step)
        new, loss = make(mesh, cfg, lr=case["lr"])(placed, *batch)
    return float(loss), {k: np.asarray(v) for k, v in new.items()}


Z = dict(zero_dp=True)
ZP = dict(zero_dp=True, overlap="prefetch")
STEP_CASES = [
    make_case("replicated_dp4", (4, 1, 1, 1, 1)),
    make_case("zero_dp4", (4, 1, 1, 1, 1), **Z),
    make_case("zero_dp2xtp2", (2, 1, 1, 2, 1), **Z),
    make_case("prefetch_dp4", (4, 1, 1, 1, 1), **ZP),
    make_case("prefetch_dp2xtp2", (2, 1, 1, 2, 1), **ZP),
    make_case("prefetch_dp2xpp2", (2, 2, 1, 1, 1), **ZP),
    make_case("prefetch_remat_dp4", (4, 1, 1, 1, 1), remat=True, **ZP),
    make_case("prefetch_lm_dp4", (4, 1, 1, 1, 1), seed=3, vocab=64,
              norm=True, **ZP),
    make_case("prefetch_remat_dp2xep2", (2, 1, 1, 1, 2), seed=5, remat=True,
              **ZP),
    make_case("grads_prefetch_dp4", (4, 1, 1, 1, 1), grads=True, **ZP),
    # the port against itself: dp 2, one microbatch, one pp stage
    make_case("zero_dp2_mb1", (2, 1, 1, 2, 1), microbatches=1,
              dense_ffn=True, **Z),
    make_case("prefetch_dp2_mb1", (2, 1, 1, 2, 1), microbatches=1,
              dense_ffn=True, **ZP),
    # a dp axis of size 1: no plan, the plain step
    make_case("plain_tp2xpp2", (1, 2, 1, 2, 1)),
    make_case("noop_tp2xpp2", (1, 2, 1, 2, 1), **ZP),
]
STEPS = {c["name"]: c for c in STEP_CASES}


@pytest.fixture(scope="module")
def world():
    return run_world(4, f"{WORLD}:step_case", {"cases": STEP_CASES},
                     timeout=240)


@pytest.mark.parametrize("name", sorted(STEPS))
def test_step_matches_reference(world, name):
    case = STEPS[name]
    loss, want = reference(case)
    for r, res in enumerate(world):
        np.testing.assert_allclose(res[name]["loss"], loss, rtol=LOSS_RTOL,
                                   err_msg=f"{name} rank {r}")
    ours = world[0][name]["params"]
    assert sorted(ours) == sorted(want)
    scale = (1.0 / (case["cfg"]["batch"] * case["cfg"]["seq"]
                    * JF.FlagshipConfig(**case["cfg"]).model_dim)
             if case["grads"] else 1.0)   # grads as the step applies them
    for k in want:
        assert ours[k].shape == want[k].shape, (name, k)
        np.testing.assert_allclose(ours[k] * scale, want[k] * scale,
                                   err_msg=f"{name} {k}", **LEAF)


def test_zero_dp_shards_storage_and_grads(world):
    """Each planned leaf's shard is 1/4 of the leaf on dp 4, and its
    gradient has the shard's shape (grads shard like the params)."""
    case = STEPS["grads_prefetch_dp4"]
    tcfg = TF.FlagshipConfig(**case["cfg"])
    mesh = SimpleNamespace(axis_names=TF.AXES,
                           shape=dict(zip(TF.AXES, case["dims"])))
    plan = TF._fsdp_plan(mesh, tcfg)
    for res in world:
        for k, (g_shape, p_shape) in res[case["name"]]["shapes"].items():
            assert g_shape == p_shape, k
            full = case["params"][k].shape
            if plan[k] is not None:
                assert np.prod(p_shape) * 4 == np.prod(full), (k, p_shape)
            else:
                assert p_shape == full, k


@pytest.mark.parametrize("a,b,bitwise", [
    ("zero_dp4", "replicated_dp4", False),
    ("prefetch_dp4", "zero_dp4", False),
    ("prefetch_dp2_mb1", "zero_dp2_mb1", True),
    ("noop_tp2xpp2", "plain_tp2xpp2", True),
], ids=["zero_vs_replicated", "prefetch_vs_bulk_dp4",
        "prefetch_vs_bulk_dp2_mb1", "dp1_noop"])
def test_port_schedules_agree(world, a, b, bitwise):
    """The port's schedules against each other: the same function of the
    data, summed in the same order (bitwise) or not (the reference
    test's 1e-5)."""
    for res in world:
        if bitwise:
            assert res[a]["loss"] == res[b]["loss"]
        else:
            np.testing.assert_allclose(res[a]["loss"], res[b]["loss"],
                                       rtol=1e-6)
    pa, pb = world[0][a]["params"], world[0][b]["params"]
    for k in pb:
        if bitwise:
            np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)
        else:
            np.testing.assert_allclose(pa[k], pb[k], err_msg=k, **SELF)


def test_world_of_one_prefetch_remat_is_plain_step():
    """Without a mesh there is no plan: ``zero_dp`` with prefetch is the
    plain step bitwise (the reference's one-device no-op)."""
    import torch

    kw = {**BASE, "batch": 2, "microbatches": 1}
    params = TF.init_flagship_params(TF.FlagshipConfig(**kw), seed=0,
                                     device="cpu")
    rng = np.random.default_rng(1)
    x, t = (torch.from_numpy(rng.standard_normal((2, 16, 32))
                             .astype(np.float32)) for _ in range(2))
    got = [TF.make_flagship_train_step(TF.FlagshipConfig(**kw, **extra))(
        {k: v.clone() for k, v in params.items()}, x, t)
        for extra in ({}, ZP)]
    assert torch.equal(got[0][1], got[1][1])
    for k in params:
        assert torch.equal(got[0][0][k], got[1][0][k]), k


# ------------------------------------------------------ the train CLI

CLI = ["--batch", "8", "--seq", "32", "--heads", "4", "--kv-heads", "2",
       "--head-dim", "8", "--stages", "2", "--microbatches", "2",
       "--dense-ffn", "--steps", "4", "--log-every", "2", "--rope",
       "--norm", "--vocab", "64", "--mesh-shape", "4x1x1x1x1",
       "--zero-dp", "--overlap", "prefetch", "--remat"]


def test_train_cli_zero_prefetch_remat_matches_reference():
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_p2p_torch", "train", "--cpu-mesh", "4",
         "--device", "cpu", *CLI], capture_output=True, text=True,
        cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(s) for s in proc.stdout.splitlines()]
    got, summary = lines[:-1], lines[-1]["summary"]
    args = JT._build_parser().parse_args(
        [a for a in CLI if a not in ("--mesh-shape", "4x1x1x1x1")])
    mesh = reference_mesh((4, 1, 1, 1, 1))
    cfg = JF.FlagshipConfig(
        batch=args.batch, seq=args.seq, heads=args.heads,
        kv_heads=args.kv_heads, head_dim=args.head_dim, stages=args.stages,
        microbatches=args.microbatches, vocab=args.vocab, norm=args.norm,
        dense_ffn=args.dense_ffn, rope=args.rope, zero_dp=args.zero_dp,
        overlap=args.overlap, remat=args.remat)
    buf = io.StringIO()
    want_summary = JT.run_training(mesh, cfg, steps=args.steps,
                                   log_every=args.log_every, log_stream=buf)
    want = [json.loads(s) for s in buf.getvalue().splitlines()]
    assert [list(r) for r in got] == [list(r) for r in want]
    assert [r["step"] for r in got] == [r["step"] for r in want] == [2, 4]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL)
    assert summary["steps_run"] == want_summary["steps_run"] == 4
