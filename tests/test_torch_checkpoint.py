"""The port's durable checkpoints (``tpu_p2p_torch/utils/checkpoint.py``),
storage faults (``obs/faults.py``) and bounded retry
(``utils/retry.py``) against the reference's.

Exact throughout: a generation the port writes is byte-equal, file by
file, to the reference's for the same state (float32 and bfloat16, with
and without optimizer state); each side loads the other's; the fallback
ladder names every damage shape in the reference's words; a crash at
any byte count leaves both sides with the same visible generations;
the seeded rot flips the same bit. Inputs are numpy-seeded.
"""

import io
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_p2p.models import flagship as JF
from tpu_p2p.obs import faults as JFaults
from tpu_p2p.utils import checkpoint as JC
from tpu_p2p.utils.retry import retry_io as j_retry_io
from tpu_p2p_torch.models import flagship as TF
from tpu_p2p_torch.obs import faults as TFaults
from tpu_p2p_torch.utils import checkpoint as TC
from tpu_p2p_torch.utils import optim as O
from tpu_p2p_torch.utils.retry import DEFAULT_ATTEMPTS, retry_io

CFG = dict(batch=2, seq=16, heads=2, head_dim=8, stages=2, microbatches=1,
           dense_ffn=True, vocab=32)


def _tiny(offset=0.0):
    return {"w": np.arange(16, dtype=np.float32).reshape(4, 4) + offset,
            "b": np.full((3,), 1.5 + offset, np.float32)}


def _files(gen_dir):
    return {f: open(os.path.join(gen_dir, f), "rb").read()
            for f in sorted(os.listdir(gen_dir))}


def _states(dtype, with_opt):
    """The same params (and AdamW state after one update) on both
    sides: (jax params, jax state, torch params, torch state)."""
    jcfg = JF.FlagshipConfig(**CFG, dtype=dtype)
    tcfg = TF.FlagshipConfig(**CFG, dtype=dtype)
    jp = JF.init_flagship_params(jcfg, seed=0)
    tp = TF.init_flagship_params(tcfg, seed=0, device="cpu")
    if not with_opt:
        return jp, None, tp, None
    jtx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
        optax.warmup_cosine_decay_schedule(0.0, 1e-2, 1, decay_steps=4),
        weight_decay=0.01))
    js = jtx.init(jp)
    rng = np.random.default_rng(1)
    g = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32)
                        ).astype(v.dtype) for k, v in jp.items()}
    _, js = jax.jit(jtx.update)(g, js, jp)
    ttx = O.make_optimizer("adamw", 1e-2, steps=4, weight_decay=0.01,
                           clip_norm=1.0, warmup_steps=1, schedule="cosine")
    ts = TF.opt_state_from_numpy(
        [np.asarray(v) for v in jax.tree_util.tree_leaves(js)],
        ttx.init(tp))
    return jp, js, tp, ts


@pytest.mark.parametrize("with_opt", [False, True], ids=["params", "adamw"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generation_is_byte_equal_to_the_reference(tmp_path, dtype,
                                                   with_opt):
    jp, js, tp, ts = _states(dtype, with_opt)
    sched = {"optimizer": "adamw", "lr": 0.01} if with_opt else None
    a = JC.save_generation(str(tmp_path / "j"), jp, 4, opt_state=js,
                           sched_meta=sched)
    b = TC.save_generation(str(tmp_path / "t"), tp, 4, opt_state=ts,
                           sched_meta=sched)
    want, got = _files(a["path"]), _files(b["path"])
    assert sorted(got) == sorted(want)
    for f in want:
        assert got[f] == want[f], f
    assert b["bytes"] == a["bytes"] and b["name"] == a["name"] == \
        "gen-000004"
    for root in ("j", "t"):
        assert (tmp_path / root / "LATEST").read_text() == "gen-000004\n"
    if dtype == "bfloat16":
        meta = json.loads(want["tpu_p2p_checkpoint.json"])
        assert set(meta["dtypes"].values()) == {"bfloat16"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_each_side_loads_the_others_generation(tmp_path, dtype):
    jp, js, tp, ts = _states(dtype, True)
    JC.save_generation(str(tmp_path / "j"), jp, 2, opt_state=js)
    TC.save_generation(str(tmp_path / "t"), tp, 2, opt_state=ts)
    got = TC.load_latest(str(tmp_path / "j"))      # the port reads the ref
    assert got.name == "gen-000002" and got.step == 2
    assert list(got.params) == list(tp)
    for k in tp:
        assert got.params[k].dtype == tp[k].dtype
        assert torch.equal(got.params[k], tp[k]), k
    state = TC.load_opt_state(got.path, ts, expect_step=2)
    for a, b in zip(O.tree_leaves(state), O.tree_leaves(ts)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    want = JC.load_latest(str(tmp_path / "t"))     # the ref reads the port
    for k in jp:
        a, b = np.asarray(want.params[k]), np.asarray(jp[k])
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    jstate = JC.load_opt_state(want.path, js, expect_step=2)
    for a, b in zip(jax.tree_util.tree_leaves(jstate),
                    jax.tree_util.tree_leaves(js)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_empty_optimizer_state_still_writes_its_files(tmp_path):
    # chain(clip, sgd(lr)) has no leaves, but its state is not None: the
    # generation holds a 22-byte opt_state.npz and the schedule meta.
    jtx = optax.chain(optax.clip_by_global_norm(1.0), optax.sgd(1e-2))
    ttx = O.make_optimizer("sgd", 1e-2, steps=4, clip_norm=1.0)
    p = _tiny()
    a = JC.save_generation(str(tmp_path / "j"), p, 2,
                           opt_state=jtx.init(p), sched_meta={"x": 1})
    b = TC.save_generation(str(tmp_path / "t"), p, 2,
                           opt_state=ttx.init(TF.params_from_numpy(p, "cpu")),
                           sched_meta={"x": 1})
    assert _files(b["path"]) == _files(a["path"])
    assert len(_files(b["path"])["opt_state.npz"]) == 22


# ------------------------------------------------- the fallback ladder


def _damage(gen_dir, how, C):
    """One damage shape, as tests/test_checkpoint.py's ``_damage``."""
    if how == "bad_checksum":
        fp = os.path.join(gen_dir, "params.npz")
        data = bytearray(open(fp, "rb").read())
        data[len(data) // 2] ^= 0x10
        open(fp, "wb").write(bytes(data))
    elif how == "truncated":
        fp = os.path.join(gen_dir, "params.npz")
        data = open(fp, "rb").read()
        open(fp, "wb").write(data[: len(data) // 2])
    elif how == "missing_array":
        fp = os.path.join(gen_dir, "params.npz")
        with np.load(fp) as z:
            arrays = {k: z[k] for k in z.files}
        arrays.pop(sorted(arrays)[0])
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        data = buf.getvalue()
        open(fp, "wb").write(data)
        mf = os.path.join(gen_dir, C.MANIFEST)
        manifest = json.load(open(mf))
        manifest["files"]["params.npz"] = {
            "sha256": C._digest(data), "bytes": len(data)}
        json.dump(manifest, open(mf, "w"))
    elif how == "torn_manifest":
        mf = os.path.join(gen_dir, C.MANIFEST)
        text = open(mf).read()
        open(mf, "w").write(text[: len(text) // 2])
    elif how == "empty_dir":
        shutil.rmtree(gen_dir)
        os.makedirs(gen_dir)
    elif how == "missing_manifest":
        os.remove(os.path.join(gen_dir, C.MANIFEST))
    else:  # pragma: no cover - test bug
        raise AssertionError(how)


DAMAGE = ("bad_checksum", "truncated", "missing_array", "torn_manifest",
          "empty_dir", "missing_manifest")


@pytest.mark.parametrize("how", DAMAGE)
def test_fallback_ladder_every_damage_shape(tmp_path, how):
    # gens at 3/6/9, the newest damaged: both ladders land on 6 with
    # bitwise params and the same skip reason, word for word.
    for side, C in (("j", JC), ("t", TC)):
        td = str(tmp_path / side)
        for s in (3, 6, 9):
            C.save_generation(td, _tiny(s), s, keep=3)
        _damage(os.path.join(td, "gen-000009"), how, C)
    j, t = JC.load_latest(str(tmp_path / "j")), \
        TC.load_latest(str(tmp_path / "t"))
    assert t.name == j.name == "gen-000006" and t.step == 6
    assert t.skipped == j.skipped and len(t.skipped) == 1
    assert t.skipped[0]["generation"] == "gen-000009"
    np.testing.assert_array_equal(t.params["w"].numpy(), _tiny(6)["w"])
    assert TC.verify_generation(str(tmp_path / "t" / "gen-000009")) == \
        JC.verify_generation(str(tmp_path / "j" / "gen-000009"))
    assert TC.latest_intact_step(str(tmp_path / "t")) == 6


def test_fallback_exhausted_raises_with_reasons(tmp_path):
    msgs = []
    for side, C in (("j", JC), ("t", TC)):
        td = str(tmp_path / side)
        for s in (3, 6):
            C.save_generation(td, _tiny(s), s)
        _damage(os.path.join(td, "gen-000003"), "bad_checksum", C)
        _damage(os.path.join(td, "gen-000006"), "truncated", C)
        with pytest.raises(ValueError, match="no intact checkpoint") as e:
            C.load_latest(td)
        msgs.append(str(e.value).replace(td, "DIR"))
        assert C.latest_intact_step(td) is None
    assert msgs[0] == msgs[1]


def test_crash_point_sweep_matches_the_reference(tmp_path):
    # A simulated death after ANY byte count leaves no new generation or
    # a whole one, LATEST naming an intact one — and the same outcome
    # on both sides.
    for side, C in (("j", JC), ("t", TC)):
        C.save_generation(str(tmp_path / side), _tiny(0), 1, keep=10)
    step = 2
    for budget in (0, 1, 37, 512, 4096, 20_000, 200_000):
        seen = []
        for side, C, F in (("j", JC, JFaults), ("t", TC, TFaults)):
            td = str(tmp_path / side)
            plan = F.FaultPlan(ckpt_crash_after_bytes=budget)
            crash = None
            try:
                with F.injecting(plan):
                    C.save_generation(td, _tiny(step), step, keep=10)
            except F.SimulatedCrash as e:
                crash = (os.path.basename(e.path), e.bytes_written, e.step)
            gens = [n for _, n in C.list_generations(td)]
            for name in gens:
                assert C.verify_generation(os.path.join(td, name)) is None
            latest = C.read_latest_pointer(td)
            assert latest in gens
            seen.append((crash, gens, latest))
        assert seen[1] == seen[0], budget
        step += 1
    assert TC.load_latest(str(tmp_path / "t")).skipped == []


def test_retention_and_republish(tmp_path):
    td = str(tmp_path)
    for s in (1, 2, 3, 4, 5):
        stats = TC.save_generation(td, _tiny(s), s, keep=3)
    assert stats["pruned"] == ["gen-000002"]
    assert [n for _, n in TC.list_generations(td)] == [
        "gen-000005", "gen-000004", "gen-000003"]
    TC.save_generation(td, _tiny(9), 9, keep=1)
    assert [n for _, n in TC.list_generations(td)] == ["gen-000009"]
    _damage(os.path.join(td, "gen-000009"), "bad_checksum", TC)
    TC.save_generation(td, _tiny(9), 9)
    assert TC.verify_generation(os.path.join(td, "gen-000009")) is None
    assert not [n for n in os.listdir(td)
                if n.startswith((".tmp-gen-", ".stale-gen-"))]
    with pytest.raises(ValueError, match="keep must be >= 1"):
        TC.save_generation(td, _tiny(), 10, keep=0)


# ------------------------------------------------- the flat layout


def test_legacy_flat_layout_loads_and_places(tmp_path):
    cfg = TF.FlagshipConfig(**CFG)
    params = TF.init_flagship_params(cfg, seed=0, device="cpu")
    td = str(tmp_path / "flat")
    TC.save_params(td, params, step=4)
    JC.save_params(str(tmp_path / "ref"), JF.init_flagship_params(
        JF.FlagshipConfig(**CFG), seed=0), step=4)
    assert _files(td) == _files(str(tmp_path / "ref"))
    lc = TC.load_latest(td)
    assert lc.name is None and lc.step == 4 and lc.skipped == []
    got, step = TC.load_params(td)
    assert step == 4 and all(torch.equal(got[k], params[k]) for k in params)
    assert TC.has_checkpoint(td) and TC.latest_intact_step(td) == 4
    assert not TC.has_checkpoint(str(tmp_path / "none"))
    assert not TC.has_checkpoint(None)
    # A torn pair (new npz under an old meta) is detected.
    TC.save_params(str(tmp_path / "b"), {k: v + 1 for k, v in
                                         params.items()}, step=5)
    shutil.copy(str(tmp_path / "b" / "params.npz"),
                os.path.join(td, "params.npz"))
    with pytest.raises(ValueError, match="torn"):
        TC.load_params(td)


def test_load_params_places_this_ranks_shards(tmp_path):
    # Without a world: a one-rank "mesh" of the five axes places whole
    # leaves, as the cross-mesh resume does on a world of one.
    cfg = TF.FlagshipConfig(**CFG)
    params = TF.init_flagship_params(cfg, seed=0, device="cpu")
    TC.save_generation(str(tmp_path), params, 7)
    got, step = TC.load_params(str(tmp_path))
    assert step == 7 and list(got) == list(params)
    assert all(torch.equal(got[k], params[k]) for k in params)


def test_opt_state_flat_layout_and_its_refusals(tmp_path):
    a = np.ones((2, 2), np.float32)
    b = np.full((2, 2), 3.0, np.float32)
    for side, C in (("j", JC), ("t", TC)):
        C.save_opt_state(str(tmp_path / side), {"mu": a, "nu": b}, step=1)
    assert _files(str(tmp_path / "t")) == _files(str(tmp_path / "j"))
    td = str(tmp_path / "t")
    with pytest.raises(ValueError, match="mis-pair") as e:
        TC.load_opt_state(td, (a, b), expect_step=1)
    with pytest.raises(ValueError, match="mis-pair") as je:
        JC.load_opt_state(td, (a, b), expect_step=1)
    assert str(e.value) == str(je.value)
    with pytest.raises(ValueError, match="stale/torn"):
        TC.load_opt_state(td, {"mu": a, "nu": b}, expect_step=2)
    with pytest.raises(ValueError, match="has 2 leaves.*expects 3"):
        TC.load_opt_state(td, {"mu": a, "nu": b, "x": a})
    out = TC.load_opt_state(td, {"mu": np.zeros((2, 2), np.float32),
                                 "nu": np.zeros((2, 2), np.float32)},
                            expect_step=1)
    np.testing.assert_array_equal(out["nu"].numpy(), b)
    # A checkpoint from before the leaf-path fingerprint still loads.
    meta_path = os.path.join(td, "tpu_p2p_opt_state.json")
    meta = json.load(open(meta_path))
    del meta["leaf_paths"]
    json.dump(meta, open(meta_path, "w"))
    assert len(TC.load_opt_state(td, (a, b))) == 2
    TC.clear_opt_state(td)
    assert not os.listdir(td)


# --------------------------------------------- retry and the faults


def test_retry_io_matches_the_reference():
    for retry in (retry_io, j_retry_io):
        calls, slept, retried = {"n": 0}, [], []

        def flaky():
            calls["n"] += 1
            if calls["n"] <= 2:
                raise OSError("blip")
            return "ok"

        assert retry(flaky, attempts=5, base_delay_s=0.01,
                     sleep=slept.append,
                     on_retry=lambda i, e: retried.append(i)) == "ok"
        assert (calls["n"], retried, slept) == (3, [1, 2], [0.01, 0.02])
    assert DEFAULT_ATTEMPTS == 5
    with pytest.raises(OSError, match="down"):
        retry_io(lambda: (_ for _ in ()).throw(OSError("down")),
                 attempts=3, base_delay_s=0, sleep=lambda s: None)
    n = {"v": 0}

    def die():
        n["v"] += 1
        raise TFaults.SimulatedCrash("/x/params.npz", 7)

    with pytest.raises(TFaults.SimulatedCrash):
        retry_io(die, attempts=5, sleep=lambda s: None)
    assert n["v"] == 1 and not issubclass(TFaults.SimulatedCrash, Exception)
    with pytest.raises(ValueError, match="attempts"):
        retry_io(lambda: 0, attempts=0)


PLAN_ERRORS = [
    dict(degrade_edge=(1, 1)), dict(degrade_edge=(0, 1), degrade_factor=1),
    dict(slow_rank=0), dict(page_pool_clamp=0), dict(storm_step=2),
    dict(storm_requests=3), dict(storm_step=-1, storm_requests=2),
    dict(ckpt_crash_after_bytes=-1), dict(ckpt_io_errors=-2),
    dict(start_step=-1),
]


@pytest.mark.parametrize("kw", PLAN_ERRORS, ids=lambda kw: ",".join(kw))
def test_fault_plan_refuses_what_the_reference_refuses(kw):
    with pytest.raises(ValueError) as j:
        JFaults.FaultPlan(**kw)
    with pytest.raises(ValueError) as t:
        TFaults.FaultPlan(**kw)
    assert str(t.value) == str(j.value)


PLANS = [
    dict(), dict(degrade_edge=(0, 3), degrade_factor=4),
    dict(slow_rank=1, slow_ms=2.5, lost_host=2),
    dict(page_pool_clamp=3, storm_step=4, storm_requests=9),
    dict(ckpt_crash_after_bytes=512, ckpt_corrupt_seed=3, ckpt_io_errors=2,
         start_step=4),
]


@pytest.mark.parametrize("kw", PLANS, ids=lambda kw: ",".join(kw) or "noop")
def test_fault_plan_describes_as_the_reference(kw):
    assert TFaults.FaultPlan(**kw).describe() == \
        JFaults.FaultPlan(**kw).describe()
    # Every shape applies now; the lost host's heartbeats agree.
    for host in range(4):
        for step in range(6):
            assert TFaults.host_lost(TFaults.FaultPlan(**kw), host, step) \
                == JFaults.host_lost(JFaults.FaultPlan(**kw), host, step)


def test_storage_fault_state_is_per_plan_instance():
    plan = TFaults.FaultPlan(ckpt_crash_after_bytes=64, start_step=2)
    assert TFaults.ckpt_crash_budget(plan, 1) is None
    assert TFaults.ckpt_crash_budget(plan, 2) == 64
    TFaults.mark_ckpt_crash_fired(plan)
    assert TFaults.ckpt_crash_budget(plan, 4) is None
    twin = TFaults.FaultPlan(ckpt_crash_after_bytes=64, start_step=2)
    assert twin == plan and TFaults.ckpt_crash_budget(twin, 2) == 64
    io_plan = TFaults.FaultPlan(ckpt_io_errors=2)
    assert [TFaults.take_ckpt_io_error(io_plan) for _ in range(4)] == \
        [True, True, False, False]
    assert TFaults.take_ckpt_io_error(None) is False
    rot = TFaults.FaultPlan(ckpt_corrupt_seed=0, start_step=6)
    assert [TFaults.ckpt_corrupt_due(rot, s) for s in (3, 6, 9)] == \
        [False, True, True]
    with TFaults.injecting(plan):
        assert TFaults.active_plan() is plan
        with pytest.raises(RuntimeError, match="already active"):
            with TFaults.injecting(twin):
                pass
    assert TFaults.active_plan() is None


def test_storage_faults_act_as_the_reference(tmp_path):
    # Transient IO errors ride the retry with the same count; the seeded
    # rot flips the same bit of the same generations; a plan that is not
    # injected changes nothing.
    out = {}
    for side, C, F in (("j", JC, JFaults), ("t", TC, TFaults)):
        td = str(tmp_path / side)
        F.FaultPlan(ckpt_io_errors=5, ckpt_crash_after_bytes=1)  # idle
        idle = C.save_generation(td + "_idle", _tiny(), 1)
        with F.injecting(F.FaultPlan(ckpt_io_errors=3)):
            io_stats = C.save_generation(td + "_io", _tiny(), 1)
        with F.injecting(F.FaultPlan(ckpt_corrupt_seed=7, start_step=4)):
            a = C.save_generation(td, _tiny(2), 2)
            b = C.save_generation(td, _tiny(4), 4)
        lc = C.load_latest(td)
        out[side] = (idle["write_retries"], io_stats["write_retries"],
                     a["corrupted"], b["corrupted"],
                     C.verify_generation(b["path"]), lc.name, lc.skipped,
                     _files(b["path"]))
    assert out["t"] == out["j"]
    assert out["t"][:6] == (0, 3, False, True,
                            "checksum mismatch in params.npz", "gen-000002")


@pytest.mark.parametrize("with_opt", [False, True], ids=["sgd", "adamw"])
def test_layout_helpers_read_the_references_generation(tmp_path, with_opt):
    # An SGD save writes no optimizer state and no schedule meta; an
    # optax save writes both, beside its params.
    jp, js, _, _ = _states("float32", with_opt)
    sched = {"optimizer": "adamw", "decay_steps": 4} if with_opt else None
    JC.save_generation(str(tmp_path), jp, 2, opt_state=js, sched_meta=sched)
    gen = os.path.join(str(tmp_path), "gen-000002")
    assert TC.has_opt_state(gen) == with_opt
    assert TC.read_sched_meta(gen) == sched


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_loaded_leaves_are_writable_tensors_of_the_saved_bits(tmp_path,
                                                             dtype):
    import ml_dtypes

    rng = np.random.default_rng(2)
    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
    params = {"a": (rng.standard_normal((3, 5)) * 9).astype(np_dtype),
              "f": np.asfortranarray(rng.standard_normal((4, 6)) * 9
                                     ).astype(np_dtype, order="F"),
              "empty": np.zeros((0, 3), np_dtype)}
    JC.save_params(str(tmp_path), params, step=3)
    got, step = TC.load_params(str(tmp_path))
    assert step == 3 and list(got) == list(params)
    bits = np.int16 if dtype == "bfloat16" else np_dtype
    for k, want in params.items():
        t = got[k]
        assert t.dtype == getattr(torch, dtype) and t.device.type == "cpu"
        assert tuple(t.shape) == want.shape, k
        view = t.view(torch.int16) if dtype == "bfloat16" else t
        assert np.array_equal(view.numpy(), want.view(bits)), k
        t.add_(1)           # the loader's tensors are the caller's own
