"""The port's interleaved 1F1B (``tpu_p2p_torch/models/
pipeline_interleaved.py``) against the JAX reference, case for case with
``tests/test_pipeline_interleaved.py``: schedule soundness, bubble
reduction against plain 1F1B, and one SGD step of the legacy hand-rolled
executor (``make_interleaved_train_step_reference``) against the
reference's GPipe step at the reference's tolerance (1e-5), beside the
port's tick-IR path and its legacy GPipe fixture
(``make_pipeline_train_step_reference``), on a gloo world of 8
(``tests/torch_interleaved_world.py``, spawned once).
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from tpu_p2p.models import pipeline as JPL
from tpu_p2p.models import pipeline_1f1b as JFB
from tpu_p2p.models import pipeline_interleaved as JIL
from tpu_p2p_torch.models import pipeline as PL
from tpu_p2p_torch.models import pipeline_1f1b as FB
from tpu_p2p_torch.models import pipeline_interleaved as IL
from tpu_p2p_torch.parallel.launch import run_world

WORLD = os.path.join(os.path.dirname(__file__), "torch_interleaved_world.py")
TOL = dict(atol=1e-5, rtol=1e-5)
_TABLES = ("f_mb", "f_cidx", "f_slot", "b_mb", "b_cidx", "b_slot",
           "recv_slot", "b_gslot", "grecv_slot")
STEP_CASES = [(2, 2, 4), (2, 2, 8), (4, 2, 4), (2, 3, 4), (1, 4, 4),
              (8, 1, 8)]


def _setup(stages, m, b=8, t=4, d=8, f=16, seed=0):
    """The reference test's problem: (cfg, params, x, target), numpy."""
    cfg = JPL.PipelineConfig(d_model=d, d_ff=f, stages=stages,
                             microbatches=m)
    params = {k: np.asarray(v)
              for k, v in JPL.init_pipeline_params(cfg, seed=seed).items()}
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    tgt = rng.standard_normal((b, t, d)).astype(np.float32)
    return cfg, params, x, tgt


def _problem(stages, m):
    cfg, params, x, tgt = _setup(stages, m)
    return {"cfg": {"d_model": cfg.d_model, "d_ff": cfg.d_ff,
                    "stages": stages, "microbatches": m},
            "params": params, "batch": (x, tgt)}


# ---------------------------------------------------------------- schedule


@pytest.mark.parametrize("m,n,v", [(1, 1, 1), (4, 2, 2), (8, 2, 2),
                                   (8, 4, 2), (4, 2, 3), (6, 3, 2),
                                   (2, 4, 2), (8, 1, 4)])
def test_interleaved_schedule_sound(m, n, v):
    s = IL.build_interleaved_schedule(m, n, v)
    j = JIL.build_interleaved_schedule(m, n, v)
    assert (s.num_ticks, s.act_slots, s.grad_slots) == \
        (j.num_ticks, j.act_slots, j.grad_slots)
    for k in _TABLES:
        np.testing.assert_array_equal(getattr(s, k), getattr(j, k),
                                      err_msg=k)
    fwd = np.full((n * v, m), -1)
    bwd = np.full((n * v, m), -1)
    for t in range(s.num_ticks):
        for d in range(n):
            if (mb := s.f_mb[t, d]) >= 0:
                sv = d + s.f_cidx[t, d] * n
                assert fwd[sv, mb] == -1
                fwd[sv, mb] = t
            if (mb := s.b_mb[t, d]) >= 0:
                sv = d + s.b_cidx[t, d] * n
                assert bwd[sv, mb] == -1
                bwd[sv, mb] = t
    assert (fwd >= 0).all() and (bwd >= 0).all()
    for sv in range(n * v):
        for mb in range(m):
            if sv > 0:
                assert fwd[sv, mb] > fwd[sv - 1, mb]
            if sv < n * v - 1:
                assert bwd[sv, mb] > bwd[sv + 1, mb]
            assert bwd[sv, mb] > fwd[sv, mb]


@pytest.mark.parametrize("m,n,v", [(8, 2, 2), (8, 4, 2), (6, 3, 2)])
def test_interleaved_stash_replay_conflict_free(m, n, v):
    s = IL.build_interleaved_schedule(m, n, v)
    for d in range(n):
        owner = [None] * s.act_slots
        gown = [None] * s.grad_slots
        for t in range(s.num_ticks):
            if (rs := s.recv_slot[t, d]) >= 0:
                assert owner[rs] is None, f"act clobber @t{t} d{d}"
                owner[rs] = "pending"
            if (gs := s.grecv_slot[t, d]) >= 0:
                assert gown[gs] is None, f"grad clobber @t{t} d{d}"
                gown[gs] = "pending"
            if s.f_mb[t, d] >= 0 and d == 0 and s.f_cidx[t, d] == 0:
                assert owner[s.f_slot[t, d]] is None
                owner[s.f_slot[t, d]] = "pending"
            if s.b_mb[t, d] >= 0:
                bs = s.b_slot[t, d]
                assert owner[bs] == "pending", f"empty act read @t{t} d{d}"
                owner[bs] = None
                if d + s.b_cidx[t, d] * n < n * v - 1:
                    bg = s.b_gslot[t, d]
                    assert gown[bg] == "pending", f"empty grad read @t{t}"
                    gown[bg] = None


def test_interleaving_shrinks_the_bubble():
    m, n, v = 16, 4, 2
    ideal = 2 * m * v
    blocked = FB.build_1f1b_schedule(m, n).num_ticks * v
    inter = IL.build_interleaved_schedule(m, n, v).num_ticks
    assert blocked == JFB.build_1f1b_schedule(m, n).num_ticks * v
    assert inter - ideal < blocked - ideal
    assert inter == 70


# ---------------------------------------------------------------- numerics


@pytest.fixture(scope="module")
def world():
    cases = [{"name": f"n{n}v{v}m{m}", "n": n, "v": v,
              "problem": _problem(n * v, m)} for n, v, m in STEP_CASES]
    train = {"n": 2, "v": 2, "problem": _problem(4, 4)}
    return run_world(8, f"{WORLD}:legacy_case",
                     {"cases": cases, "train": train}, timeout=400)[0]


def _reference_gpipe(stages, m):
    cfg, params, x, tgt = _setup(stages, m)
    mesh = Mesh(np.array(jax.devices()[:stages]), ("pp",))
    placed = JPL.place_pipeline_params(
        {k: jnp.asarray(v) for k, v in params.items()}, mesh)
    want, loss = JPL.make_pipeline_train_step(mesh, cfg, lr=5e-2)(
        placed, jnp.asarray(x), jnp.asarray(tgt))
    return float(loss), {k: np.asarray(v) for k, v in want.items()}


@pytest.mark.parametrize("n,v,m", STEP_CASES)
def test_interleaved_step_matches_gpipe(world, n, v, m):
    got = world[f"n{n}v{v}m{m}"]
    l_gp, want = _reference_gpipe(n * v, m)
    for key in ("legacy", "ir"):
        loss, params = got[key]
        np.testing.assert_allclose(loss, l_gp, **TOL)
        for k in want:
            np.testing.assert_allclose(params[k], want[k], err_msg=k, **TOL)
    # The legacy executor and the tick IR run the same arithmetic.
    (l_a, p_a), (l_b, p_b) = got["legacy"], got["ir"]
    np.testing.assert_allclose(l_a, l_b, **TOL)
    for k in p_a:
        np.testing.assert_allclose(p_a[k], p_b[k], err_msg=k, **TOL)
    if got["gpipe"] is not None:  # the legacy GPipe fixture: stages | 8
        for key in ("gpipe", "gpipe_ir"):
            loss, params = got[key]
            np.testing.assert_allclose(loss, l_gp, **TOL)
            for k in want:
                np.testing.assert_allclose(params[k], want[k], err_msg=k,
                                           **TOL)


def test_interleaved_training_decreases_loss(world):
    losses = world["train_losses"]
    assert len(losses) == 5 and losses[-1] < losses[0], losses


def test_interleaved_rejects_bad_chunking():
    # The reference's messages, on meshes that only answer the checks.
    cfg = PL.PipelineConfig(d_model=8, d_ff=16, stages=4, microbatches=4)
    jcfg = JPL.PipelineConfig(d_model=8, d_ff=16, stages=4, microbatches=4)
    line = types.SimpleNamespace(size=2, index=0, in_process=False)
    pp2 = types.SimpleNamespace(axis_names=("pp",), line=lambda a: line)
    d2 = types.SimpleNamespace(axis_names=("d",), line=None)
    for make, jmake in ((IL.make_interleaved_train_step_reference,
                         JIL.make_interleaved_train_step_reference),
                        (IL.make_interleaved_train_step,
                         JIL.make_interleaved_train_step)):
        with pytest.raises(ValueError, match="chunks") as got:
            make(pp2, cfg, 3)
        with pytest.raises(ValueError) as want:
            jmake(Mesh(np.array(jax.devices()[:2]), ("pp",)), jcfg, 3)
        assert str(got.value) == str(want.value)
        with pytest.raises(ValueError, match="'pp' axis") as got:
            make(d2, cfg, 2)
        with pytest.raises(ValueError) as want:
            jmake(Mesh(np.array(jax.devices()[:2]), ("d",)), jcfg, 2)
        assert str(got.value) == str(want.value)


def test_device_major_roundtrip():
    a = np.arange(24).reshape(12, 2)
    dm = IL.to_device_major(a, 3, 4)
    np.testing.assert_array_equal(dm, JIL.to_device_major(a, 3, 4))
    np.testing.assert_array_equal(IL.from_device_major(dm, 3, 4), a)
    np.testing.assert_array_equal(dm[1 * 4 + 2], a[1 + 2 * 3])
