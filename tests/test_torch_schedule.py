"""The port's tick-schedule IR (``tpu_p2p_torch/models/schedule.py``)
against the reference's ``tpu_p2p/models/schedule.py``.

- The host half is pure Python, so it must be equal: every compiled
  program, ``lower()``'s tables under both lowerings, the analytic
  accounting (``bubble_fraction``, ``per_rank_idle``, ``price_program``)
  over the grid of ``tests/test_schedule.py``; the greedy builders'
  tables; the device-major layouts byte for byte; the seeded pipeline
  weights.
- The executor runs on gloo worlds of pp 2 (laid as dp 2 × pp 2) and pp
  4, one world for the file (``tests/torch_schedule_world.py``): GPipe,
  1F1B and interleaved under the masked lowering within the reference's
  own 1e-5 of the reference's steps; and, port against port, bitwise:
  zb against fused 1F1B, switch against masked, the wave and the
  peer-push transport against the one-shot library hop.
- The ZB split's store (``zb_split.py``): each covered product's
  deferred dW bitwise its inline dW; the executor's validation messages
  equal the reference's.
"""

import os
import types

import numpy as np
import pytest
import torch

from conftest import parity_mesh, pipeline_setup
from tpu_p2p.models import pipeline as JPL
from tpu_p2p.models import pipeline_1f1b as JFB
from tpu_p2p.models import pipeline_interleaved as JIL
from tpu_p2p.models import schedule as JS
from tpu_p2p_torch.models import pipeline as TPL
from tpu_p2p_torch.models import pipeline_1f1b as TFB
from tpu_p2p_torch.models import pipeline_interleaved as TIL
from tpu_p2p_torch.models import schedule as TS
from tpu_p2p_torch.models import zb_split as ZB
from tpu_p2p_torch.parallel.launch import run_world

WORLD = os.path.join(os.path.dirname(__file__), "torch_schedule_world.py")
TOL = dict(atol=1e-5, rtol=1e-5)   # the reference's own (test_pipeline_1f1b)

# ------------------------------------------------------------ host half

GRID = [(1, 1), (2, 2), (4, 4), (8, 4), (4, 8), (3, 5), (4, 1), (1, 4),
        (16, 4)]
CHUNKED = [(4, 2, 2), (8, 4, 2), (16, 4, 2), (3, 2, 3), (4, 1, 2)]


def _programs(mod, m, s):
    progs = {"gpipe": mod.compile_gpipe(m, s), "1f1b": mod.compile_1f1b(m, s),
             "zb": mod.compile_zb(m, s)}
    return progs


def _as_tuples(prog):
    return (prog.name, prog.devices, prog.chunks, prog.microbatches,
            tuple((tuple((op.kind, op.device, op.chunk, op.microbatch)
                         for op in t.compute),
                   tuple((h.payload, h.edges) for h in t.hops))
                  for t in prog.ticks))


def _lowered_equal(a, b):
    assert (a.forward_only, a.split, a.act_slots, a.grad_slots,
            a.bnd_slots, a.fwd_edges, a.bwd_edges, a.lowering,
            a.op_table) == (b.forward_only, b.split, b.act_slots,
                            b.grad_slots, b.bnd_slots, b.fwd_edges,
                            b.bwd_edges, b.lowering, b.op_table)
    assert sorted(a.tables) == sorted(b.tables)
    for k in a.tables:
        assert a.tables[k].dtype == b.tables[k].dtype, k
        np.testing.assert_array_equal(a.tables[k], b.tables[k], err_msg=k)


@pytest.mark.parametrize("m,s", GRID)
def test_programs_and_lowerings_equal_the_reference(m, s):
    port, ref = _programs(TS, m, s), _programs(JS, m, s)
    for kind in port:
        assert _as_tuples(port[kind]) == _as_tuples(ref[kind]), kind
        for lowering in ("masked", "switch"):
            _lowered_equal(TS.lower(port[kind], lowering),
                           JS.lower(ref[kind], lowering))
        assert TS.bubble_fraction(port[kind]) == \
            JS.bubble_fraction(ref[kind])
        assert TS.per_rank_idle(port[kind]) == JS.per_rank_idle(ref[kind])
        assert TS.price_program(port[kind], payload_bytes=1024) == \
            JS.price_program(ref[kind], payload_bytes=1024)


@pytest.mark.parametrize("m,n,v", CHUNKED)
def test_interleaved_programs_and_builders_equal_the_reference(m, n, v):
    port, ref = TS.compile_interleaved(m, n, v), JS.compile_interleaved(m, n,
                                                                        v)
    assert _as_tuples(port) == _as_tuples(ref)
    _lowered_equal(TS.lower(port), JS.lower(ref))
    _lowered_equal(TS.lower(port, "switch"), JS.lower(ref, "switch"))
    assert TS.price_program(port, 4096) == JS.price_program(ref, 4096)
    a, b = TIL.build_interleaved_schedule(m, n, v), \
        JIL.build_interleaved_schedule(m, n, v)
    for k in ("num_ticks", "devices", "chunks", "microbatches", "act_slots",
              "grad_slots"):
        assert getattr(a, k) == getattr(b, k), k
    for k, t in TIL._sched_tables(a).items():
        np.testing.assert_array_equal(t, np.asarray(getattr(b, k)),
                                      err_msg=k)


@pytest.mark.parametrize("m,s", [(1, 1), (4, 4), (8, 4), (3, 5), (2, 7)])
def test_1f1b_builder_equals_the_reference(m, s):
    a, b = TFB.build_1f1b_schedule(m, s), JFB.build_1f1b_schedule(m, s)
    for k in a.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                      err_msg=k)
    iv = [(0, 3, "a"), (1, 2, "b"), (3, 5, "c"), (4, 4, "d")]
    assert TFB._color_intervals(iv) == JFB._color_intervals(iv)


def test_lower_refuses_as_the_reference():
    for mod in (TS, JS):
        with pytest.raises(ValueError) as e:
            mod.lower(mod.compile_1f1b(2, 2), tick_lowering="select")
        if mod is TS:
            port = str(e.value)
    assert port == str(e.value)
    bad = JS.TickProgram("bad", 1, 1, 1, (JS.Tick((JS.TickOp("fwd", 0, 0, 0),
                                                    JS.TickOp("bwd", 0, 0, 0))),))
    tbad = TS.TickProgram("bad", 1, 1, 1, (TS.Tick((TS.TickOp("fwd", 0, 0, 0),
                                                     TS.TickOp("bwd", 0, 0, 0))),))
    with pytest.raises(ValueError) as want:
        JS.lower(bad, "switch")
    with pytest.raises(ValueError) as got:
        TS.lower(tbad, "switch")
    assert str(got.value) == str(want.value)


def test_device_major_layouts_and_weights_equal_the_reference():
    rng = np.random.default_rng(3)
    for n, v, rows in [(2, 2, 1), (4, 2, 3), (3, 3, 2), (1, 4, 1)]:
        a = rng.standard_normal((n * v * rows, 3, 5)).astype(np.float32)
        dm = TIL.to_device_major(a, n, v, rows)
        assert dm.tobytes() == JIL.to_device_major(a, n, v, rows).tobytes()
        back = TIL.from_device_major(dm, n, v, rows)
        assert back.tobytes() == a.tobytes()
        assert TIL.device_major_perm(n, v, rows) == \
            JIL.device_major_perm(n, v, rows)
    cfg, jparams, jx, _ = pipeline_setup(stages=4, m=4)
    tparams = TPL.init_pipeline_params(TPL.PipelineConfig(
        d_model=16, d_ff=32, stages=4, microbatches=4))
    for k in jparams:
        assert tparams[k].numpy().tobytes() == \
            np.asarray(jparams[k]).tobytes(), k


# ------------------------------------------------------------- executor

MESHES = {"pp2": ((2, 2), ("dp", "pp")), "pp4": ((4,), ("pp",))}
SIZES = {"pp2": 2, "pp4": 4}


def _cases():
    out = []
    for mesh, n in SIZES.items():
        for prog in ("gpipe", "1f1b", "zb"):
            for low in ("masked", "switch"):
                out.append(dict(name=f"{mesh}-{prog}-{low}", mesh=mesh,
                                program=prog, stages=n, m=4, lowering=low))
        for low in ("masked", "switch"):
            out.append(dict(name=f"{mesh}-interleaved-{low}", mesh=mesh,
                            program="interleaved", chunks=2, stages=2 * n,
                            m=4, lowering=low))
        for prog in ("gpipe", "1f1b"):
            out.append(dict(name=f"{mesh}-{prog}-wave", mesh=mesh,
                            program=prog, stages=n, m=4, pp_overlap="wave",
                            pp_chunks=2))
        out.append(dict(name=f"{mesh}-zb-wave-switch", mesh=mesh,
                        program="zb", stages=n, m=4, lowering="switch",
                        pp_overlap="wave", pp_chunks=2))
        out.append(dict(name=f"{mesh}-zb-dma", mesh=mesh, program="zb",
                        stages=n, m=4, lowering="switch",
                        transport="pallas_dma"))
    return out


@pytest.fixture(scope="module")
def world():
    """Every executor case of this file on one gloo world of 4 ranks."""
    return run_world(4, f"{WORLD}:schedule_case",
                     {"meshes": MESHES, "cases": _cases()})[0]


def _reference(prog, n):
    """The reference's step of ``prog`` on a pure-pp mesh of ``n`` → (loss,
    stage-major params)."""
    stages = 2 * n if prog == "interleaved" else n
    cfg, params, x, target = pipeline_setup(stages=stages, m=4)
    mesh = parity_mesh(("pp",), (n,))
    if prog == "interleaved":
        placed = JIL.place_interleaved_params(params, mesh, 2)
        new, loss = JIL.make_interleaved_train_step(mesh, cfg, 2, lr=5e-2)(
            placed, x, target)
        return float(loss), JIL.unplace_interleaved_params(new, mesh, 2)
    placed = JPL.place_pipeline_params(params, mesh)
    make = {"gpipe": JPL.make_pipeline_train_step,
            "1f1b": JFB.make_pipeline_train_step_1f1b}[prog]
    new, loss = make(mesh, cfg, lr=5e-2)(placed, x, target)
    return float(loss), {k: np.asarray(v) for k, v in new.items()}


def _bitwise(a, b):
    assert a["loss"] == b["loss"]
    for k in a["params"]:
        np.testing.assert_array_equal(a["params"][k], b["params"][k],
                                      err_msg=k)


@pytest.mark.parametrize("mesh", sorted(SIZES))
@pytest.mark.parametrize("prog", ["gpipe", "1f1b", "interleaved"])
def test_masked_steps_match_the_reference(world, mesh, prog):
    loss, params = _reference(prog, SIZES[mesh])
    got = world[f"{mesh}-{prog}-masked"]
    np.testing.assert_allclose(got["loss"], loss, **TOL)
    for k in params:
        np.testing.assert_allclose(got["params"][k], params[k], err_msg=k,
                                   **TOL)


@pytest.mark.parametrize("mesh", sorted(SIZES))
@pytest.mark.parametrize("lowering", ["masked", "switch"])
def test_zb_is_bitwise_the_fused_1f1b_step(world, mesh, lowering):
    _bitwise(world[f"{mesh}-zb-{lowering}"], world[f"{mesh}-1f1b-masked"])


@pytest.mark.parametrize("mesh", sorted(SIZES))
@pytest.mark.parametrize("prog", ["gpipe", "1f1b", "interleaved", "zb"])
def test_switch_is_bitwise_the_masked_lowering(world, mesh, prog):
    _bitwise(world[f"{mesh}-{prog}-switch"], world[f"{mesh}-{prog}-masked"])


@pytest.mark.parametrize("mesh", sorted(SIZES))
def test_wave_and_peer_push_ships_are_bitwise_the_one_shot_hop(world, mesh):
    for prog in ("gpipe", "1f1b"):
        _bitwise(world[f"{mesh}-{prog}-wave"], world[f"{mesh}-{prog}-masked"])
    _bitwise(world[f"{mesh}-zb-wave-switch"], world[f"{mesh}-zb-switch"])
    _bitwise(world[f"{mesh}-zb-dma"], world[f"{mesh}-zb-switch"])


def test_one_stage_programs_degrade_to_the_fused_step():
    # compile_zb on one device is the fused schedule (the reference's
    # test_zb_degrades_to_fused_on_one_stage), so the step is bitwise.
    mesh = types.SimpleNamespace(axis_names=("pp",),
                                 line=lambda a: _Line(1))
    cfg, params, x, target = _problem(1, 4)
    got = {}
    for name, prog in (("1f1b", TS.compile_1f1b(4, 1)),
                       ("zb", TS.compile_zb(4, 1)),
                       ("gpipe", TS.compile_gpipe(4, 1))):
        for low in ("masked", "switch"):
            got[name, low] = TS.make_tick_train_step(
                mesh, cfg, prog, lr=5e-2, tick_lowering=low)(params, x,
                                                             target)
    ref_p, ref_l = got["1f1b", "masked"]
    for key, (p, loss) in got.items():
        if key[0] == "gpipe":
            np.testing.assert_allclose(float(loss), float(ref_l), **TOL)
            continue
        assert float(loss) == float(ref_l), key
        for k in p:
            assert torch.equal(p[k], ref_p[k]), (key, k)


class _Line:
    """A pp line of one rank (no group: nothing crosses it)."""

    def __init__(self, size):
        self.size, self.index, self.in_process = size, 0, False


def _problem(stages, m):
    cfg = TPL.PipelineConfig(d_model=16, d_ff=32, stages=stages,
                             microbatches=m)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((8, 8, 16))).float()
    t = torch.from_numpy(rng.standard_normal((8, 8, 16))).float()
    return cfg, TPL.init_pipeline_params(cfg), x, t


# ----------------------------------------------------- the split store

_PRODUCTS = {
    # name → (kind, input shape, weight shape, widen)
    "dense": ("matmul", (2, 5, 6), (6, 4), True),
    "experts": ("matmul", (3, 7, 6), (3, 6, 4), True),
    "proj": ("proj", (2, 5, 6), (3, 6, 4), False),
    "out": ("out", (2, 3, 5, 4), (3, 4, 6), False),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(_PRODUCTS))
def test_split_store_dw_is_bitwise_the_inline_dw(name, dtype):
    kind, a_shape, w_shape, widen = _PRODUCTS[name]
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(a_shape, generator=gen).to(dtype)
    w = torch.randn(w_shape, generator=gen).to(dtype)
    if widen:
        a = a.float()
    got = {}
    for mode in ("fused", "split"):
        store = ZB.WeightGradStore()
        aa = a.clone().requires_grad_(True)
        with ZB.scope(store):
            y = ZB.stored_product(kind, aa, w, "w", widen=widen)
            g = torch.ones_like(y) + torch.arange(y.numel()).reshape(
                y.shape).to(y.dtype) / y.numel()
            (da,) = torch.autograd.grad(y, [aa], grad_outputs=g)
        recs = store.take()
        assert len(recs) == 1
        if mode == "split":  # deferred: other work runs before the replay
            torch.matmul(torch.randn(64, 64), torch.randn(64, 64))
        got[mode] = (da, ZB.leaf_grads(recs, {"w": dtype})[("w", 0)])
    assert torch.equal(got["fused"][0], got["split"][0])
    assert torch.equal(got["fused"][1], got["split"][1])
    # ... and the product and its gradients are autograd's, the plain op
    # the port runs without a store.
    aa, ww = a.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y = ZB.stored_product(kind, aa, ww, "w", widen=widen)
    da, dw = torch.autograd.grad(y, [aa, ww], grad_outputs=g)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else \
        dict(atol=5e-2, rtol=2e-2)
    torch.testing.assert_close(got["fused"][0], da, **tol)
    torch.testing.assert_close(got["fused"][1], dw, **tol)


def test_split_store_records_each_covered_leaf_of_a_flagship_block():
    # Every weight product of a dense and a MoE block lands in the store
    # (the norm gains and the router stay with autograd), and the
    # deferred replay is bitwise the inline one, leaf by leaf.
    from tpu_p2p_torch.models import flagship as F

    for dense in (True, False):
        cfg = F.FlagshipConfig(batch=2, seq=8, heads=2, head_dim=4,
                               stages=2, microbatches=1, num_experts=2,
                               dense_ffn=dense, norm=True, rope=True)
        params = F.init_flagship_params(cfg, device="cpu")
        x = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (2, 8, cfg.model_dim))).float()
        got = {}
        for mode in ("fused", "split"):
            store = ZB.WeightGradStore()
            leaves = {k: v.clone().requires_grad_(True)
                      for k, v in params.items()}
            xs = x.clone().requires_grad_(True)
            with ZB.scope(store):
                y = F._stage_block(leaves, xs, cfg, 2)
                grads = torch.autograd.grad(
                    y, [xs, *leaves.values()], grad_outputs=torch.ones_like(y),
                    allow_unused=True)
            auto = {k for k, g in zip(leaves, grads[1:]) if g is not None}
            got[mode] = (grads, ZB.leaf_grads(
                store.take(), {k: v.dtype for k, v in params.items()}))
        covered = {k for k, _ in got["fused"][1]}
        want = {"wq", "wk", "wv", "wo"} | (
            {"wf1", "wf2"} if dense else {"we1", "we2"})
        assert covered == want
        assert auto == {"ln1", "ln2"} | (set() if dense else {"router"})
        assert sorted(got["fused"][1]) == sorted(got["split"][1])
        for key in got["fused"][1]:
            assert torch.equal(got["fused"][1][key], got["split"][1][key])
        for a, b in zip(got["fused"][0], got["split"][0]):
            assert (a is None and b is None) or torch.equal(a, b)


# ----------------------------------------------------------- validation


def _ref_error(fn):
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value), str(e.value)


def test_executor_validates_as_the_reference():
    jcfg, *_ = pipeline_setup(stages=4, m=4)
    tcfg = TPL.PipelineConfig(d_model=16, d_ff=32, stages=4, microbatches=4)
    pp4 = types.SimpleNamespace(axis_names=("pp",), line=lambda a: _Line(4))
    cases = [  # (reference mesh, port mesh, program, cfg changes)
        (parity_mesh(("dp",), (4,)),
         types.SimpleNamespace(axis_names=("dp",), line=None),
         "1f1b4", {}),
        (parity_mesh(("pp",), (2,)), types.SimpleNamespace(
            axis_names=("pp",), line=lambda a: _Line(2)), "1f1b4", {}),
        (parity_mesh(("pp",), (4,)), pp4, "il4", {}),
        (parity_mesh(("pp",), (4,)), pp4, "1f1b4",
         {"microbatches": 2}),
    ]
    for jmesh, tmesh, prog, change in cases:
        jc = jcfg.__class__(**{**jcfg.__dict__, **change})
        tc = TPL.PipelineConfig(**{**tcfg.__dict__, **change})
        jp = {"1f1b4": JS.compile_1f1b(4, 4),
              "il4": JS.compile_interleaved(4, 4, 2)}[prog]
        tp = {"1f1b4": TS.compile_1f1b(4, 4),
              "il4": TS.compile_interleaved(4, 4, 2)}[prog]
        want = _ref_error(lambda: JS.make_tick_train_step(jmesh, jc, jp))
        got = _ref_error(lambda: TS.make_tick_train_step(tmesh, tc, tp))
        assert got == want
    want = _ref_error(lambda: JS.make_tick_train_step(
        parity_mesh(("pp",), (4,)), jcfg, JS.compile_1f1b(4, 4),
        tick_lowering="Switch"))
    got = _ref_error(lambda: TS.make_tick_train_step(
        pp4, tcfg, TS.compile_1f1b(4, 4), tick_lowering="Switch"))
    assert got == want
    with pytest.raises(NotImplementedError, match="obs/tickprof.py"):
        TS.make_tick_train_step(pp4, tcfg, TS.compile_1f1b(4, 4),
                                tick_times=object())
