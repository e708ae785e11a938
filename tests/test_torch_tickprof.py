"""The port's tick flight recorder (``tpu_p2p_torch/obs/tickprof.py``)
against the JAX reference's ``tpu_p2p/obs/tickprof.py``, case for case
with ``tests/test_tickprof.py``.

- The reductions are host code: on the same synthetic stamps and
  durations, the port's rounds, spans, per-rank bubble, tick wall
  durations, kind map, effective hops, decomposition and agreement
  grades equal the reference's (and the hand-computed truth).
- The device-trace join does not copy the reference's cyclic ``i mod
  len`` match over a shared pool: each hop event carries the ledger
  label of its ship site, and lands on that site's shipping ticks in
  issue order, restarting each step; unlabelled hops join in issue
  order over the step's whole hop sequence when they make whole steps,
  and are left unattributed when they do not.
- On a CUDA tensor the recorder stamps with events resolved after the
  step's synchronization (a fake event stands in for the card here).
- The recorder end to end on a gloo world of 4 under both lowerings,
  and ``obs trace --cpu-mesh 8`` against ``tests/golden/
  cli_obs_trace_8dev.txt`` (the reference fails that golden on the
  installed jax, so the port is held to its text).
"""

import inspect
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from tpu_p2p.models import schedule as JS
from tpu_p2p.obs import tickprof as JTP
from tpu_p2p_torch.models import schedule as SCH
from tpu_p2p_torch.obs import tickprof as TP
from tpu_p2p_torch.parallel.launch import run_world

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORLD = os.path.join(HERE, "torch_tickprof_world.py")
GOLDEN = os.path.join(HERE, "golden", "cli_obs_trace_8dev.txt")


def _stamps_one_round(rank, times):
    out = [(rank, -1, 1, times[0] - 1.0)]
    for t in range(len(times) // 2):
        out.append((rank, t, 0, times[2 * t]))
        out.append((rank, t, 1, times[2 * t + 1]))
    return out


def _spans(mod, stamps, num_ticks):
    return [[(s.rank, s.tick, s.start, s.compute_end, s.end)
             for s in mod.spans_from_round(r, num_ticks)]
            for r in mod.rounds_from_stamps(stamps)]


# ------------------------------------------- synthetic-stamp algebra


def test_rounds_and_spans_match_hand_computed_truth():
    stamps = (_stamps_one_round(0, [10.2, 10.5, 11.0, 11.8])
              + _stamps_one_round(1, [101.0, 101.1, 101.3, 102.0]))
    rounds = TP.rounds_from_stamps(stamps)
    assert rounds == JTP.rounds_from_stamps(stamps)
    assert _spans(TP, stamps, 2) == _spans(JTP, stamps, 2)
    spans = TP.spans_from_round(rounds[0], num_ticks=2)
    by = {(s.rank, s.tick): s for s in spans}
    assert by[(0, 0)].busy_s == pytest.approx(1.0)
    assert by[(0, 1)].wait_s == pytest.approx(0.8)
    assert by[(1, 1)].wait_s == pytest.approx(0.7)
    meas = TP.measured_per_rank([spans])
    jspans = JTP.spans_from_round(rounds[0], num_ticks=2)
    assert meas == JTP.measured_per_rank([jspans])
    m0 = next(r for r in meas if r["device"] == 0)
    assert m0["bubble_frac"] == pytest.approx(1.1 / 2.6)


def test_rounds_segment_per_rank_and_merge_per_index():
    stamps = [(0, 5, 1, 0.5)]
    stamps += _stamps_one_round(0, [1.0, 1.1])
    stamps += _stamps_one_round(1, [1.0, 1.2])
    stamps += _stamps_one_round(0, [2.0, 2.1])
    rounds = TP.rounds_from_stamps(stamps)
    assert rounds == JTP.rounds_from_stamps(stamps)
    assert len(rounds) == 1 and (0, 5, 1) not in rounds[0]
    assert rounds[0][(1, 0, 1)] == 1.2


def test_spans_skip_ticks_missing_a_boundary():
    rm = {(0, -1, 1): 0.0, (0, 0, 1): 1.0}
    assert TP.spans_from_round(rm, num_ticks=1) == []
    assert JTP.spans_from_round(rm, num_ticks=1) == []


def test_tick_wall_durations_take_max_over_ranks():
    rm = {(0, -1, 1): 0.0, (1, -1, 1): 0.1,
          (0, 0, 0): 1.0, (0, 0, 1): 1.5,
          (1, 0, 0): 1.8, (1, 0, 1): 2.0}
    dur = TP.tick_wall_durations([rm], num_ticks=2)
    np.testing.assert_array_equal(
        dur, JTP.tick_wall_durations([rm], num_ticks=2))
    assert dur[0] == pytest.approx(1.9) and np.isnan(dur[1])


# ------------------------------------------------ kind decomposition


def _synth_program(mod):
    def op(kind):
        return (mod.TickOp(kind=kind, device=0, chunk=0, microbatch=0),)

    act = mod.TickHop(payload="activation", edges=())
    grad = mod.TickHop(payload="gradient", edges=())
    ticks = (
        mod.Tick(compute=op("fwd"), hops=()),
        mod.Tick(compute=op("fwd"), hops=(act,)),
        mod.Tick(compute=op("bwd"), hops=()),
        mod.Tick(compute=op("bwd"), hops=(grad, grad)),
        mod.Tick(compute=op("bwd_weight"), hops=(act,)),
    )
    return mod.TickProgram(name="synth", devices=1, chunks=1,
                           microbatches=1, ticks=ticks)


def test_effective_hops_mirrors_executor_elision():
    prog = _synth_program(SCH)
    got = [TP.effective_hops(t) for t in prog.ticks]
    assert got == [JTP.effective_hops(t)
                   for t in _synth_program(JS).ticks] == [0, 1, 0, 2, 0]
    mystery = SCH.Tick(
        compute=(SCH.TickOp(kind="bwd_weight", device=0, chunk=0,
                            microbatch=0),),
        hops=(SCH.TickHop(payload="halo", edges=()),))
    assert TP.effective_hops(mystery) == 1
    # On compiled programs the count is what lower()'s ship tables ship.
    for prog in (SCH.compile_zb(4, 4), SCH.compile_1f1b(3, 2)):
        tb = SCH.lower(prog).tables
        assert [TP.effective_hops(t) for t in prog.ticks] == \
            [int(a) + int(b) for a, b in zip(tb["ship_y"], tb["ship_g"])]


def _planted(mod, prog, a, b, c, raw=False):
    dur = np.zeros(prog.num_ticks)
    for t, tick in enumerate(prog.ticks):
        cost = max((mod.OP_COST[op.kind] for op in tick.compute),
                   default=0.0)
        hops = len(tick.hops) if raw else TP.effective_hops(tick)
        dur[t] = (a + b * cost + c * hops) / 1e3
    return dur


def _decomp_equal(dur, prog, jprog):
    got = TP.kind_decomposition(dur, prog)
    want = JTP.kind_decomposition(dur, jprog)
    assert got == want
    return got


def test_kind_decomposition_recovers_planted_cost_model():
    prog = _synth_program(SCH)
    d = _decomp_equal(_planted(SCH, prog, 1.0, 2.0, 0.5), prog,
                      _synth_program(JS))
    assert d["intercept_from_fit"] and d["hop_design_varies"]
    assert d["constant_overhead_ms"] == pytest.approx(1.0, abs=1e-6)
    assert d["ms_per_cost_unit"] == pytest.approx(2.0, abs=1e-6)
    assert d["ms_per_hop"] == pytest.approx(0.5, abs=1e-6)


def test_kind_decomposition_full_rank_on_real_zb():
    prog = SCH.compile_zb(4, 8)
    assert len({TP.effective_hops(t) for t in prog.ticks}) >= 3
    d = _decomp_equal(_planted(SCH, prog, 1.5, 3.0, 0.25), prog,
                      JS.compile_zb(4, 8))
    assert d["constant_overhead_ms"] == pytest.approx(1.5, abs=1e-6)
    assert d["ms_per_cost_unit"] == pytest.approx(3.0, abs=1e-6)
    assert d["ms_per_hop"] == pytest.approx(0.25, abs=1e-6)


def test_kind_decomposition_group_means_exact_on_zb():
    prog = SCH.compile_zb(4, 4)
    d = _decomp_equal(_planted(SCH, prog, 1.0, 2.0, 0.5, raw=True), prog,
                      JS.compile_zb(4, 4))
    kinds = d["per_kind_ms"]
    assert kinds["fwd"]["mean_ms"] == pytest.approx(4.0)
    assert kinds["bwd_weight"]["mean_ms"] == pytest.approx(3.0)
    assert d["ms_per_hop"] == pytest.approx(0.0, abs=1e-6)


def test_kind_decomposition_falls_back_to_min_tick_floor():
    prog = SCH.compile_gpipe(2, 2)
    d = _decomp_equal(np.full(prog.num_ticks, 3.0e-3), prog,
                      JS.compile_gpipe(2, 2))
    assert d["constant_overhead_ms"] > 0
    if not d["intercept_from_fit"]:
        assert d["constant_overhead_ms"] == pytest.approx(3.0)
    assert TP.tick_kind_map(prog) == JTP.tick_kind_map(
        JS.compile_gpipe(2, 2))


# ------------------------------------------------- device-trace join


def _label(site, kind="dma"):
    return f"tp_p2p_issue|{kind}|pp|{site}|0>1,1>0|512"


def test_join_device_trace_cyclic_onto_shipping_ticks():
    # 1f1b at M=2 S=2: each ship site's events land on its own shipping
    # ticks in issue order (lower()'s ship_y / ship_g), a second step's
    # events on the same ticks again; an unlabelled hop and a non-hop
    # event stay unattributed.
    prog = SCH.compile_1f1b(2, 2)
    tb = SCH.lower(prog).tables
    slots = TP.ship_slots(prog)
    assert slots["pp_fwd_ship"] == [t for t in range(prog.num_ticks)
                                    if tb["ship_y"][t]]
    assert slots["pp_bwd_ship"] == [t for t in range(prog.num_ticks)
                                    if tb["ship_g"][t]]
    ivs, want, t0 = [], [], 10.0
    for _step in range(2):
        for site in ("pp_fwd_ship", "pp_bwd_ship"):
            for tick in slots[site]:
                name = "dma_permute_kernel"
                ivs.append((name, t0, t0 + 0.5, _label(site)))
                want.append((tick, site))
                t0 += 1.0
    ivs.append(("ncclDevKernel_SendRecv(x)", 50.0, 50.5, None))
    ivs.append(("ampere_sgemm_128x64_nn", 0.0, 1.0, None))
    joined, other = TP.join_device_trace(prog, ivs)
    got = sorted(((j["t0"], j["tick"], j["site"]) for j in joined))
    assert [(tick, site) for _, tick, site in got] == [
        w for _, w in sorted(zip([iv[1] for iv in ivs[:len(want)]],
                                 want))]
    assert all(j["kind"] == "dma" for j in joined)
    assert sorted(other) == [("ampere_sgemm_128x64_nn", 0.0, 1.0),
                             ("ncclDevKernel_SendRecv(x)", 50.0, 50.5)]
    assert all(j["how"] == "label" for j in joined)
    # Without labels (launches that carry no issue marker) the hops join
    # in issue order over the step's whole hop sequence — tick by tick,
    # the activation hop before the gradient hop — when they make whole
    # steps, and stay unattributed when they do not.
    seq = TP.ship_sequence(prog)
    assert seq == sorted(
        [(t, "pp_fwd_ship") for t in slots["pp_fwd_ship"]]
        + [(t, "pp_bwd_ship") for t in slots["pp_bwd_ship"]],
        key=lambda e: (e[0], e[1] == "pp_bwd_ship"))
    bare = [("ncclDevKernel_SendRecv(x)", 100.0 + i, 100.5 + i)
            for i in range(2 * len(seq))]
    joined, other = TP.join_device_trace(prog, bare)
    assert [(j["tick"], j["site"]) for j in joined] == seq * 2
    assert all(j["how"] == "order" and j["kind"] == "ppermute"
               for j in joined) and other == []
    joined, other = TP.join_device_trace(prog, bare[:-1])
    assert joined == [] and len(other) == 2 * len(seq) - 1
    # GPipe: the stage hop ships on every tick but the last.
    g = SCH.compile_gpipe(3, 2)
    assert TP.ship_slots(g) == {"pp_stage_ship":
                                list(range(g.num_ticks - 1))}
    assert TP.ship_slots(SCH.compile_1f1b(2, 1)) == {}


def test_join_device_trace_empty_and_none():
    prog = SCH.compile_1f1b(2, 2)
    assert TP.join_device_trace(prog, []) == ([], [])
    assert TP.join_device_trace(prog, None) == ([], [])
    assert JTP.join_device_trace(JS.compile_1f1b(2, 2), None) == ([], [])


# ------------------------------------------------- agreement grading


def test_ordering_agreement_grades_only_separable_pairs():
    analytic = [{"device": 0, "bubble_frac": 0.1},
                {"device": 1, "bubble_frac": 0.5},
                {"device": 2, "bubble_frac": 0.52}]
    measured = [{"device": 0, "bubble_frac": 0.7},
                {"device": 1, "bubble_frac": 0.9},
                {"device": 2, "bubble_frac": 0.1}]
    o = TP.ordering_agreement(analytic, measured, eps=0.05)
    assert o == JTP.ordering_agreement(analytic, measured, eps=0.05)
    assert o["checked"] == 2 and o["agree"] == 1
    assert o["ok"] is False and o["disagreements"] == [(0, 2)]


def _uniform_spans(mod, busy_by_tick, rank=0):
    t0, spans = 0.0, []
    for t, b in enumerate(busy_by_tick):
        spans.append(mod.TickSpan(rank=rank, tick=t, start=t0,
                                  compute_end=t0 + b, end=t0 + b + 0.1))
        t0 += b + 0.1
    return spans


def _idle(analytic, rows):
    """Both recorders' idle grade on the same spans → the port's."""
    got = TP.idle_tick_agreement(
        analytic, [[s for r, busy in rs for s in
                    _uniform_spans(TP, busy, r)] for rs in rows])
    want = JTP.idle_tick_agreement(
        analytic, [[s for r, busy in rs for s in
                    _uniform_spans(JTP, busy, r)] for rs in rows])
    assert got == want
    return got


def test_idle_tick_agreement_grades_when_signal_clears_floor():
    io = _idle([{"device": 0, "idle_spans": [(0, 2)]}],
               [[(0, [1e-3, 1e-3, 5e-3, 5e-3])]])
    assert io["ranks_checked"] == 1 and io["ok"] is True
    assert io["detail"][0]["idle_tick_ms"] == pytest.approx(1.0)


def test_idle_tick_agreement_ungraded_beneath_timer_floor():
    io = _idle([{"device": 0, "idle_spans": [(0, 2)]}],
               [[(0, [1.0e-3, 1.0e-3, 1.5e-3, 1.5e-3])]])
    assert io["ranks_checked"] == 0 and io["ungraded"] == [0]
    assert io["ok"] is True and "floor" in io["ungraded_reason"]


def test_idle_tick_agreement_min_over_rounds_filters_noise():
    io = _idle([{"device": 0, "idle_spans": [(0, 2)]}],
               [[(0, [1e-3, 1e-3, 5e-3, 5e-3])],
                [(0, [9e-3, 9e-3, 10e-3, 10e-3])]])
    assert io["ok"] is True
    assert io["detail"][0]["idle_tick_ms"] == pytest.approx(1.0)


def test_idle_tick_agreement_two_thirds_quorum():
    analytic = [{"device": r, "idle_spans": [(0, 2)]} for r in range(4)]
    good = [1e-3, 1e-3, 5e-3, 5e-3]
    io = _idle(analytic, [[(0, good), (1, good), (2, good),
                           (3, [8e-3, 8e-3, 5e-3, 5e-3])]])
    assert io["failures"] == [3] and io["ok"] is True
    io = _idle(analytic, [[(r, [5e-3, 5e-3, 5e-3, 1e-3])
                           for r in range(4)]])
    assert len(io["failures"]) == 4 and io["ok"] is False


# -------------------------------------- the recorder on a real world


@pytest.fixture(scope="module")
def world():
    runs = {low: dict(schedule="zb", microbatches=3, steps=2,
                      tick_lowering=low, device_trace=low == "masked")
            for low in ("switch", "masked")}
    return run_world(4, f"{WORLD}:recorder_case", {"runs": runs},
                     timeout=400)[0]


@pytest.mark.parametrize("lowering", ["switch", "masked"])
def test_flight_recorder_measured_vs_analytic(world, lowering):
    rep = world[lowering]
    assert rep["devices"] == 4 and rep["steps_measured"] == 2
    assert rep["stamp_clock"] == "host" and rep["transport"] == "xla"
    assert len(rep["measured"]) == 4
    for r in rep["measured"]:
        assert 0.0 <= r["bubble_frac"] <= 1.0 and r["busy_s"] > 0
    assert rep["ordering"]["ok"] is True
    assert len(rep["spans"]) == 4 * rep["num_ticks"]
    assert rep["num_ticks"] == JS.compile_zb(3, 4).num_ticks
    assert rep["analytic"] == JS.per_rank_idle(JS.compile_zb(3, 4))
    c0 = rep["decomposition"]["constant_overhead_ms"]
    assert c0 is not None and c0 > 0
    io = rep["idle_ordering"]
    assert set(io["failures"]) | set(io["ungraded"]) <= {0, 1, 2, 3}
    kinds = {s["kind"] for s in rep["spans"]}
    assert kinds <= {"fwd", "bwd_input", "bwd_weight", "idle"}
    dj = rep["device_join"]
    assert dj["device_track"] is False and dj["joined"] == []
    assert dj["reason"] == ("device trace not sampled"
                            if lowering == "switch" else
                            "no device track in trace (platform records "
                            "host events only)")


def test_recorder_off_is_default_and_hook_threads():
    for fn in (SCH.make_tick_train_step, SCH.tick_grads_local,
               SCH.tick_forward_local):
        assert inspect.signature(fn).parameters[
            "tick_times"].default is None


def test_recorder_resolves_card_events_after_the_step():
    # The card path: events recorded at each stamp, turned into seconds
    # only once the stream synchronized — each at its step's seed read
    # plus its elapsed time after the seed event.
    class _Event:
        def __init__(self, ms):
            self.ms = ms

        def elapsed_time(self, other):
            return other.ms - self.ms

    rec = TP.TickRecorder()
    rec._pending = [(0, 3, 1, _Event(0.0), None),  # before a seed: no anchor
                    (0, -1, 1, _Event(5.0), 100.0),
                    (0, 0, 0, _Event(7.0), None),
                    (0, 0, 1, _Event(9.5), None),
                    (0, -1, 1, _Event(50.0), 200.0),
                    (0, 0, 0, _Event(51.0), None)]
    assert len(rec) == 6
    rec.resolve()
    assert rec.stamps == [(0, -1, 1, 100.0), (0, 0, 0, 100.002),
                          (0, 0, 1, 100.0045), (0, -1, 1, 200.0),
                          (0, 0, 0, 200.001)]
    assert rec._pending == []
    rec.clear()
    assert len(rec) == 0 and rec.clock == "host"


def _collapse(text: str) -> str:
    # The golden's busy/hop-wait columns keep the reference's padding for
    # values of its own magnitude (>= 100 ms busy on its CPU mesh); the
    # port's gloo ranks run the same ticks in less, so each masked
    # field's leading padding is collapsed on both sides.
    return re.sub(r" +####", " ####", text)


def test_obs_trace_cli_matches_golden():
    from test_cli_golden import _mask_trace, mask_floats

    proc = subprocess.run(
        [sys.executable, "-m", "tpu_p2p_torch", "obs", "trace",
         "--cpu-mesh", "8"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(GOLDEN) as fh:
        want = fh.read()
    got = _mask_trace(mask_floats(proc.stdout))
    assert _collapse(got) == _collapse(want)
    assert "# trace smoke: PASS" in proc.stdout
