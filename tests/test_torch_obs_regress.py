"""The port's regress gate and ``obs`` CLI (``tpu_p2p_torch/obs/
regress.py``) and step timeline (``obs/timeline.py``) against the JAX
reference.

- The gate over the repo's own artifacts, for each ``BENCH_r0k.json`` as
  ``--current``: the printed table and the exit code byte for byte the
  reference's (host logic over the same files), and a tampered artifact
  regressing alike.
- ``print_schedule_bubbles`` text equal for several sizes, with and
  without a measured pair.
- ``write_multichip_artifact`` / ``write_probe_artifact`` written by the
  port, read back by the reference's ``load_multichip_history`` and the
  port's: equal.
- The CLI goldens: ``obs --cpu-mesh 8 --msg-size 256KiB --count 4
  --current BENCH_r05.json`` equals ``tests/golden/cli_obs_8dev.txt``
  after ``mask_floats`` and the port's ``_masked``; ``obs trace`` and
  ``topo`` still exit 2.
- The timeline: ``pick_window_step`` on a grid, ``StepTimeline`` under an
  injected clock, ``device_window_record`` without a device track: each
  the reference's.
"""

import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from test_cli_golden import GOLDEN_DIR, mask_floats
from test_torch_collectives_cli import _masked
from tpu_p2p.obs import ledger as JL
from tpu_p2p.obs import regress as JR
from tpu_p2p.obs import timeline as JT
from tpu_p2p_torch.obs import ledger as TL
from tpu_p2p_torch.obs import regress as TR
from tpu_p2p_torch.obs import timeline as TT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = sorted(f for f in os.listdir(REPO) if f.startswith("BENCH_r"))


def _gate(module, current, artifacts=REPO):
    cur, head, priors = module.load_trajectory(artifacts, current)
    buf = io.StringIO()
    rc = module.print_gate(cur, module.compare(head, priors), priors,
                           stream=buf)
    return rc, buf.getvalue()


@pytest.mark.parametrize("current", ROUNDS)
def test_gate_table_equals_the_reference(current):
    assert _gate(TR, current) == _gate(JR, current)


def test_gate_regression_and_detail_file_equal_the_reference(tmp_path):
    with open(os.path.join(REPO, ROUNDS[-1])) as fh:
        art = json.load(fh)
    head = JR.headline_from_artifact(art)
    key = next(iter(head))
    worse = {k: (v * 0.1 if JR.TOLERANCES[k].better == "higher"
                 else v * 10) for k, v in head.items()}
    for name, data in (("BENCH_detail.json", {"detail": worse}),
                       ("line.json", {"headline": {key: head[key]}})):
        p = tmp_path / name
        p.write_text(json.dumps(data))
        t, j = _gate(TR, str(p)), _gate(JR, str(p))
        assert t == j
    assert _gate(TR, str(tmp_path / "BENCH_detail.json"))[0] == 1
    assert TR.TOLERANCES == {k: TR.Tolerance(v.better, v.rel, v.abs_floor)
                             for k, v in JR.TOLERANCES.items()}
    with pytest.raises(FileNotFoundError):
        TR.load_trajectory(str(tmp_path / "none"))


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("head", [None, {"pp_zb_vs_fused_ratio": 0.8},
                                  {"pp_step_ms_sched_1f1b": 12.0,
                                   "pp_step_ms_sched_zb": 9.0,
                                   "pp_bubble_frac_measured_zb": 0.31}])
def test_schedule_bubbles_text_equals_the_reference(n, head):
    t, j = io.StringIO(), io.StringIO()
    TR.print_schedule_bubbles(n, head, stream=t)
    JR.print_schedule_bubbles(n, head, stream=j)
    assert t.getvalue() == j.getvalue()


def _join(module):
    led = module.CollectiveLedger()
    with module.recording(led):
        module.record_issue("ppermute", "d", nbytes=1_000_000, axis_size=4,
                            edges=[(0, 1), (1, 2), (2, 3), (3, 0)])
        module.record_issue("dma", "d", nbytes=65536, axis_size=4,
                            edges=[(0, 1), (1, 2), (2, 3), (3, 0)])
    iss = led.issues
    return module.TraceJoin(joined=[
        module.JoinedEvent(iss[0], 0.0, 100e-6, "a"),
        module.JoinedEvent(iss[1], 200e-6, 210e-6, "b")])


def test_multichip_round_trip_equals_the_references_loader(tmp_path):
    # The port writes (a trace matrix, a probe matrix, a foreign file);
    # both loaders read the same history.
    t_dir, j_dir = tmp_path / "t", tmp_path / "j"
    t_dir.mkdir()
    j_dir.mkdir()
    (t_dir / "MULTICHIP_r01.json").write_text('{"status": "dryrun"}')
    (j_dir / "MULTICHIP_r01.json").write_text('{"status": "dryrun"}')
    probe = [[None, 3.0, float("nan"), 1.0], [2.0, None, 9.0, 1.0],
             [1.0, 1.0, None, 1.0], [5.0, 1.0, 1.0, None]]
    pt = TR.write_probe_artifact(probe, 4, str(t_dir))
    pj = JR.write_probe_artifact(probe, 4, str(j_dir))
    assert os.path.basename(pt) == os.path.basename(pj) == \
        "MULTICHIP_r02.json"
    wt = TR.write_multichip_artifact(_join(TL), 4, str(t_dir))
    wj = JR.write_multichip_artifact(_join(JL), 4, str(j_dir))
    with open(wt) as a, open(wj) as b:
        assert json.load(a) == json.load(b)
    for sources in (False, True):
        got = TR.load_multichip_history(str(t_dir), with_sources=sources)
        assert got == JR.load_multichip_history(str(t_dir),
                                                with_sources=sources)
        assert got == JR.load_multichip_history(str(j_dir),
                                                with_sources=sources)
    assert TR.write_multichip_artifact(
        TL.TraceJoin(no_device_track=True), 4, str(t_dir)) is None


# ------------------------------------------------------------------ CLI


def test_obs_cli_golden_on_eight_ranks():
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_p2p_torch", "obs", "--cpu-mesh", "8",
         "--msg-size", "256KiB", "--count", "4", "--current",
         "BENCH_r05.json"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(os.path.join(GOLDEN_DIR, "cli_obs_8dev.txt")) as fh:
        want = fh.read()
    assert _masked(mask_floats(proc.stdout)) == _masked(mask_floats(want))


def test_obs_cli_gate_only_and_what_is_not_ported(capsys, monkeypatch):
    import torch

    from tpu_p2p_torch import cli as TCLI

    assert TCLI.main(["obs", "--no-live", "--current", ROUNDS[-1],
                      "--artifacts-dir", REPO]) == 0
    out = capsys.readouterr().out
    assert out == _gate(JR, ROUNDS[-1])[1]
    # Ported since: obs trace, obs ckpt-smoke and topo run, and take the
    # default card path, which this host does not have.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    for argv in (["obs", "trace"], ["obs", "ckpt-smoke"], ["topo"]):
        assert TCLI.main(argv) == 255
        err = capsys.readouterr().err
        assert "0 CUDA device" in err and "not ported yet" not in err


# ------------------------------------------------------------- timeline


def test_pick_window_step_equals_the_reference_on_a_grid():
    for start in range(0, 4):
        for steps in range(start, start + 5):
            for win in (None, -3, 0, 1, 2, 5, 9):
                assert TT.pick_window_step(start, steps, win) == \
                    JT.pick_window_step(start, steps, win)
    assert TT.SPAN_KINDS == JT.SPAN_KINDS


def test_step_timeline_records_equal_the_reference():
    def clock(ticks):
        it = iter(ticks)
        return lambda: next(it)

    rng = np.random.default_rng(3)
    ticks = list(np.cumsum(rng.uniform(0.0001, 0.02, 40)))
    recs = {}
    for name, module in (("t", TT), ("j", JT)):
        out = []
        tl = module.StepTimeline(out.append, clock=clock(ticks))
        for step in range(1, 5):
            with tl.span("data"):
                pass
            with tl.span("step"):
                pass
            if step == 2:
                with tl.span("data"):
                    pass
            tl.end_step(step, extra={"x": step} if step == 3 else None)
        out.append(tl.summary_record())
        recs[name] = (out, tl.p50_step_ms(), tl.p99_step_ms())
    assert recs["t"] == recs["j"]


def test_device_window_record_without_a_device_track(tmp_path):
    # The reference's null record, from its own window on the CPU mesh
    # (host events only), beside the port's from a CPU window.
    import jax
    import jax.numpy as jnp

    trace_dir = str(tmp_path / "xla")
    with jax.profiler.trace(trace_dir):
        jax.block_until_ready(jnp.ones(8) + 1)
    events = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0,
               "dur": 10, "pid": 1, "tid": 1}]
    got = TT.device_window_record(events, step=2)
    want = JT.device_window_record(trace_dir, step=2)
    assert got == want
    led_t, led_j = TL.CollectiveLedger(), JL.CollectiveLedger()
    for led, mod in ((led_t, TL), (led_j, JL)):
        with mod.recording(led):
            mod.record_issue("all_reduce", "dp", nbytes=64, axis_size=2)
    got = TT.device_window_record(events, step=3, ledger=led_t)
    want = JT.device_window_record(trace_dir, step=3, ledger=led_j)
    assert got == want and got["device_track"] is False


def test_device_window_record_with_a_device_track():
    # Kernels on one card: busy 300 of 400 us; the send/recv half under
    # a concurrent GEMM.
    def k(name, ts, dur, stream):
        return {"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                "dur": dur, "pid": 0, "tid": stream,
                "args": {"device": 0, "stream": stream}}

    events = [k("gemm", 0, 200, 7),
              k("ncclDevKernel_SendRecv(x)", 100, 200, 13),
              k("flash_fwd_kernel_wgmma", 300, 0, 7),
              k("late_gemm", 350, 50, 7)]
    led = TL.CollectiveLedger()
    with TL.recording(led):
        TL.record_issue("ppermute", "tp", nbytes=100_000, axis_size=2,
                        edges=[(0, 1), (1, 0)])
    rec = TT.device_window_record(events, step=5, ledger=led)
    assert rec["device_track"] is True
    assert rec["device_busy_frac"] == round(350 / 400, 4)
    assert rec["tp_overlap_frac"] == 0.5
    assert rec["gather_overlap_frac"] is None
    assert rec["collectives"]["ppermute"]["events"] == 1
    assert rec["ledger_issues"] == 1
    assert rec["unmatched_collective_events"] == 0
