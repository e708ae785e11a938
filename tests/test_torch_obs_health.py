"""The port's health engine (``tpu_p2p_torch/obs/health.py``), fault
shapes (``obs/faults.py``) and the training loop's obs stream and heal
(``train.py``) against the JAX reference.

- Detectors on seeded inputs give the reference's verdicts and records:
  ``fleet_median``, ``detect_degraded_links`` (with and without a
  baseline), ``attribute_host``, ``StragglerDetector`` on seeded
  step-ms streams, ``HealthMonitor`` with heartbeats and link matrices.
- ``obs watch`` prints the reference's text with the reference's exit
  code on the golden fixture and on streams of every record kind.
- Training with ``obs_jsonl`` on one gloo world of 4 (dp 2 x sp 2,
  ``tests/torch_obs_world.py``) against the reference on a 4-device CPU
  mesh: the final loss within the mesh step's 1e-4, the stream's record kinds
  and steps equal; the lost host detected and healed onto 2 ranks with
  the reference's heal record, the healed loss within 1e-4 of the
  reference's healed run and of the uninterrupted one; rank 1
  straggling detected within 5 steps. ``train --trace`` writes a trace
  that passes ``validate_chrome_trace``.
- Marked ``slow``, as the reference marks its own
  (``tests/test_obs_health.py``): the full ``obs smoke --cpu-mesh 8``.
"""

import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from tpu_p2p.obs import faults as JFaults
from tpu_p2p.obs import health as JH
from tpu_p2p_torch.obs import faults as TFaults
from tpu_p2p_torch.obs import health as TH
from tpu_p2p_torch.parallel.launch import run_world

HERE = os.path.dirname(__file__)
WORLD = os.path.join(HERE, "torch_obs_world.py")
GOLDEN = os.path.join(HERE, "golden")
REPO = os.path.dirname(HERE)

CFG = dict(batch=8, seq=32, heads=4, head_dim=8, stages=2, microbatches=2,
           num_experts=2, capacity_factor=4.0, norm=True)
START = 2 + JH.HealthConfig.straggler_min_samples + 1
STEPS = START + 4


# ------------------------------------------------------------ detectors


def _seeded_matrices():
    rng = np.random.default_rng(11)
    out = []
    for n in (2, 4, 8):
        for trial in range(4):
            m = (10 + rng.standard_normal((n, n))).tolist()
            for i in range(n):
                m[i][i] = math.nan
            if trial % 2:
                i, j = rng.choice(n, 2, replace=False)
                m[int(i)][int(j)] = float(rng.uniform(0.5, 4.0))
            if trial == 3:  # a sagging host and an unmeasured link
                h = int(rng.integers(n))
                for j in range(n):
                    if j != h:
                        m[h][j] *= 0.3
                        m[j][h] *= 0.3
                m[0][n - 1] = None
            out.append(m)
    return out


@pytest.mark.parametrize("idx", range(12))
def test_link_detectors_match_the_reference(idx):
    m = _seeded_matrices()[idx]
    base = [[(v * 3 if v is not None and v == v else None) for v in row]
            for row in m]
    assert TH.fleet_median(m) == JH.fleet_median(m)
    for kw in ({}, {"frac": 0.7}, {"baseline": base},
               {"baseline": base, "baseline_frac": 0.9}):
        assert TH.detect_degraded_links(m, **kw) == \
            JH.detect_degraded_links(m, **kw)
    assert TH.attribute_host(m) == JH.attribute_host(m)
    tm, jm = TH.HealthMonitor(), JH.HealthMonitor()
    assert [v.to_record() for v in tm.observe_link_matrix(3, m)] == \
        [v.to_record() for v in jm.observe_link_matrix(3, m)]


@pytest.mark.parametrize("seed", range(6))
def test_straggler_and_heartbeats_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    stream = list(100 + rng.standard_normal(40) * 3)
    stream[0] = 900.0  # the compile-carrying first step
    for at in rng.choice(np.arange(6, 40), 3, replace=False):
        stream[int(at)] = 400.0
        if int(at) + 1 < 40:
            stream[int(at) + 1] = 420.0
    cfg_kw = dict(straggler_window=int(rng.integers(4, 17)),
                  straggler_z=float(rng.uniform(2, 5)),
                  straggler_consecutive=int(rng.integers(1, 3)),
                  lost_after=int(rng.integers(1, 4)))
    td = TH.StragglerDetector.from_config(TH.HealthConfig(**cfg_kw))
    jd = JH.StragglerDetector.from_config(JH.HealthConfig(**cfg_kw))
    assert [td.observe(x) for x in stream] == [jd.observe(x)
                                                for x in stream]
    t_recs, j_recs = [], []
    tm = TH.HealthMonitor(TH.HealthConfig(**cfg_kw), emit=t_recs.append,
                          n_hosts=4)
    jm = JH.HealthMonitor(JH.HealthConfig(**cfg_kw), emit=j_recs.append,
                          n_hosts=4)
    lost = int(rng.integers(4))
    for step, ms in enumerate(stream, start=1):
        alive = [h for h in range(4) if h != lost or step < 20]
        kw = dict(alive_hosts=alive, score_straggler=step > 1)
        assert [v.to_record() for v in tm.observe_step(step, ms, **kw)] \
            == [v.to_record() for v in jm.observe_step(step, ms, **kw)]
    assert t_recs == j_recs and tm.lost_hosts == jm.lost_hosts == (lost,)


def test_config_verdict_and_fault_shapes_match_the_reference():
    for bad in (dict(link_frac_of_median=1.0), dict(baseline_frac=0.0),
                dict(lost_after=0), dict(straggler_consecutive=0)):
        with pytest.raises(ValueError) as t:
            TH.HealthConfig(**bad)
        with pytest.raises(ValueError) as j:
            JH.HealthConfig(**bad)
        assert str(t.value) == str(j.value)
    v = dict(kind="lost_host", step=4, detail={"host": 2, "links": [1]})
    assert TH.HealthVerdict(**v).describe() == \
        JH.HealthVerdict(**v).describe()
    assert str(TH.HostLostError(3, 9)) == str(JH.HostLostError(3, 9))
    plan = dict(lost_host=2, start_step=3)
    for h in range(4):
        for s in range(6):
            assert TFaults.host_lost(TFaults.FaultPlan(**plan), h, s) == \
                JFaults.host_lost(JFaults.FaultPlan(**plan), h, s)


# ---------------------------------------------------------------- watch


def _watch(module, argv, capsys):
    rc = module.watch_main(argv)
    return rc, capsys.readouterr().out


def test_watch_golden_fixture(capsys):
    from test_cli_golden import mask_floats

    path = os.path.join(GOLDEN, "obs_watch_fixture.jsonl")
    rc, out = _watch(TH, [path, "--expect-alerts"], capsys)
    assert rc == 0
    with open(os.path.join(GOLDEN, "cli_obs_watch_8dev.txt")) as fh:
        assert mask_floats(out) == mask_floats(fh.read())


_STREAMS = {
    "clean": [{"obs": "step", "step": i, "step_ms": 100.0 + i % 3}
              for i in range(1, 12)],
    "ckpt": [{"obs": "ckpt", "event": "save", "step": 2, "ok": True},
             {"obs": "ckpt", "event": "fallback", "step": 4,
              "skipped": [{"generation": "gen-000004"}], "ok": True},
             {"obs": "ckpt", "event": "crash_restart", "step": 6,
              "resume_step": 4, "restarts": 1, "ok": False}],
    "serve": [{"obs": "request", "id": i, "outcome":
               "shed_deadline" if i == 3 else "finished",
               "shed_step": 5 if i == 3 else None,
               "migrate_step": 2 if i % 2 else None,
               "migrate_wait_steps": i} for i in range(6)]
             + ["{torn", ""],
    "health": [{"obs": "health", "verdict": "lost_host", "step": 8,
                "host": 3, "last_seen_step": 6, "missed_steps": 2}],
}


@pytest.mark.parametrize("name", sorted(_STREAMS))
@pytest.mark.parametrize("extra", [[], ["--expect-alerts"],
                                   ["--max-shed-frac", "0.5",
                                    "--max-migrate-wait-steps", "3"]])
def test_watch_matches_the_reference(name, extra, tmp_path, capsys):
    p = tmp_path / "obs.jsonl"
    p.write_text("".join((r if isinstance(r, str) else json.dumps(r))
                         + "\n" for r in _STREAMS[name]))
    t = _watch(TH, [str(p), *extra], capsys)
    j = _watch(JH, [str(p), *extra], capsys)
    assert t == j
    assert TH.watch_main([str(tmp_path / "missing.jsonl")]) == 2


# ------------------------------------------------------ the train world


def _reference_runs(tmp_path):
    from tpu_p2p.models import flagship as JF
    from tpu_p2p.train import run_training, run_training_with_heal

    mesh = JF.build_mesh(4, devices=jax.devices()[:4])
    cfg = JF.FlagshipConfig(**CFG)
    clean = tmp_path / "ref_clean.jsonl"
    a = run_training(mesh, cfg, steps=STEPS, lr=1e-2, log_every=0,
                     obs_jsonl=str(clean))
    heal = tmp_path / "ref_heal.jsonl"
    b = run_training_with_heal(
        mesh, cfg, steps=STEPS, lr=1e-2, log_every=0,
        ckpt_dir=str(tmp_path / "ref_ck"), ckpt_every=2,
        obs_jsonl=str(heal),
        fault_plan=JFaults.FaultPlan(lost_host=3, start_step=START))

    def recs(p):
        return [json.loads(s) for s in p.read_text().splitlines()]

    return {"clean": (a["final_loss"], recs(clean)),
            "heal": (b["final_loss"], b["heal"], recs(heal))}


@pytest.fixture(scope="module")
def train_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("obs_train")
    port = run_world(4, f"{WORLD}:train_case",
                     {"cfg_kw": {**CFG, "dtype": "float32"},
                      "steps": STEPS, "start": START, "slow_ms": 400.0,
                      "trace_dir": str(tmp)}, timeout=400)
    return port, _reference_runs(tmp)


def _kinds(records):
    # A straggler verdict reads the wall clock, and a loaded host can
    # raise one in either run: the stream is held without them.
    return [(r["obs"], r.get("step"), r.get("verdict"), r.get("event"))
            for r in records if r.get("verdict") != "straggler"]


def test_train_obs_stream_matches_the_reference(train_world):
    port, ref = train_world
    want_loss, want = ref["clean"]
    got = port[0]["clean"]
    assert abs(got["final_loss"] - want_loss) <= 1e-4
    assert _kinds(got["records"]) == _kinds(want)
    dev = [r for r in got["records"] if r["obs"] == "device_window"]
    assert dev and dev[0]["device_track"] is False
    assert all(r["final_loss"] == got["final_loss"]
               for r in (p["clean"] for p in port))
    assert all(p["clean"]["records"] is None for p in port[1:])


def test_lost_host_heals_onto_two_ranks_as_the_reference(train_world):
    port, ref = train_world
    want_loss, want_heal, want = ref["heal"]
    got = port[0]["heal"]
    assert got["heal"] == want_heal == {
        "lost_host": 3, "detected_step": START + 1,
        "resume_step": START + 1, "devices": 2}
    assert [p["heal"]["in_new_mesh"] for p in port] == [True, True,
                                                        False, False]
    assert abs(got["final_loss"] - want_loss) <= 1e-4
    assert abs(got["final_loss"] - ref["clean"][0]) <= 1e-4
    assert _kinds(got["records"]) == _kinds(want)
    lost = [r for r in got["records"] if r.get("verdict") == "lost_host"]
    assert lost[0]["host"] == 3 and lost[0]["step"] - START + 1 <= 5


def test_train_straggler_scenario_detected(train_world):
    # As the reference's test of the same name: rank 1 sleeps from a
    # known step on (only that rank; its peers wait in the next step's
    # collectives), and the first rank's monitor must verdict within 5
    # monitored steps.
    port, _ = train_world
    recs = port[0]["slow"]["records"]
    # A verdict before the onset is wall-clock noise on a loaded host,
    # not a detection (the reference's run_smoke filters it alike).
    hits = [r for r in recs if r.get("verdict") == "straggler"
            and r["step"] >= START]
    assert hits, "injected straggler went undetected"
    assert hits[0]["step"] - START + 1 <= 5


def test_train_trace_flag_writes_a_valid_chrome_trace(tmp_path, capsys):
    from tpu_p2p_torch import train as TT
    from tpu_p2p_torch.obs.trace import validate_chrome_trace

    obs, trace = tmp_path / "o.jsonl", tmp_path / "t.json"
    argv = ["--device", "cpu", "--batch", "2", "--seq", "16", "--heads",
            "2", "--head-dim", "8", "--steps", "3", "--log-every", "0",
            "--obs-jsonl", str(obs), "--trace", str(trace)]
    assert TT.main(argv) == 0
    out = capsys.readouterr().out
    assert f"# wrote chrome trace {trace}" in out
    with open(trace) as fh:
        assert validate_chrome_trace(json.load(fh)) == []
    with pytest.raises(SystemExit, match="requires --obs-jsonl"):
        TT.main(["--trace", str(trace)])


@pytest.mark.slow  # the full smoke matrix, as the reference marks its own
def test_obs_smoke_cpu_mesh_8():
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_p2p_torch", "obs", "smoke",
         "--cpu-mesh", "8"], cwd=REPO, capture_output=True, text=True,
        timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["ok"] is True
    assert res["health_detect_steps"] <= 5
    assert res["heal_loss_delta_rel"] <= 0.05
    assert res["heal_devices"] == 4
