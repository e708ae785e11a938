"""The port's checkpoint durability chaos (``tpu_p2p_torch/obs/ckpt.py``
and the pieces it grades) against the JAX reference, case for case with
``tests/test_ckpt_chaos.py``: the bounded retry, the storage fault
shapes, the crash-resilient supervisor, the watch's checkpoint alerts and
the graded ``obs ckpt-smoke``.

- Host logic is equal: the retry's calls and backoff, the fault plans'
  validation messages and one-shot state, the watch's text and exit
  codes.
- The supervisor, the rotted-generation resume and the transient-IO
  retry run the port's loop on a world of one and are held to the
  reference's records on its one-device mesh (the crash record, the
  resume receipt, the final loss within the training loop's 1e-4); the
  resumed-from generation is bitwise the port's uninterrupted twin's.
- ``obs ckpt-smoke`` on a world of one prints the reference's three
  scenario lines, each graded ok.
"""

import io
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tpu_p2p.models import flagship as JF
from tpu_p2p.obs import faults as JFaults
from tpu_p2p.train import run_training as j_run_training
from tpu_p2p.train import run_training_supervised as j_supervised
from tpu_p2p.utils.retry import retry_io as j_retry_io
from tpu_p2p_torch.models import flagship as TF
from tpu_p2p_torch.obs import faults
from tpu_p2p_torch.parallel.launch import run_world
from tpu_p2p_torch.utils import checkpoint as C
from tpu_p2p_torch.utils.retry import retry_io

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORLD = os.path.join(HERE, "torch_ckpt_world.py")
CFG = dict(batch=8, seq=32, heads=4, head_dim=8, stages=2, microbatches=2,
           num_experts=2, capacity_factor=4.0, norm=True)
LOSS_RTOL = 1e-4


def _both(fn):
    """``fn(retry_io)`` for the port and the reference → both results."""
    return fn(retry_io), fn(j_retry_io)


def _one():
    return JF.build_mesh(1, devices=jax.devices()[:1])


# ----------------------------------------------------- retry helper


def test_retry_io_succeeds_after_transient_failures():
    def run(retry):
        calls = {"n": 0}
        retried, slept = [], []

        def flaky():
            calls["n"] += 1
            if calls["n"] <= 2:
                raise OSError("blip")
            return "ok"

        out = retry(flaky, attempts=5, base_delay_s=0.01,
                    sleep=slept.append,
                    on_retry=lambda i, e: retried.append(i))
        return out, calls["n"], retried, slept

    got, want = _both(run)
    assert got == want == ("ok", 3, [1, 2], [0.01, 0.02])


def test_retry_io_exhausts_budget_and_reraises():
    def run(retry):
        calls = {"n": 0}

        def always():
            calls["n"] += 1
            raise OSError("down")

        with pytest.raises(OSError, match="down"):
            retry(always, attempts=3, base_delay_s=0, sleep=lambda s: None)
        return calls["n"]

    assert _both(run) == (3, 3)


def test_retry_io_does_not_retry_non_matching_exceptions():
    def run(retry):
        calls = {"n": 0}

        def boom():
            calls["n"] += 1
            raise ValueError("not io")

        with pytest.raises(ValueError):
            retry(boom, attempts=5, sleep=lambda s: None)
        return calls["n"]

    assert _both(run) == (1, 1)


def test_retry_io_never_swallows_simulated_crash():
    calls = {"n": 0}

    def die():
        calls["n"] += 1
        raise faults.SimulatedCrash("/x/params.npz", 7)

    with pytest.raises(faults.SimulatedCrash):
        retry_io(die, attempts=5, sleep=lambda s: None)
    assert calls["n"] == 1
    assert not issubclass(faults.SimulatedCrash, Exception)


# ------------------------------------------------ fault plan shapes


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_fault_plan_ckpt_fields_validated():
    for kw in (dict(ckpt_crash_after_bytes=-1), dict(ckpt_io_errors=-2)):
        assert _message(lambda: faults.FaultPlan(**kw)) == \
            _message(lambda: JFaults.FaultPlan(**kw))
    kw = dict(ckpt_crash_after_bytes=512, ckpt_corrupt_seed=3,
              ckpt_io_errors=2, start_step=4)
    d = faults.FaultPlan(**kw).describe()
    assert d == JFaults.FaultPlan(**kw).describe()
    assert "crash checkpoint save after 512 bytes" in d
    assert "from step 4" in d


def test_ckpt_crash_is_one_shot_per_plan_instance():
    def run(mod):
        plan = mod.FaultPlan(ckpt_crash_after_bytes=64, start_step=2)
        out = [mod.ckpt_crash_budget(plan, s) for s in (1, 2, 3)]
        mod.mark_ckpt_crash_fired(plan)
        out.append(mod.ckpt_crash_budget(plan, 4))
        fresh = mod.FaultPlan(ckpt_crash_after_bytes=64, start_step=2)
        out.append(mod.ckpt_crash_budget(fresh, 2))
        return out

    assert run(faults) == run(JFaults) == [None, 64, 64, None, 64]


def test_ckpt_io_error_counts_first_n_attempts():
    def run(mod):
        plan = mod.FaultPlan(ckpt_io_errors=2)
        got = [mod.take_ckpt_io_error(plan) for _ in range(4)]
        return got + [mod.take_ckpt_io_error(None),
                      mod.take_ckpt_io_error(mod.FaultPlan(
                          ckpt_io_errors=1))]

    assert run(faults) == run(JFaults) == [True, True, False, False,
                                           False, True]


def test_ckpt_corrupt_due_gated_by_start_step():
    def run(mod):
        plan = mod.FaultPlan(ckpt_corrupt_seed=0, start_step=6)
        return [mod.ckpt_corrupt_due(plan, s) for s in (3, 6, 9)] + [
            mod.ckpt_corrupt_due(None, 9)]

    assert run(faults) == run(JFaults) == [False, True, True, False]


def _w():
    return {"w": torch.ones((2, 2), dtype=torch.float32)}


def test_io_faults_only_apply_under_injecting(tmp_path):
    faults.FaultPlan(ckpt_io_errors=5, ckpt_crash_after_bytes=1)
    stats = C.save_generation(str(tmp_path), _w(), 1)
    assert stats["write_retries"] == 0
    assert C.verify_generation(stats["path"]) is None


def test_transient_io_fault_rides_the_retry(tmp_path):
    with faults.injecting(faults.FaultPlan(ckpt_io_errors=3)):
        stats = C.save_generation(str(tmp_path), _w(), 1)
    assert stats["write_retries"] == 3
    assert C.verify_generation(stats["path"]) is None
    assert C.load_latest(str(tmp_path)).skipped == []


def test_corrupt_fault_rots_only_from_start_step(tmp_path):
    from tpu_p2p.utils import checkpoint as JC

    got = {}
    for side, mod, ck, plan in (
            ("port", C, faults, faults.FaultPlan),
            ("ref", JC, JFaults, JFaults.FaultPlan)):
        td = str(tmp_path / side)
        w = (lambda: {"w": torch.ones((4, 4))}) if side == "port" else \
            (lambda: {"w": np.ones((4, 4), np.float32)})
        with ck.injecting(plan(ckpt_corrupt_seed=7, start_step=4)):
            a = mod.save_generation(td, w(), 2)
            b = mod.save_generation(td, w(), 4)
        lc = mod.load_latest(td)
        got[side] = (a["corrupted"], b["corrupted"],
                     mod.verify_generation(a["path"]),
                     mod.verify_generation(b["path"]), lc.name, lc.skipped)
    assert got["port"] == got["ref"]
    assert got["port"][:2] == (False, True)
    assert "checksum" in got["port"][3]
    assert got["port"][4] == "gen-000002"


# ------------------------------------------------------- supervisor


def test_supervisor_requires_checkpointing():
    from tpu_p2p_torch.train import run_training_supervised

    cfg, jcfg = TF.FlagshipConfig(**CFG), JF.FlagshipConfig(**CFG)
    assert _message(lambda: run_training_supervised(
        cfg, steps=2, device="cpu")) == _message(
        lambda: j_supervised(_one(), jcfg, steps=2))
    assert _message(lambda: run_training_supervised(
        cfg, steps=2, device="cpu", ckpt_dir="/tmp/x", ckpt_every=1,
        max_restarts=0)) == _message(lambda: j_supervised(
            _one(), jcfg, steps=2, ckpt_dir="/tmp/x", ckpt_every=1,
            max_restarts=0))


def _params(path):
    return C._load_flat_params(path)[0]


def test_supervisor_reenters_from_newest_intact_generation(tmp_path):
    from tpu_p2p_torch.train import run_training, run_training_supervised

    cfg = TF.FlagshipConfig(**CFG)
    ref_ck = str(tmp_path / "twin")
    twin = run_training(cfg, steps=6, lr=5e-2, log_every=0, device="cpu",
                        ckpt_dir=ref_ck, ckpt_every=2)
    ck, obs = str(tmp_path / "sup"), str(tmp_path / "obs.jsonl")
    stream = io.StringIO()
    out = run_training_supervised(
        cfg, steps=6, lr=5e-2, log_every=0, device="cpu", ckpt_dir=ck,
        ckpt_every=2, obs_jsonl=obs, log_stream=stream,
        fault_plan=faults.FaultPlan(ckpt_crash_after_bytes=512,
                                    start_step=4))
    want = j_supervised(
        _one(), JF.FlagshipConfig(**CFG), steps=6, lr=5e-2, log_every=0,
        ckpt_dir=str(tmp_path / "ref"), ckpt_every=2,
        fault_plan=JFaults.FaultPlan(ckpt_crash_after_bytes=512,
                                     start_step=4))
    assert out["supervisor"] == want["supervisor"]
    assert out["supervisor"]["crashes"] == [
        {"step": 4, "resume_step": 2, "lost_steps": 2}]
    for _s, name in C.list_generations(ck):
        assert C.verify_generation(os.path.join(ck, name)) is None
    pa = _params(os.path.join(ck, "gen-000002"))
    pb = _params(os.path.join(ref_ck, "gen-000002"))
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    assert out["final_loss"] == twin["final_loss"]
    np.testing.assert_allclose(out["final_loss"], want["final_loss"],
                               rtol=LOSS_RTOL)
    text = stream.getvalue()
    assert "# supervise: crashed mid-checkpoint at step 4" in text
    assert "resuming from gen-000002" in text
    recs = [json.loads(ln) for ln in open(obs) if ln.strip()]
    restarts = [r for r in recs if r.get("obs") == "ckpt"
                and r.get("event") == "crash_restart"]
    assert len(restarts) == 1 and restarts[0]["resume_step"] == 2
    saves = [r for r in recs if r.get("obs") == "ckpt"
             and r.get("event") == "save"]
    assert saves and all(r["ok"] for r in saves)


def test_supervisor_gives_up_past_restart_budget(tmp_path, monkeypatch):
    from tpu_p2p_torch.train import run_training_supervised

    real = faults.ckpt_crash_budget

    def always_armed(plan, step):
        if plan is not None and plan.ckpt_crash_after_bytes is not None:
            return plan.ckpt_crash_after_bytes
        return real(plan, step)

    monkeypatch.setattr(faults, "ckpt_crash_budget", always_armed)
    with pytest.raises(faults.SimulatedCrash):
        run_training_supervised(
            TF.FlagshipConfig(**CFG), steps=4, lr=5e-2, log_every=0,
            device="cpu", ckpt_dir=str(tmp_path / "ck"), ckpt_every=2,
            fault_plan=faults.FaultPlan(ckpt_crash_after_bytes=8),
            max_restarts=2)


def test_resume_emits_fallback_receipt(tmp_path):
    from tpu_p2p_torch.train import run_training

    cfg = TF.FlagshipConfig(**CFG)
    got = {}
    for side in ("port", "ref"):
        ck = str(tmp_path / side)
        if side == "port":
            run_training(cfg, steps=4, lr=5e-2, log_every=0, device="cpu",
                         ckpt_dir=ck, ckpt_every=2)
        else:
            j_run_training(_one(), JF.FlagshipConfig(**CFG), steps=4,
                           lr=5e-2, log_every=0, ckpt_dir=ck, ckpt_every=2)
        fp = os.path.join(ck, "gen-000004", "params.npz")
        with open(fp, "rb") as fh:
            data = bytearray(fh.read())
        data[len(data) // 2] ^= 1
        with open(fp, "wb") as fh:
            fh.write(bytes(data))
        obs = str(tmp_path / f"{side}.jsonl")
        out = run_training(cfg, steps=6, lr=5e-2, log_every=0,
                           device="cpu", ckpt_dir=ck, resume=True,
                           obs_jsonl=obs)
        fb = [json.loads(ln) for ln in open(obs) if ln.strip()]
        fb = [r for r in fb if r.get("obs") == "ckpt"
              and r.get("event") == "fallback"]
        got[side] = (out["ckpt_resume"], out["start_step"],
                     [(r["generation"], r["skipped"][0]["generation"])
                      for r in fb])
    assert got["port"] == got["ref"]
    receipt, start, fb = got["port"]
    assert receipt["generation"] == "gen-000002" and start == 2
    assert "checksum" in receipt["skipped"][0]["reason"]
    assert fb == [("gen-000002", "gen-000004")]


# ---------------------------------------------------- watch alerting


def _watch(tmp_path, lines, *args):
    from tpu_p2p.obs.health import watch_main as j_watch
    from tpu_p2p_torch.obs.health import watch_main

    path = str(tmp_path / "obs.jsonl")
    with open(path, "w") as fh:
        fh.write("\n".join(json.dumps(r) for r in lines) + "\n")
    got, want = io.StringIO(), io.StringIO()
    rc = watch_main([path, *args], stream=got)
    assert rc == j_watch([path, *args], stream=want)
    assert got.getvalue() == want.getvalue()
    return rc, got.getvalue()


def test_watch_alerts_on_ckpt_fallback_and_crash(tmp_path):
    rc, text = _watch(tmp_path, [
        {"obs": "ckpt", "event": "save", "step": 2,
         "generation": "gen-000002", "save_ms": 4.2, "ok": True},
        {"obs": "ckpt", "event": "load", "step": 2,
         "generation": "gen-000002", "skipped": [], "ok": True}])
    assert rc == 0 and "ALERT" not in text
    assert "# watch: 2 ckpt row(s), 0 fallback/crash" in text
    rc, text = _watch(tmp_path, [
        {"obs": "ckpt", "event": "fallback", "step": 6,
         "generation": "gen-000006",
         "skipped": [{"generation": "gen-000009",
                      "reason": "checksum mismatch in params.npz"}],
         "ok": True}])
    assert rc == 1 and "# ALERT step 6 ckpt_fallback" in text
    crash = [{"obs": "ckpt", "event": "crash_restart", "step": 4,
              "resume_step": 2, "restarts": 1, "ok": False}]
    rc, text = _watch(tmp_path, crash)
    assert rc == 1 and "ckpt_crash_restart" in text
    rc, _ = _watch(tmp_path, crash, "--expect-alerts")
    assert rc == 0


def test_watch_training_log_contract_unchanged(tmp_path):
    rc, text = _watch(tmp_path, [
        {"obs": "step", "step": 1, "step_ms": 10.0, "spans": {}},
        {"obs": "step", "step": 2, "step_ms": 10.1, "spans": {}}])
    assert rc == 0 and "ckpt row" not in text
    assert "# watch: 0 alert(s) over 2 step row(s)" in text


# ------------------------------------------------- chaos smoke (e2e)


def _scenario_lines(stdout):
    return [ln for ln in stdout.splitlines() if ln.startswith("# ckpt ")]


def test_ckpt_smoke_cli_grades_as_the_reference():
    # The port's smoke on a world of one (CPU) against the reference's
    # on its one-device mesh: the same three scenario lines (restarts,
    # crash step, resumed-from generation, bitwise, rot reason, skipped
    # generation, retries, fallbacks), each graded ok, and the gate
    # numbers' schema.
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, "-m", pkg, "obs", "ckpt-smoke", *extra], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for pkg, extra in (("tpu_p2p_torch", ["--device", "cpu"]),
                           ("tpu_p2p", []))]  # both at once
    (got, got_err), (want, want_err) = (p.communicate(timeout=300)
                                        for p in procs)
    assert procs[0].returncode == 0, got_err[-3000:]
    assert procs[1].returncode == 0, want_err[-3000:]
    assert _scenario_lines(got) == _scenario_lines(want)
    assert len(_scenario_lines(got)) == 3
    res = json.loads(got.strip().splitlines()[-1])
    assert res["ok"] is True and res["ckpt_recover_steps"] == 3
    assert res["ckpt_save_ms_p50"] > 0


@pytest.mark.slow  # five training runs on a gloo world of 8 and the
# reference's on its 8-device mesh, as the reference marks its own
def test_ckpt_smoke_end_to_end():
    from tpu_p2p.obs.ckpt import run_ckpt_smoke as j_smoke

    proc = subprocess.run(
        [sys.executable, "-m", "tpu_p2p_torch", "obs", "ckpt-smoke",
         "--cpu-mesh", "8"], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = j_smoke(out=io.StringIO())
    lines = _scenario_lines(proc.stdout)
    assert len(lines) == 3
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["ok"] and want["ok"]
    assert res["ckpt_recover_steps"] == want["ckpt_recover_steps"] == 3
    assert "resumed_from=gen-000003 bitwise=True" in lines[0]
    assert "resumed_from=gen-000006 bitwise=True" in lines[1]
    assert "retries=3 fallbacks=0" in lines[2]


@pytest.mark.slow  # the heal + twin on a gloo world of 8, as the
# reference marks its own
def test_heal_composes_with_rotted_newest_generation(tmp_path):
    got = run_world(8, f"{WORLD}:heal_case",
                    {"cfg_kw": CFG, "ckpt_dir": str(tmp_path / "ck")},
                    timeout=600)[0]
    assert got["heal"] is not None
    assert got["heal"]["resume_step"] == 2
    assert got["heal"]["devices"] == 4
    assert got["ckpt_resume"]["generation"] == "gen-000002"
    assert got["ckpt_resume"]["skipped"][0]["generation"] == "gen-000004"
