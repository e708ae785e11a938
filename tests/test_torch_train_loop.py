"""The port's training loop (``tpu_p2p_torch/train.py``) with its
optimizers, evaluation, durable checkpoints, resume and crash
supervisor against the JAX reference's ``tpu_p2p/train.py``.

- AdamW + global-norm clipping + warmup/cosine + held-out evaluation on
  a world of one and on gloo worlds of 4 and 8 (dp × pp × sp, dp × tp
  with and without ZeRO, MoE over sp × tp × ep): losses and eval losses
  within relative 1e-4, leaves within 2e-4 (the mesh step's tolerances:
  float32 reassociation between XLA's and ATen's reductions).
- Resume: bitwise within the port (SGD, AdamW, the hygiene flags);
  across meshes 8 → 4 → 1 within the same tolerances; a reference
  checkpoint resumed by the port and the reverse; every refusal with
  the reference's message, word for word.
- The supervisor: the golden transcript of ``train --cpu-mesh 8
  --supervise`` after ``mask_floats``, its final loss within 1e-4 of
  the reference's, and the give-up past the restart budget.
"""

import io
import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh

from test_cli_golden import GOLDEN_DIR, SUMMARY_PATTERNS, mask_floats
from tpu_p2p import train as JT
from tpu_p2p.models import flagship as JF
from tpu_p2p.obs import faults as JFaults
from tpu_p2p_torch import train as TT
from tpu_p2p_torch.models import flagship as TF
from tpu_p2p_torch.obs import faults as TFaults
from tpu_p2p_torch.parallel.launch import run_world

REPO = pathlib.Path(__file__).resolve().parents[1]
WORLD = os.path.join(os.path.dirname(__file__), "torch_train_world.py")
LOSS_RTOL = 1e-4
LEAVES = dict(atol=2e-4, rtol=2e-4)
LM = dict(batch=4, seq=32, heads=4, kv_heads=2, head_dim=8, stages=2,
          microbatches=2, dense_ffn=True, rope=True, norm=True, vocab=64,
          use_flash=True)
MSE = dict(batch=4, seq=16, heads=4, kv_heads=2, head_dim=8, stages=2,
           microbatches=2, dense_ffn=True, rope=True, norm=True)
MOE = dict(batch=4, seq=32, heads=4, kv_heads=2, head_dim=8, stages=2,
           microbatches=2, num_experts=2, norm=True, vocab=64,
           use_flash=True)
HYGIENE = dict(lr=1e-2, optimizer="adamw", weight_decay=0.01, clip_norm=0.5,
               warmup_steps=1, schedule="cosine", eval_every=2,
               eval_batches=2)


def _ref(dims, cfg_kw, **run):
    """The reference's run_training on ``dims`` of the 8 CPU devices →
    (records, summary without params, params as float32 numpy)."""
    n = int(np.prod(dims))
    mesh = JMesh(np.array(jax.devices()[:n]).reshape(dims), JF.AXES)
    buf = io.StringIO()
    out = JT.run_training(mesh, JF.FlagshipConfig(**cfg_kw), log_every=1,
                          log_stream=buf, **run)
    params = {k: np.asarray(v).astype(np.float32)
              for k, v in out.pop("params").items()}
    return [json.loads(s) for s in buf.getvalue().splitlines()], out, params


def _port(cfg_kw, **run):
    """The port's run_training on a world of one (CPU)."""
    buf = io.StringIO()
    out = TT.run_training(TF.FlagshipConfig(**cfg_kw), log_every=1,
                          log_stream=buf, device="cpu", **run)
    params = {k: v.float().numpy() for k, v in out.pop("params").items()}
    return [json.loads(s) for s in buf.getvalue().splitlines()], out, params


def _assert_records_close(got, want):
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for g, w in zip(got, want):
        key = "loss" if "loss" in g else "eval_loss"
        np.testing.assert_allclose(g[key], w[key], rtol=LOSS_RTOL,
                                   err_msg=str(g))


def _assert_leaves_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **LEAVES)


def _copy_without(src, dst, *gens):
    shutil.copytree(src, dst)
    for g in gens:
        shutil.rmtree(os.path.join(dst, g))


# ------------------------------------------------------ world of one


@pytest.mark.parametrize("kw", [LM, MSE], ids=["lm", "mse"])
def test_run_training_matches_reference_on_a_world_of_one(kw):
    want = _ref((1, 1, 1, 1, 1), kw, steps=4, **HYGIENE)
    got = _port(kw, steps=4, **HYGIENE)
    _assert_records_close(got[0], want[0])
    assert [r["step"] for r in got[0] if "eval_loss" in r] == [2, 4]
    assert list(got[1]) == list(want[1])
    np.testing.assert_allclose(got[1]["final_loss"], want[1]["final_loss"],
                               rtol=LOSS_RTOL)
    _assert_leaves_close(got[2], want[2])


RESUME_FLAGS = {
    "sgd": dict(lr=5e-2),
    "adamw": dict(lr=1e-2, optimizer="adamw", weight_decay=0.01),
    "hygiene": dict(lr=5e-2, clip_norm=0.5, warmup_steps=2),
}


@pytest.mark.parametrize("name", sorted(RESUME_FLAGS))
def test_resume_is_bit_exact(tmp_path, name):
    flags = RESUME_FLAGS[name]
    full = _port(MSE, steps=4, **flags)
    ck = str(tmp_path / "ck")
    _port(MSE, steps=4, ckpt_dir=ck, ckpt_every=2, **flags)
    _copy_without(ck, str(tmp_path / "cut"), "gen-000004")
    resumed = _port(MSE, steps=4, ckpt_dir=str(tmp_path / "cut"),
                    resume=True, **flags)
    assert resumed[1]["start_step"] == 2 and resumed[1]["steps_run"] == 2
    assert resumed[1]["ckpt_resume"] == {"generation": "gen-000002",
                                         "step": 2, "skipped": []}
    assert resumed[1]["final_loss"] == full[1]["final_loss"]
    for k in full[2]:
        assert np.array_equal(resumed[2][k], full[2][k]), k
    has_opt = os.path.exists(str(tmp_path / "ck" / "gen-000004" /
                                 "opt_state.npz"))
    assert has_opt == (name != "sgd")
    done = _port(MSE, steps=4, ckpt_dir=ck, resume=True, **flags)
    assert done[1]["steps_run"] == 0 and done[1]["start_step"] == 4


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_each_side_resumes_the_others_checkpoint(tmp_path, direction):
    flags = dict(lr=1e-2, optimizer="adamw", weight_decay=0.01,
                 clip_norm=0.5, warmup_steps=1, schedule="cosine")
    one = (1, 1, 1, 1, 1)
    full = _ref(one, MSE, steps=4, **flags)
    ck = str(tmp_path / "ck")
    if direction == "reference_to_port":
        _ref(one, MSE, steps=4, ckpt_dir=ck, ckpt_every=2, **flags)
        _copy_without(ck, str(tmp_path / "cut"), "gen-000004")
        got = _port(MSE, steps=4, ckpt_dir=str(tmp_path / "cut"),
                    resume=True, **flags)
    else:
        _port(MSE, steps=4, ckpt_dir=ck, ckpt_every=2, **flags)
        _copy_without(ck, str(tmp_path / "cut"), "gen-000004")
        got = _ref(one, MSE, steps=4, ckpt_dir=str(tmp_path / "cut"),
                   resume=True, **flags)
    assert got[1]["start_step"] == 2
    assert got[1]["ckpt_resume"]["generation"] == "gen-000002"
    np.testing.assert_allclose(got[1]["final_loss"], full[1]["final_loss"],
                               rtol=LOSS_RTOL)
    _assert_leaves_close(got[2], full[2])


def _refusal(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


REFUSALS = {
    # name: (the checkpointing run's flags, the resuming run's)
    "config_keys": (dict(cfg=MOE), dict(cfg=LM)),
    "config_shape": (dict(cfg=LM), dict(cfg={**LM, "heads": 8})),
    "config_dtype": (dict(cfg=LM), dict(cfg={**LM, "dtype": "bfloat16"})),
    "adamw_from_sgd": (dict(cfg=LM), dict(cfg=LM, optimizer="adamw")),
    "sgd_from_optax": (dict(cfg=LM, optimizer="adamw"), dict(cfg=LM)),
    "cosine_horizon": (
        dict(cfg=LM, schedule="cosine", warmup_steps=1),
        dict(cfg=LM, schedule="cosine", warmup_steps=1, steps=6)),
    "cosine_lr": (dict(cfg=LM, schedule="cosine", warmup_steps=1),
                  dict(cfg=LM, schedule="cosine", warmup_steps=1, lr=1e-3)),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_resume_refusals_use_the_references_words(tmp_path, name):
    save, resume = (dict(d) for d in REFUSALS[name])
    ck = str(tmp_path / "ck")
    mesh = JF.build_mesh(1, devices=jax.devices()[:1])
    JT.run_training(mesh, JF.FlagshipConfig(**save.pop("cfg")), steps=4,
                    log_every=0, ckpt_dir=ck, ckpt_every=2,
                    **{"lr": 1e-2, **save})
    cfg = resume.pop("cfg")
    run = dict(steps=resume.pop("steps", 4), log_every=0, ckpt_dir=ck,
               resume=True, **{"lr": 1e-2, **resume})
    want = _refusal(lambda: JT.run_training(mesh, JF.FlagshipConfig(**cfg),
                                            **run))
    got = _refusal(lambda: TT.run_training(TF.FlagshipConfig(**cfg),
                                           device="cpu", **run))
    assert got == want


# ----------------------------------------------------- gloo worlds

W8 = (2, 2, 2, 1, 1)            # build_mesh(8)
W4 = (2, 1, 1, 2, 1)            # dp 2 x tp 2
MOE8 = (1, 1, 2, 2, 2)          # sp 2 x tp 2 x ep 2
CROSS = dict(lr=1e-2, optimizer="adamw", weight_decay=0.01, clip_norm=0.5,
             warmup_steps=1, schedule="cosine", steps=6, ckpt_every=2)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """One world of 8 and one of 4 (spawned once each), the cross-mesh
    chain 8 → 4 → 1 through their checkpoints, and the reference's runs
    of the same cases."""
    root = tmp_path_factory.mktemp("loop")
    d8, d4 = str(root / "d8"), str(root / "d4")
    got8 = run_world(8, f"{WORLD}:loop_case", {"cases": [
        dict(name="lm", dims=W8, cfg=LM, run=dict(steps=4, **HYGIENE)),
        dict(name="moe", dims=MOE8, cfg=MOE, run=dict(steps=4, **HYGIENE)),
        dict(name="cross8", dims=W8, cfg=MSE, run=dict(ckpt_dir=d8,
                                                       **CROSS)),
    ]}, timeout=400)
    _copy_without(d8, d4, "gen-000004", "gen-000006")
    broken = _broken_checkpoints(root)
    got4 = run_world(4, f"{WORLD}:loop_case", {"cases": [
        *(dict(name=f"broken_{k}", dims=W4, cfg=MSE, fails=True,
               run=dict(ckpt_dir=d, resume=True, **CROSS))
          for k, d in broken.items()),
        dict(name="mse", dims=W4, cfg=MSE, run=dict(steps=4, **HYGIENE)),
        dict(name="zero", dims=W4, cfg={**MSE, "zero_dp": True},
             run=dict(steps=4, **HYGIENE), moments=True),
        dict(name="cross4", dims=W4, cfg=MSE, run=dict(
            ckpt_dir=d4, resume=True, **CROSS)),
    ]}, timeout=400)
    d1 = str(root / "d1")
    _copy_without(d4, d1, "gen-000006")
    got1 = _port(MSE, ckpt_dir=d1, resume=True, **CROSS)
    want = {
        "lm": _ref(W8, LM, steps=4, **HYGIENE),
        "moe": _ref(MOE8, MOE, steps=4, **HYGIENE),
        "mse": _ref(W4, MSE, steps=4, **HYGIENE),
        "cross": _ref(W8, MSE, **{k: v for k, v in CROSS.items()
                                  if k != "ckpt_every"}),
    }
    return got8, got4, got1, want


def _broken_checkpoints(root) -> dict:
    """Checkpoint dirs whose load fails on the first rank: a flat
    ``params.npz`` without its meta (an OSError) and a generation with a
    torn manifest (the ladder's ValueError)."""
    flat, gen = root / "broken_flat", root / "broken_gen" / "gen-000002"
    flat.mkdir()
    (flat / "params.npz").write_bytes(b"")
    gen.mkdir(parents=True)
    (gen / "MANIFEST.json").write_text("{")
    return {"oserror": str(flat), "ladder": str(gen.parent)}


@pytest.mark.parametrize("kind,error", [
    ("oserror", ("FileNotFoundError", "OSError")),
    ("ladder", ("ValueError", "ValueError"))])
def test_a_failed_resume_load_raises_on_every_rank(worlds, kind, error):
    # The first rank runs the ladder; its failure reaches every rank (no
    # rank left waiting in the broadcast), and the world goes on to the
    # next cases.
    got = [rank[f"broken_{kind}"]["error"] for rank in worlds[1]]
    assert [g[0] for g in got] == [error[0]] + [error[1]] * 3
    assert len({g[1] for g in got}) == 1, got
    if kind == "ladder":
        assert "torn manifest" in got[0][1]


@pytest.mark.parametrize("world,name", [(8, "lm"), (8, "moe"), (4, "mse")],
                         ids=["w8_lm_dp2_pp2_sp2", "w8_moe_sp2_tp2_ep2",
                              "w4_mse_dp2_tp2"])
def test_loop_on_a_world_matches_reference(worlds, world, name):
    got = (worlds[0] if world == 8 else worlds[1])[0][name]
    want = worlds[3][name]
    _assert_records_close(got["records"], want[0])
    assert [r["step"] for r in got["records"] if "eval_loss" in r] == [2, 4]
    assert list(got["summary"]) == list(want[1])
    np.testing.assert_allclose(got["summary"]["final_loss"],
                               want[1]["final_loss"], rtol=LOSS_RTOL)
    _assert_leaves_close(got["params"], want[2])


def test_zero_moments_are_dp_shards_and_train_as_replicated(worlds):
    zero, mse = worlds[1][0]["zero"], worlds[1][0]["mse"]
    _assert_records_close(zero["records"], mse["records"])
    _assert_leaves_close(zero["params"], mse["params"])
    split = 0
    for rank in worlds[1]:
        for path, moment, shard in rank["zero"]["moments"]:
            assert moment == shard, path
        full = TF.flagship_param_shapes(TF.FlagshipConfig(**MSE))
        split += sum(shard != tuple(full[path.split("'")[1]])
                     for path, _, shard in rank["zero"]["moments"])
    assert split   # some moments are dp (or tp) shards of their leaf


def test_resume_across_meshes_8_to_4_to_1(worlds):
    got8, got4, got1 = worlds[0][0]["cross8"], worlds[1][0]["cross4"], \
        worlds[2]
    want = worlds[3]["cross"]
    assert got4["summary"]["start_step"] == 2
    assert got4["summary"]["ckpt_resume"]["generation"] == "gen-000002"
    assert got1[1]["start_step"] == 4
    assert got1[1]["ckpt_resume"]["generation"] == "gen-000004"
    for final in (got8["summary"]["final_loss"],
                  got4["summary"]["final_loss"], got1[1]["final_loss"]):
        np.testing.assert_allclose(final, want[1]["final_loss"],
                                   rtol=LOSS_RTOL)
    _assert_leaves_close(got1[2], want[2])
    _assert_leaves_close(got8["params"], want[2])


# ------------------------------------------------------ supervisor


def test_supervise_cli_matches_the_golden_and_the_reference(tmp_path):
    args = [a.replace("{TMP}", str(tmp_path))
            for a in SUMMARY_PATTERNS["train_supervise"]]
    assert args[:3] == ["train", "--cpu-mesh", "8"]
    proc = subprocess.run([sys.executable, "-m", "tpu_p2p_torch", *args],
                          capture_output=True, text=True, cwd=REPO,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(os.path.join(GOLDEN_DIR, "cli_train_supervise_8dev.txt")) as fh:
        assert mask_floats(proc.stdout) == fh.read()
    got = json.loads(proc.stdout.splitlines()[-1])["summary"]
    cfg = JF.FlagshipConfig(batch=8, seq=16, heads=4, head_dim=8, stages=2,
                            microbatches=2, num_experts=2)
    want = JT.run_training_supervised(
        JF.build_mesh(8), cfg, steps=6, log_every=0,
        ckpt_dir=str(tmp_path / "ref"), ckpt_every=2,
        fault_plan=JFaults.FaultPlan(ckpt_crash_after_bytes=512,
                                     start_step=4))
    np.testing.assert_allclose(got["final_loss"], want["final_loss"],
                               rtol=LOSS_RTOL)
    assert got["supervisor"] == want["supervisor"]


def test_supervisor_gives_up_past_the_restart_budget(tmp_path,
                                                     monkeypatch):
    # A crash loop (every save dies: the one-shot crash re-armed) fails
    # loudly after max_restarts.
    real = TFaults.ckpt_crash_budget
    monkeypatch.setattr(
        TFaults, "ckpt_crash_budget",
        lambda plan, step: (plan.ckpt_crash_after_bytes
                            if plan is not None and
                            plan.ckpt_crash_after_bytes is not None
                            else real(plan, step)))
    buf = io.StringIO()
    with pytest.raises(TFaults.SimulatedCrash):
        TT.run_training_supervised(
            TF.FlagshipConfig(**MSE), steps=4, log_every=0, device="cpu",
            ckpt_dir=str(tmp_path / "ck"), ckpt_every=2, log_stream=buf,
            fault_plan=TFaults.FaultPlan(ckpt_crash_after_bytes=8),
            max_restarts=2)
    lines = buf.getvalue().splitlines()
    assert lines.count("# supervise: no intact generation — restarting "
                       "from step 0 (2 step(s) to re-run)") == 3
    assert lines[-1] == ("# supervise: restart budget (2) exhausted — "
                         "giving up")


def test_supervisor_needs_checkpoints():
    cfg = TF.FlagshipConfig(**MSE)
    with pytest.raises(ValueError, match="ckpt_dir and ckpt_every"):
        TT.run_training_supervised(cfg, steps=2, device="cpu")
    with pytest.raises(ValueError, match="max_restarts"):
        TT.run_training_supervised(cfg, steps=2, device="cpu",
                                   ckpt_dir="x", ckpt_every=1,
                                   max_restarts=0)


def test_rotted_generation_resumes_from_the_one_before(tmp_path):
    # --fault-ckpt-corrupt-seed rots the step-4 generation as it
    # publishes; --resume then lands on gen-000002 with the reference's
    # reason, on either side's checkpoint.
    out = {}
    for side in ("port", "ref"):
        ck = str(tmp_path / side)
        if side == "port":
            TT.run_training(TF.FlagshipConfig(**MSE), steps=4, log_every=0,
                            device="cpu", ckpt_dir=ck, ckpt_every=2,
                            fault_plan=TFaults.FaultPlan(
                                ckpt_corrupt_seed=3, ckpt_io_errors=2,
                                start_step=4))
        else:
            JT.run_training(JF.build_mesh(1, devices=jax.devices()[:1]),
                            JF.FlagshipConfig(**MSE), steps=4, log_every=0,
                            ckpt_dir=ck, ckpt_every=2,
                            fault_plan=JFaults.FaultPlan(
                                ckpt_corrupt_seed=3, ckpt_io_errors=2,
                                start_step=4))
        res = TT.run_training(TF.FlagshipConfig(**MSE), steps=4,
                              log_every=0, device="cpu", ckpt_dir=ck,
                              resume=True)
        out[side] = res["ckpt_resume"]
    assert out["port"] == out["ref"] == {
        "generation": "gen-000002", "step": 2,
        "skipped": [{"generation": "gen-000004",
                     "reason": "checksum mismatch in params.npz"}]}


def test_non_storage_fault_plans_are_not_ported(tmp_path):
    # Ported: a lost-host plan on a world of one silences host 0's
    # heartbeats from its start step, and the monitor's verdict is the
    # reference's on its one-device mesh.
    recs = {}
    for side in ("port", "ref"):
        path = tmp_path / f"{side}.jsonl"
        kw = dict(steps=4, log_every=0, obs_jsonl=str(path))
        if side == "port":
            TT.run_training(TF.FlagshipConfig(**MSE), device="cpu",
                            fault_plan=TFaults.FaultPlan(lost_host=0,
                                                         start_step=1),
                            **kw)
        else:
            JT.run_training(JMesh(np.asarray(jax.devices()[:1]).reshape(
                1, 1, 1, 1, 1), JF.AXES), JF.FlagshipConfig(**MSE),
                fault_plan=JFaults.FaultPlan(lost_host=0, start_step=1),
                **kw)
        recs[side] = [json.loads(s) for s in path.read_text().splitlines()
                      if json.loads(s)["obs"] == "health"]
    assert recs["port"] == recs["ref"] != []


# -------------------------------------------------------------- CLI


def test_cli_trains_checkpoints_and_resumes(tmp_path, capsys):
    shape = ["--device", "cpu", "--batch", "4", "--seq", "16", "--heads",
             "4", "--kv-heads", "2", "--head-dim", "8", "--dense-ffn",
             "--log-every", "2", "--optimizer", "adamw", "--weight-decay",
             "0.01", "--clip-norm", "1.0", "--warmup-steps", "1",
             "--schedule", "cosine", "--eval-every", "2", "--eval-batches",
             "1", "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2",
             "--ckpt-keep", "1", "--steps", "4"]
    assert TT.main(shape + ["--fault-ckpt-io-errors", "2"]) == 0
    first = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [r["step"] for r in first[:-1]] == [2, 2, 4, 4]
    assert os.listdir(tmp_path / "ck") == ["gen-000004", "LATEST"] or \
        sorted(os.listdir(tmp_path / "ck")) == ["LATEST", "gen-000004"]
    assert TT.main(shape + ["--resume"]) == 0
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])["summary"]
    assert summary["start_step"] == 4 and summary["steps_run"] == 0
    assert summary["ckpt_resume"]["generation"] == "gen-000004"


def test_cli_supervise_with_heal_exits_as_the_reference():
    argv = ["--supervise", "--heal"]
    with pytest.raises(SystemExit) as t:
        TT.main(argv)
    with pytest.raises(SystemExit) as j:
        JT.main(argv)
    assert str(t.value) == str(j.value) and "pick one" in str(t.value)
