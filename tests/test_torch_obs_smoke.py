"""The health smoke's detection latency, held to the reference's on the
same world.

The port's ranks are processes: a rank that sleeps after its step's
collectives is seen by its peers one step late, in the next step's
collectives, where the reference's one controller sees the slow step at
once. The sleep now lands at the start of the step span, before the
collectives, so the first rank's monitor sees the straggler in the same
step as the reference's, and ``detect_steps`` agree (2 for the
straggler on the reference's consecutive-2 detector).

- tier 1: the straggler scenario on a gloo world of 4 against the
  reference's loop on its 4-device CPU mesh, the same plan;
- ``slow``, as the reference marks its own smoke: the whole ``obs smoke
  --cpu-mesh 8`` of both programs, each scenario's ``detect_steps`` and
  the heal's loss delta.
"""

import json
import os
import re
import subprocess
import sys
import tempfile

import jax
import pytest

from tpu_p2p.models import flagship as JF
from tpu_p2p.obs import faults as JFaults
from tpu_p2p.obs import health as JH
from tpu_p2p.train import run_training as j_run_training
from tpu_p2p_torch.parallel.launch import run_world

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORLD = os.path.join(HERE, "torch_smoke_world.py")
CFG = dict(batch=8, seq=32, heads=4, head_dim=8, stages=2, microbatches=2,
           num_experts=2, capacity_factor=4.0, norm=True)
START = 2 + JH.HealthConfig.straggler_min_samples + 1
STEPS = START + 3
# Well above a step's wall-clock spread on a host loaded by other test
# workers (at 400 ms a loaded host's median/MAD window sometimes hides
# the first slow step), so the pin reads the step the straggler lands in.
SLOW_MS = 1000.0


def _reference_verdicts():
    mesh = JF.build_mesh(4, devices=jax.devices()[:4])
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "obs.jsonl")
        j_run_training(mesh, JF.FlagshipConfig(**CFG), steps=STEPS,
                       lr=1e-2, log_every=0, obs_jsonl=path,
                       fault_plan=JFaults.FaultPlan(
                           slow_rank=1, slow_ms=SLOW_MS,
                           start_step=START))
        with open(path) as fh:
            recs = [json.loads(line) for line in fh if line.strip()]
    return [r["step"] for r in recs if r.get("verdict") == "straggler"]


def test_straggler_detect_steps_equal_the_reference():
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as pool:  # the world runs beside the
        # reference's in-process loop
        world = pool.submit(
            run_world, 4, f"{WORLD}:straggler_case",
            {"cfg_kw": {**CFG, "dtype": "float32"}, "steps": STEPS,
             "start": START, "slow_ms": SLOW_MS}, timeout=300)
        want = _reference_verdicts()
        got = world.result()[0]
    # A verdict before the onset is wall-clock noise on a loaded host
    # (the smoke filters it alike); the first one at or after it is the
    # detection.
    k_got = [s - START + 1 for s in got if s >= START][:1]
    k_want = [s - START + 1 for s in want if s >= START][:1]
    assert k_got == k_want == [2]


def _detect_steps(stdout):
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"# smoke (\w+): detected=True.*?detect_steps=(\d+)", stdout)}


@pytest.mark.slow  # both whole smokes, as the reference marks its own
def test_obs_smoke_detect_steps_equal_the_reference():
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, "-m", pkg, "obs", "smoke", "--cpu-mesh", "8"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env) for pkg in ("tpu_p2p_torch", "tpu_p2p")]
    (got, got_err), (want, _) = (p.communicate(timeout=900) for p in procs)
    assert procs[0].returncode == 0, got_err[-3000:]
    assert _detect_steps(got) == _detect_steps(want) == {
        "straggler": 2, "lost_host": 2}
    g = json.loads(got.strip().splitlines()[-1])
    w = json.loads(want.strip().splitlines()[-1])
    assert g["health_detect_steps"] == w["health_detect_steps"] == 2
    assert g["heal_resume_loss_delta"] == w["heal_resume_loss_delta"]
