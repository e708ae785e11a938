"""The port's flagship step under the tick-IR executor
(``tpu_p2p_torch/models/flagship_1f1b.py``) against the reference's
``make_flagship_train_step_1f1b``, and the CLI that routes to it.

- One gloo world of 8 ranks (``tests/torch_schedule_world.py``) runs the
  step on dp 2 × pp 2 × sp 2 (MoE) and dp 4 × pp 2 (dense, norm, rope):
  the masked ``"1f1b"`` step (and the interleaved ``chunks=2`` one)
  within PR 10's 2e-4 a leaf and 1e-4 on the loss of the reference's
  masked step on its 8 CPU devices; zb and switch bitwise the port's
  own fused, masked step.
- The refusals are the reference's, word for word.
- The CLI: ``flagship_step --pp-schedule zb [--tick-lowering switch]``
  equals the goldens ``cli_flagship_zb{,_switch}_8dev.txt`` after
  ``mask_floats``; ``zb`` equals ``cli_zb_8dev.txt`` line for line after
  masking with ``loss_bitwise: true``. Its ``ok`` is a wall-clock grade
  on a CPU gloo world, so it is held to the printed ratio by the smoke's
  own rule (a strict win at pp > 1) rather than to the golden's literal
  ``true``.
"""

import json
import os
import re
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from conftest import parity_mesh
from test_cli_golden import GOLDEN_DIR, SUMMARY_PATTERNS, mask_floats
from tpu_p2p.models import flagship as JF
from tpu_p2p_torch.models import flagship as TF
from tpu_p2p_torch.parallel.launch import run_world

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WORLD = os.path.join(os.path.dirname(__file__), "torch_schedule_world.py")
LEAF = dict(atol=2e-4, rtol=2e-4)
LOSS_RTOL = 1e-4
AXES = ("dp", "pp", "sp", "tp", "ep")
MOE = dict(batch=8, seq=16, heads=4, head_dim=8, stages=2, microbatches=2,
           num_experts=4, capacity_factor=8.0)
DENSE = dict(batch=8, seq=16, heads=4, kv_heads=2, head_dim=8, stages=2,
             microbatches=2, dense_ffn=True, norm=True, rope=True)
SP = (2, 2, 2, 1, 1)
DP = (4, 2, 1, 1, 1)

CASES = [
    dict(name="sp-1f1b", dims=SP, cfg=MOE),
    dict(name="sp-zb", dims=SP, cfg={**MOE, "pp_schedule": "zb"}),
    dict(name="dp-1f1b", dims=DP, cfg=DENSE),
    dict(name="dp-1f1b-switch", dims=DP,
         cfg={**DENSE, "tick_lowering": "switch"}),
    dict(name="dp-zb", dims=DP, cfg={**DENSE, "pp_schedule": "zb"}),
    dict(name="dp-zb-switch", dims=DP,
         cfg={**DENSE, "pp_schedule": "zb", "tick_lowering": "switch"}),
    dict(name="dp-interleaved", dims=DP, cfg={**DENSE, "stages": 4},
         chunks=2),
]
CLI = {"flagship_zb": 8, "flagship_zb_switch": 8, "zb": 8}


def _cli(name):
    proc = None
    for _ in range(2):
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_p2p_torch", *SUMMARY_PATTERNS[name]],
            capture_output=True, text=True, cwd=REPO, timeout=600)
        # The smoke times one step as the slope of two chains (one
        # repeat at the golden's size); on a loaded host that slope can
        # come out non-positive, which the smoke (as the reference's)
        # refuses to grade: time it once more, and only then.
        if "slope was not positive" not in proc.stderr:
            break
    return proc


@pytest.fixture(scope="module")
def runs():
    """The 8-rank world's step cases and the three CLI runs, at once."""
    with ThreadPoolExecutor(2) as pool:
        world = pool.submit(run_world, 8, f"{WORLD}:flagship_case",
                            {"cases": CASES})
        clis = {name: pool.submit(_cli, name) for name in CLI}
        return world.result()[0], {k: f.result() for k, f in clis.items()}


def _reference(dims, cfg_kw, chunks=1):
    """The reference's masked step on ``dims`` of its CPU devices → (loss,
    stage-major float32 params)."""
    mesh = parity_mesh(AXES, dims)
    cfg = JF.FlagshipConfig(**cfg_kw)
    params = JF.place_flagship_params_pipelined(
        JF.init_flagship_params(cfg), mesh, cfg, chunks)
    x, t = JF.flagship_example_batch(cfg, mesh)
    new, loss = JF.make_flagship_train_step_1f1b(mesh, cfg, lr=1e-2,
                                                 chunks=chunks)(params, x, t)
    host = JF.unplace_flagship_params_pipelined(new, mesh, cfg, chunks)
    return float(loss), {k: np.asarray(v, np.float32)
                         for k, v in host.items()}


@pytest.mark.parametrize("name", ["sp-1f1b", "dp-1f1b", "dp-interleaved"])
def test_masked_step_matches_the_reference(runs, name):
    case = next(c for c in CASES if c["name"] == name)
    loss, params = _reference(case["dims"], case["cfg"],
                              case.get("chunks", 1))
    got = runs[0][name]
    np.testing.assert_allclose(got["loss"], loss, rtol=LOSS_RTOL)
    assert sorted(got["params"]) == sorted(params)
    for k in params:
        np.testing.assert_allclose(got["params"][k], params[k], err_msg=k,
                                   **LEAF)


@pytest.mark.parametrize("name,fused", [
    ("sp-zb", "sp-1f1b"), ("dp-zb", "dp-1f1b"),
    ("dp-1f1b-switch", "dp-1f1b"), ("dp-zb-switch", "dp-1f1b")])
def test_zb_and_switch_are_bitwise_the_fused_masked_step(runs, name, fused):
    got, want = runs[0][name], runs[0][fused]
    assert got["loss"] == want["loss"]
    for k in want["params"]:
        np.testing.assert_array_equal(got["params"][k], want["params"][k],
                                      err_msg=k)


# ------------------------------------------------------------- refusals


class _Line:
    def __init__(self, size):
        self.size, self.index = size, 0


def _stub_mesh(dims):
    """Only the axes' sizes: every refusal comes before any group."""
    return types.SimpleNamespace(
        axis_names=AXES, shape=dict(zip(AXES, dims)),
        line=lambda a: _Line(dict(zip(AXES, dims))[a]))


@pytest.mark.parametrize("dims,cfg_kw,chunks", [
    ((1, 2, 1, 1, 1), dict(MOE, pp_schedule="zb"), 2),
    ((2, 2, 1, 1, 1), dict(MOE, zero_dp=True), 1),
    ((1, 2, 1, 1, 1), dict(MOE, vocab=64), 1),
    ((1, 2, 2, 1, 1), dict(MOE, tick_lowering="switch"), 1),
    ((1, 2, 1, 1, 2), dict(MOE, tick_lowering="switch"), 1),
    ((1, 2, 1, 2, 1), dict(DENSE, tick_lowering="switch",
                           tp_overlap="ring"), 1),
    ((1, 2, 2, 1, 2), dict(MOE, tick_lowering="switch"), 1),
    ((1, 2, 1, 1, 1), dict(MOE, stages=3), 1),
], ids=["zb_chunks", "zero_dp", "vocab", "switch_sp", "switch_ep",
        "switch_tp_ring", "switch_all", "stages"])
def test_refusals_equal_the_reference(dims, cfg_kw, chunks):
    with pytest.raises(ValueError) as want:
        JF.make_flagship_train_step_1f1b(parity_mesh(AXES, dims),
                                         JF.FlagshipConfig(**cfg_kw),
                                         chunks=chunks)
    with pytest.raises(ValueError) as got:
        TF.make_flagship_train_step_1f1b(_stub_mesh(dims),
                                         TF.FlagshipConfig(**cfg_kw),
                                         chunks=chunks)
    assert str(got.value) == str(want.value)
    if cfg_kw.get("vocab"):
        with pytest.raises(ValueError) as want:
            JF.place_flagship_params_pipelined(
                {}, parity_mesh(AXES, dims), JF.FlagshipConfig(**cfg_kw))
        with pytest.raises(ValueError) as got:
            TF.place_flagship_params_pipelined(
                {}, _stub_mesh(dims), TF.FlagshipConfig(**cfg_kw))
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name,bad", [("pp_schedule", "ZB"),
                                      ("tick_lowering", "select")])
def test_schedule_knobs_are_validated_as_the_reference(name, bad):
    with pytest.raises(ValueError) as got:
        TF.FlagshipConfig(**{name: bad})
    with pytest.raises(ValueError) as want:
        JF.FlagshipConfig(**{name: bad})
    assert str(got.value) == str(want.value)
    for ok in {"pp_schedule": ("1f1b", "zb"),
               "tick_lowering": ("masked", "switch")}[name]:
        assert getattr(TF.FlagshipConfig(**{name: ok}), name) == ok


# ------------------------------------------------------------------ CLI


@pytest.mark.parametrize("name", ["flagship_zb", "flagship_zb_switch"])
def test_flagship_step_cli_matches_the_golden(runs, name):
    proc = runs[1][name]
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(os.path.join(GOLDEN_DIR, f"cli_{name}_8dev.txt")) as fh:
        assert mask_floats(proc.stdout) == fh.read()


def test_zb_smoke_cli_matches_the_golden(runs):
    proc = runs[1]["zb"]
    with open(os.path.join(GOLDEN_DIR, "cli_zb_8dev.txt")) as fh:
        want = fh.read().splitlines()
    got = proc.stdout.splitlines()
    assert [mask_floats(s) for s in got[:-1]] == want[:-1]
    res = json.loads(got[-1])
    assert res["loss_bitwise"] is True and res["zb_devices"] == 8
    # ok is the smoke's own grade of its printed numbers.
    assert res["ok"] == (res["pp_step_ms_zb"] < res["pp_step_ms_fused"])
    assert res["pp_zb_vs_fused_ratio"] == round(
        res["pp_step_ms_zb"] / res["pp_step_ms_fused"], 4)
    assert proc.returncode == (0 if res["ok"] else 1), proc.stderr[-3000:]
    masked = re.sub(r'"ok": (true|false)', '"ok": true',
                    mask_floats(got[-1]))
    assert masked == want[-1]
    fused, zb = (re.search(r"loss (\S+)$", got[i]).group(1) for i in (1, 2))
    assert fused == zb
