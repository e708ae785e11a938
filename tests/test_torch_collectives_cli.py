"""The port's CLI on the new patterns against the reference: the
``torus2d`` and ``allreduce`` goldens, ``ring``, ``all_to_all``,
``reduce_scatter`` and ``all_gather`` against the reference CLI's own
output on the same command (in the serialized, fused, differential and
device modes), ``--mode device`` on ``latency`` with its records'
``source``, ``--validate-timing``, ``--profile-dir``, the float32
``--check`` outcome, ``flagship_step``'s overlap knobs against their
goldens, and the flags that still exit 2.

The port runs as ``python -m tpu_p2p_torch --cpu-mesh N`` subprocesses
(gloo worlds), a few at a time; the reference runs in this process on
its CPU devices through ``tpu_p2p.cli.main``. Floats are masked as the
reference's golden tests mask them (against the reference's live output,
with a field's padding collapsed too).
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

from test_cli_golden import GOLDEN_DIR, SUMMARY_PATTERNS, mask_floats
from tpu_p2p import cli as JCLI
from tpu_p2p_torch import cli as TCLI

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SMALL = ["--iters", "2", "--msg-size", "64KiB"]
# Host slopes on a loaded CPU: 16 ops between the chains, the median of
# 5 repeats, so the slope is a number on both sides.
SLOPE = ["--iters", "16", "--fused-repeats", "5", "--msg-size", "64KiB"]
FOUR = ["--num-devices", "4"]

# name → (world size, arguments). The reference side runs the same
# arguments on its CPU devices (``--num-devices`` picks the first 4);
# the goldens were taken on 8.
PORT_RUNS = {
    "torus2d": (8, SUMMARY_PATTERNS["torus2d"][2:]),
    "allreduce": (8, SUMMARY_PATTERNS["allreduce"][2:]),
    "ring": (4, ["--pattern", "ring", "--check", "--mode", "fused",
                 *FOUR, *SMALL]),
    "all_to_all": (4, ["--pattern", "all_to_all", "--check", *FOUR,
                       *SMALL]),
    "reduce_scatter": (4, ["--pattern", "reduce_scatter", "--check",
                           "--mode", "differential", *FOUR, *SLOPE]),
    "all_gather": (4, ["--pattern", "all_gather", "--check", "--mode",
                       "device", *FOUR, *SLOPE]),
    "validate": (4, ["--pattern", "ring", "--validate-timing", *FOUR,
                     *SMALL]),
    "latency_device": (2, ["--pattern", "latency", "--mode", "device",
                           "--iters", "32", "--fused-repeats", "5",
                           "--jsonl", "{TMP}/cells.jsonl"]),
    "profile": (2, ["--pattern", "ring", "--profile-dir", "{TMP}/prof",
                    *SMALL]),
    "float32": (2, ["--pattern", "allreduce", "--check", "--dtype",
                    "float32", *SMALL]),
    "torus_flat": (2, ["--pattern", "torus2d", *SMALL]),
    # The overlap knobs on flagship_step (build_mesh(8): dp 2 x pp 2 x sp
    # 2, so the wave runs and the tp and ep rings degrade at size 1).
    **{f"flagship_{name}": (8, SUMMARY_PATTERNS[f"flagship_{name}"][2:])
       for name in ("tp_ring", "ep_ring", "pp_wave")},
}


def _port(n, args, tmp):
    args = [a.replace("{TMP}", tmp) for a in args]
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_p2p_torch", "--cpu-mesh", str(n),
         *args], capture_output=True, text=True, cwd=REPO, timeout=300)
    return proc


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every port command of this file, two at a time → name →
    (CompletedProcess, its scratch directory)."""
    dirs = {name: str(tmp_path_factory.mktemp(name)) for name in PORT_RUNS}
    with ThreadPoolExecutor(2) as pool:
        futs = {name: pool.submit(_port, n, args, dirs[name])
                for name, (n, args) in PORT_RUNS.items()}
        return {name: (f.result(), dirs[name]) for name, f in futs.items()}


def _reference(args, tmp=""):
    """The reference CLI in this process (8 CPU devices) → (exit code,
    stdout)."""
    args = [a.replace("{TMP}", tmp) for a in args]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = JCLI.main(args)
    return rc, buf.getvalue()


def _masked(text):
    """``mask_floats``, then runs of spaces as one: a ``%6.02f`` field's
    padding follows the masked magnitude (the gloo world's and the JAX
    CPU mesh's speeds differ by orders). A host slope that came out
    non-positive prints ``nan`` (or a negative p50): on a loaded host the
    reference's in-process slope of 14 microsecond-scale ops does, so
    those tokens mask like any other timing magnitude."""
    text = re.sub(r"-?\b(?:nan|inf)(?=us\b|\b)", "0.0", text)
    text = re.sub(r"-(?=\d+\.\d+)", "", text)
    return re.sub(r" +", " ", mask_floats(text))


def _ok(port, name):
    proc, tmp = port[name]
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout, tmp


@pytest.mark.parametrize("name", ["torus2d", "allreduce",
                                  "flagship_tp_ring", "flagship_ep_ring",
                                  "flagship_pp_wave"])
def test_cli_output_equals_the_reference_golden(port, name):
    out, _ = _ok(port, name)
    with open(os.path.join(GOLDEN_DIR, f"cli_{name}_8dev.txt")) as fh:
        assert mask_floats(out) == fh.read()


@pytest.mark.parametrize("name", ["ring", "all_to_all", "reduce_scatter",
                                  "all_gather", "validate"])
def test_cli_output_equals_the_reference_cli(port, name):
    out, _ = _ok(port, name)
    rc, want = _reference(PORT_RUNS[name][1])
    assert rc == 0
    assert _masked(out) == _masked(want)


def test_latency_device_mode_and_its_records_equal_the_reference(port):
    out, tmp = _ok(port, "latency_device")
    with open(os.path.join(tmp, "cells.jsonl")) as fh:
        got = [json.loads(line) for line in fh]
    ref_dir = os.path.join(tmp, "ref")
    os.makedirs(ref_dir)
    rc, want = _reference(PORT_RUNS["latency_device"][1], ref_dir)
    assert rc == 0 and _masked(out) == _masked(want)
    assert "(host_differential)" in out
    with open(os.path.join(ref_dir, "cells.jsonl")) as fh:
        ref = [json.loads(line) for line in fh]
    assert [r["source"] for r in got] == [r["source"] for r in ref] \
        == ["host_differential"]
    assert [sorted(r) for r in got] == [sorted(r) for r in ref]


def test_profile_dir_writes_a_trace_a_rank(port):
    out, tmp = _ok(port, "profile")
    assert out.startswith("ring shift-by-1 64KiB serialized:")
    for rank in (0, 1):
        with open(os.path.join(tmp, "prof", f"rank{rank}.trace.json")) as fh:
            events = json.load(fh)["traceEvents"]
        assert any(e.get("cat") == "cpu_op" for e in events)


def test_float32_check_fails_like_the_reference(port):
    # A float payload is random bit patterns: its rows hold NaNs, so the
    # sum can never equal the oracle bitwise, in any summation order.
    proc, _ = port["float32"]
    assert proc.returncode == 1
    want = "Failed: BackendError 'payload verification failed for " \
           "allreduce at 65536B'"
    assert want in proc.stderr
    rc = _reference(PORT_RUNS["float32"][1])[0]
    assert rc == 1


@pytest.mark.parametrize("argv", [
    ["--hybrid"],
    ["--pattern", "flagship_step", "--pp-schedule", "zb"],
    ["--pattern", "flagship_step", "--tick-lowering", "switch"],
])
def test_still_unported_flags_exit_2(argv, capsys, tmp_path):
    if argv == ["--hybrid"]:
        assert TCLI.main(["--cpu-mesh", "2", *argv]) == 2
        assert "not ported yet" in capsys.readouterr().err
        return
    # The schedule knobs are ported: the step runs on the tick-IR
    # executor and the line carries the knob, as the reference's does
    # (build_mesh(2) is sp 2; switch folds it onto dp).
    proc = _port(2, [*argv, "--iters", "1"], str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = proc.stdout.splitlines()[-1]
    if "--pp-schedule" in argv:
        assert line.startswith("flagship_step mesh {'dp': 1, 'pp': 1, "
                               "'sp': 2, 'tp': 1, 'ep': 1} ring-SP")
        assert " pp_schedule=zb: p50 " in line
    else:
        assert line.startswith("flagship_step mesh {'dp': 2, 'pp': 1, "
                               "'sp': 1, 'tp': 1, 'ep': 1} ring-SP")
        assert " tick_lowering=switch: p50 " in line


def test_bad_mesh_shape_exits_like_the_reference():
    for cli in (TCLI, JCLI):
        with pytest.raises(SystemExit,
                           match="--mesh-shape must look like 4x2"):
            cli.main(["--mesh-shape", "4by2"])


def test_torus2d_on_a_flat_mesh_fails_like_the_reference(port, capsys):
    want = "torus2d needs a 2-axis mesh, got axes ('d',)"
    assert JCLI.main(PORT_RUNS["torus_flat"][1]) == 1
    assert want in capsys.readouterr().err
    proc, _ = port["torus_flat"]
    assert proc.returncode == 1 and want in proc.stderr
