"""The port's model patterns on the CLI against the reference CLI's own
output on the same command: ``ring_attention`` (plain, ``--flash``,
``--attn-window``), ``ulysses_attention`` (on a line of 4, on the first
axis of ``--mesh-shape 4x2``, and on 3 ranks, where the default heads
become 9), ``flagship_step --dtype float32`` (plain and ``--zero-dp
--overlap prefetch``), the ``--jsonl`` records' integer and string
fields, and the Ulysses divisibility error. Beneath the CLI: the QKV
staging is bitwise the reference's, and the attention builders'
outputs on those inputs match the reference's builders.

The port runs as ``python -m tpu_p2p_torch --cpu-mesh N`` subprocesses
(gloo worlds), two at a time; the reference runs in this process on its
CPU devices through ``tpu_p2p.cli.main``. Floats are masked as
``tests/test_torch_collectives_cli.py`` masks them.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from test_torch_collectives_cli import _masked
from tpu_p2p import cli as JCLI
from tpu_p2p.config import BenchConfig as JBenchConfig
from tpu_p2p.models.ring_transformer import ModelConfig as JModelConfig
from tpu_p2p.ops import attention as JA
from tpu_p2p.ops import ulysses as JU
from tpu_p2p.workloads.base import WorkloadContext as JContext
from tpu_p2p.workloads.ulysses_attn import run_ulysses_attention as j_ulysses
from tpu_p2p_torch.config import BenchConfig as TBenchConfig
from tpu_p2p_torch.models.ring_transformer import ModelConfig as TModelConfig
from tpu_p2p_torch.parallel.launch import run_world
from tpu_p2p_torch.parallel.runtime import Mesh as TMesh
from tpu_p2p_torch.workloads.base import WorkloadContext as TContext
from tpu_p2p_torch.workloads.sp_common import stage_qkv
from tpu_p2p_torch.workloads.ulysses_attn import \
    run_ulysses_attention as t_ulysses

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WORLD = os.path.join(os.path.dirname(__file__),
                     "torch_ring_transformer_world.py")
FOUR = ["--num-devices", "4", "--iters", "2"]
JSONL = ["--jsonl", "{TMP}/cells.jsonl"]
FLAGSHIP = ["--pattern", "flagship_step", "--dtype", "float32", *FOUR]

# name → (world size, arguments, the reference's arguments when they
# differ). The reference runs on its first N CPU devices.
RUNS = {
    "ring": (4, ["--pattern", "ring_attention", *FOUR, *JSONL]),
    "ring_flash": (4, ["--pattern", "ring_attention", "--flash", *FOUR]),
    "ring_window": (4, ["--pattern", "ring_attention", "--attn-window",
                        "8", *FOUR, *JSONL]),
    "ulysses": (4, ["--pattern", "ulysses_attention", *FOUR, *JSONL]),
    "ulysses_4x2": (8, ["--pattern", "ulysses_attention", "--mesh-shape",
                        "4x2", "--iters", "1"]),
    "ulysses_3": (3, ["--pattern", "ulysses_attention", "--num-devices",
                      "3", "--iters", "1"]),
    "flagship": (4, [*FLAGSHIP, *JSONL]),
    # The reference's prefetch step does not trace on a five-axis mesh
    # with axes of size 1 (ROADMAP.md queue 3); its line carries neither
    # knob, so the port's prefetch run prints the reference's --zero-dp
    # line.
    "flagship_zero_prefetch": (4, [*FLAGSHIP, "--zero-dp", "--overlap",
                                   "prefetch", *JSONL],
                               [*FLAGSHIP, "--zero-dp", *JSONL]),
}


def _port(n, args, tmp):
    args = [a.replace("{TMP}", tmp) for a in args]
    return subprocess.run(
        [sys.executable, "-m", "tpu_p2p_torch", "--cpu-mesh", str(n),
         *args], capture_output=True, text=True, cwd=REPO, timeout=300)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every port command of this file, two at a time → name →
    (CompletedProcess, its scratch directory)."""
    dirs = {name: str(tmp_path_factory.mktemp(name)) for name in RUNS}
    with ThreadPoolExecutor(2) as pool:
        futs = {name: pool.submit(_port, run[0], run[1], dirs[name])
                for name, run in RUNS.items()}
        return {name: (f.result(), dirs[name]) for name, f in futs.items()}


def _reference(name, tmp):
    """The reference CLI on ``name``'s command → (exit code, stdout,
    its JSONL records)."""
    run = RUNS[name]
    ref_dir = os.path.join(tmp, "ref")
    os.makedirs(ref_dir, exist_ok=True)
    args = [a.replace("{TMP}", ref_dir) for a in run[-1]]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = JCLI.main(args)
    return rc, buf.getvalue(), _records(ref_dir)


def _records(tmp):
    path = os.path.join(tmp, "cells.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def _exact_fields(rec):
    """A record's integer, string, boolean and null fields (the floats
    are measurements)."""
    return {k: v for k, v in rec.items() if not isinstance(v, float)}


@pytest.mark.parametrize("name", list(RUNS))
def test_cli_output_equals_the_reference_cli(port, name):
    proc, tmp = port[name]
    assert proc.returncode == 0, proc.stderr[-3000:]
    rc, want, ref_records = _reference(name, tmp)
    assert rc == 0
    assert _masked(proc.stdout) == _masked(want)
    got = _records(tmp)
    assert [_exact_fields(r) for r in got] \
        == [_exact_fields(r) for r in ref_records]
    assert [sorted(r) for r in got] == [sorted(r) for r in ref_records]


def test_windowed_ring_drops_its_dead_hops(port):
    out = port["ring_window"][0].stdout
    assert "W8 over 4 devices" in out and "x 1 hops" in out
    (rec,) = _records(port["ring_window"][1])
    assert rec["ring_hops"] == 1 and rec["attn_window"] == 8


def test_ulysses_default_heads_follow_the_axis(port):
    assert "H9 T576" in port["ulysses_3"][0].stdout
    assert "over 4 devices" in port["ulysses_4x2"][0].stdout


def test_ulysses_divisibility_error_equals_the_references():
    jctx = JContext(rt=SimpleNamespace(mesh=Mesh(
        np.array(jax.devices()[:4]), ("d",))),
        cfg=JBenchConfig(pattern="ulysses_attention"))
    mesh = TMesh(ranks=(0, 1, 2, 3), rank=0, device=torch.device("cpu"),
                 host_group=None)
    tctx = TContext(rt=SimpleNamespace(mesh=mesh),
                    cfg=TBenchConfig(pattern="ulysses_attention"))
    errors = []
    for run, ctx, mc in ((j_ulysses, jctx, JModelConfig(heads=6)),
                         (t_ulysses, tctx, TModelConfig(heads=6))):
        with pytest.raises(ValueError) as e:
            run(ctx, mc)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert "needs heads (6) divisible by the sharded axis size (4)" \
        in errors[1]


# The staging and the builders on a line of 4 (seed 0, the benchmark's
# default), at a small width; outputs at the reference's 2e-5.
SP_CFG = dict(batch=2, seq=64, heads=4, head_dim=16)
SP_CASES = [("ring", "ring", False, None), ("ring_flash", "ring", True, None),
            ("ring_flash_w8", "ring", True, 8),
            ("ulysses", "ulysses", False, None),
            ("ulysses_flash", "ulysses", True, None)]
SP_TOL = dict(atol=2e-5, rtol=2e-5)


def _jline():
    return Mesh(np.array(jax.devices()[:4]), ("d",))


def _reference_qkv(dtype):
    """The reference's staging (``tpu_p2p/workloads/sp_common.py``):
    three draws cast through numpy, placed under its
    ``attention_sharding`` on a line of 4 → the global arrays."""
    mesh, mc = _jline(), JModelConfig(**SP_CFG, dtype=dtype)
    rng = np.random.default_rng(0)
    shape = (mc.batch, mc.heads, mc.seq, mc.head_dim)
    return [jax.device_put(np.asarray(rng.standard_normal(shape),
                                      dtype=mc.dtype),
                           JA.attention_sharding(mesh, "d"))
            for _ in range(3)]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qkv_staging_is_the_references_bitwise(dtype):
    ref = _reference_qkv(dtype)
    devices = list(jax.devices()[:4])
    mc = TModelConfig(**SP_CFG, dtype=dtype)
    for r in range(4):
        mesh = TMesh(ranks=(0, 1, 2, 3), rank=r,
                     device=torch.device("cpu"), host_group=None)
        ours = stage_qkv(mc, 0, mesh, "d", "cpu")
        for name, got, arr in zip("qkv", ours, ref):
            (shard,) = [s for s in arr.addressable_shards
                        if s.device == devices[r]]
            want = _bits(shard.data)
            got = (got.view(torch.int16) if dtype == "bfloat16"
                   else got).numpy()
            assert got.shape == want.shape and np.array_equal(got, want), \
                (name, r)


@pytest.fixture(scope="module")
def sp_world():
    return run_world(4, f"{WORLD}:sp_attention_case",
                     {"cfg": {**SP_CFG, "dtype": "float32"}, "seed": 0,
                      "cases": SP_CASES}, timeout=300)


@pytest.mark.parametrize("case", SP_CASES, ids=lambda c: c[0])
def test_sp_attention_matches_the_reference_builders(sp_world, case):
    name, builder, flash, window = case
    build = {"ring": JA.ring_attention, "ulysses": JU.ulysses_attention}
    fn = build[builder](_jline(), "d", True, use_flash=flash, window=window)
    want = np.asarray(fn(*_reference_qkv("float32")))
    t = want.shape[2] // 4
    for res in sp_world:
        i = res["index"]
        np.testing.assert_allclose(res[name], want[:, :, i * t:(i + 1) * t],
                                   err_msg=f"{name} rank {i}", **SP_TOL)
