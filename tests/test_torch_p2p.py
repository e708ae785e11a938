"""The port's benchmark path against the JAX reference: config parsing,
report text, placement, the permutation tables, payload bytes, the
timing arithmetic, arrivals on a gloo world of 8, and the CLI goldens.

Every comparison is exact: this path moves bytes, and the timing math is
compared in float64. The world-of-8 arrivals come from spawned gloo
ranks that import only torch and the port
(``tests/test_torch_p2p_world.py``); this process computes the reference
values with the JAX package on its 8-device CPU mesh, the Pallas kernel
in interpret mode, as ``tests/test_pallas_dma.py`` runs it.
"""

import io
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from test_cli_golden import ARGS, GOLDEN_DIR, SUMMARY_PATTERNS, mask, \
    mask_floats
from test_torch_p2p_world import EDGE_SETS_8, float_payload
from tpu_p2p import config as JC
from tpu_p2p.parallel import collectives as JCOL
from tpu_p2p.parallel import pallas_dma as JPD
from tpu_p2p.parallel import topology as JT
from tpu_p2p.utils import report as JREP
from tpu_p2p.utils import timing as JTIM
from tpu_p2p.utils.errors import PlacementError as JPlacementError
from tpu_p2p_torch import config as TC
from tpu_p2p_torch.parallel import collectives as TCOL
from tpu_p2p_torch.parallel import pallas_dma as TPD
from tpu_p2p_torch.parallel import topology as TT
from tpu_p2p_torch.parallel.launch import run_world
from tpu_p2p_torch.utils import report as TREP
from tpu_p2p_torch.utils import timing as TTIM
from tpu_p2p_torch.utils.errors import PlacementError as TPlacementError

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WORLD = os.path.join(os.path.dirname(__file__), "test_torch_p2p_world.py")


def _outcome(fn, *args, **kw):
    """``("ok", value)`` or ``("raise", exception type name, message)``."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 — compared, not handled
        return ("raise", type(e).__name__, str(e))


# ------------------------------------------------------------ config


SIZES = ["32MiB", "4KB", "4KiB", "1G", "1GiB", "8", 64, "1.5KiB", "lots",
         " 2 MiB ", "3TB", "0.5K", "", "12Q"]
SWEEPS = ["1KiB:8KiB", "4KiB,32MiB", "1KiB:1KiB", "8:100", "1KiB:oops"]
EDGES = ["0:1", "12:3", "0", "0:1:2", "a:b", "0-1", "", "-1:0", "0:-2"]
CONFIGS = [{}, {"pattern": "nope"}, {"mode": "warp"}, {"direction": "diag"},
           {"iters": 0}, {"isolation": "x"}, {"transport": "nccl"},
           {"sweep": (1024, 2048)}, {"msg_size": 4096},
           {"pattern": "latency", "transport": "pallas_dma"}]


def test_size_sweep_and_edge_parsers_equal_the_reference():
    for s in SIZES:
        assert _outcome(TC.parse_size, s) == _outcome(JC.parse_size, s), s
    for n in (8, 1024, 4096, 2**20, 32 << 20, 2**30, 3 * 2**30, 1000):
        assert TC.format_size(n) == JC.format_size(n)
    for s in SWEEPS:
        assert _outcome(TC.parse_sweep, s) == _outcome(JC.parse_sweep, s), s
    for s in EDGES:
        assert _outcome(TC.parse_edge, s) == _outcome(JC.parse_edge, s), s
    assert (TC.REF_MSG_SIZE, TC.REF_ITERS, TC.REF_DTYPE) == \
        (JC.REF_MSG_SIZE, JC.REF_ITERS, JC.REF_DTYPE)
    assert (TC.PATTERNS, TC.MODES, TC.ISOLATIONS, TC.DIRECTIONS,
            TC.TRANSPORTS) == (JC.PATTERNS, JC.MODES, JC.ISOLATIONS,
                               JC.DIRECTIONS, JC.TRANSPORTS)


@pytest.mark.parametrize("kw", CONFIGS, ids=str)
def test_bench_config_validation_equals_the_reference(kw):
    def make(mod):
        cfg = mod.BenchConfig(**kw)
        return (cfg.sizes(), cfg.pattern, cfg.iters, cfg.dtype,
                cfg.direction, cfg.mode, cfg.isolation, cfg.transport,
                cfg.replace(iters=4).iters)

    assert _outcome(make, TC) == _outcome(make, JC)


# ------------------------------------------------------------ report


def _stream_matrix(mod, values, title):
    buf = io.StringIO()
    rep = mod.MatrixReporter(len(values), title, buf)
    rep.header()
    for i, row in enumerate(values):
        rep.row_label(i)
        for j, v in enumerate(row):
            rep.diagonal(i) if i == j else rep.cell(i, j, v)
        rep.end_row()
    s = rep.print_summary("pairwise uni-dir 32MiB serialized")
    return buf.getvalue(), s


def test_matrix_text_is_byte_equal():
    rng = np.random.default_rng(0)
    for n in (1, 2, 4, 8):
        values = (rng.random((n, n)) * 10.0 ** rng.integers(-2, 4, (n, n)))
        values = values.tolist()
        title = "Evaluating the Uni-Directional TPU P2P Bandwidth (Gbps)"
        got, want = (_stream_matrix(m, values, title) for m in (TREP, JREP))
        assert got[0] == want[0]
        assert got[1] == want[1] or n == 1  # NaN != NaN for 0 cells
        values[0][n - 1] = math.nan
        if n > 2:
            values[1][0] = None
        bufs = [io.StringIO(), io.StringIO()]
        reps = [m.render_matrix(values, title, b)
                for m, b in zip((TREP, JREP), bufs)]
        assert bufs[0].getvalue() == bufs[1].getvalue()
        assert reps[0].summary()["cells"] == reps[1].summary()["cells"]


def test_cell_records_and_resume_equal_the_reference(tmp_path):
    lines = []
    for mod in (TREP, JREP):
        rec = mod.CellRecord("pairwise", "uni", 0, 3, 4096, 2, "serialized",
                             1.25, mean_s=0.5, p50_s=0.25,
                             extra={"transport": "pallas_dma"})
        lines.append(rec.to_json())
        assert rec.key() == ("pairwise", "uni", 0, 3, 4096, "serialized")
    assert lines[0] == lines[1]
    path = tmp_path / "cells.jsonl"
    w = TREP.JsonlWriter(str(path))
    w.write(TREP.CellRecord("pairwise", "bi", 1, 0, 8, 2, "fused", 2.0))
    w.write(TREP.CellRecord("pairwise", "bi", 1, 2, 8, 2, "fused", 3.0,
                            timed_out=True))
    w.close()
    with open(path, "a") as fh:
        fh.write(lines[0] + "\n{\"torn\": \n\n")
    assert TREP.load_done_cells(str(path)) == JREP.load_done_cells(str(path))
    assert len(TREP.load_done_cells(str(path))) == 2


# ---------------------------------------------------------- topology

PLACEMENTS = [[7, 7, 7, 7], [1, 1, 1, 1, 2, 2, 2, 2], [1, 1, 1, 2, 2],
              [1, 2, 1, 2], [1, 1, 2, 2, 1, 1], [], [5], [3, 3, 9, 9]]


def test_host_hash_and_placement_verdicts_equal_the_reference():
    for s in ("", "a", "worker-0", "x" * 1000, "h100-node.example.org"):
        assert TT.djb2a_hash(s) == JT.djb2a_hash(s)
    assert TT.get_host_name() == JT.get_host_name()
    for keys in PLACEMENTS:
        def verdict(validate, err):
            try:
                p = validate(keys)
                return (p.num_devices, p.num_hosts, p.devices_per_host,
                        p.host_of, p.local_ids)
            except err as e:
                return str(e)
        assert verdict(TT.validate_placement, TPlacementError) == \
            verdict(JT.validate_placement, JPlacementError), keys


# ------------------------------------------- permutation and payloads


def test_permutation_tables_equal_the_reference():
    cases = [(8, edges) for edges in EDGE_SETS_8.values()]
    rng = np.random.default_rng(0)
    for _ in range(200):
        n = int(rng.integers(2, 9))
        k = int(rng.integers(0, n + 1))
        cases.append((n, tuple(zip(rng.permutation(n)[:k].tolist(),
                                   rng.permutation(n)[:k].tolist()))))
    for n, edges in cases:
        for got, want in zip(TPD.complete_permutation(edges, n),
                             JPD.complete_permutation(edges, n)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    for bad in (((0, 1), (0, 2)), ((0, 1), (2, 1)), ((0, 9),)):
        assert _outcome(TPD.complete_permutation, bad, 4) == \
            _outcome(JPD.complete_permutation, bad, 4)


def test_payload_bytes_and_oracle_equal_the_reference(rt):
    for dtype in (np.int8, np.float32, np.int32):
        for nbytes in (8, 136, 4096, 5000 * 4):
            if nbytes % np.dtype(dtype).itemsize:
                continue
            elems = TCOL.elems_for(nbytes, dtype)
            assert elems == JCOL.elems_for(nbytes, dtype)
            want = JCOL._payload_np((8,), elems, dtype)
            got = TCOL._payload_np((8,), elems, dtype)
            assert got.tobytes() == want.tobytes()
            for r in range(8):
                assert TCOL._payload_row(r, elems, dtype).tobytes() == \
                    want[r].tobytes()
    assert TCOL.host_payload(type("M", (), {"size": 8})(), 136).tobytes() \
        == JCOL.host_payload(rt.mesh, 136).tobytes()
    x = JCOL._payload_np((8,), 136, np.int8)
    for edges in EDGE_SETS_8.values():
        np.testing.assert_array_equal(TCOL.expected_permute(x, edges),
                                      JCOL.expected_permute(x, edges))
    for bad in (((0, 1), (2, 1)), ((0, 1), (0, 2)), ((0, 8),)):
        assert _outcome(TCOL._canon_edges, bad, 8) == \
            _outcome(JCOL._canon_edges, bad, 8)


# ------------------------------------------------------------ timing


class FakeClock:
    """Monotonic ns clock advancing by a scripted step per read."""

    def __init__(self, step_ns=1_000_000):
        self.t, self.step = 0, step_ns

    def __call__(self):
        self.t += self.step
        return self.t


class SlopeClock:
    """Chain(k) costs 50 ms + 2 ms × k, paid at the next clock read."""

    def __init__(self):
        self.t = self.pending = 0

    def __call__(self):
        self.t += self.pending + 1
        self.pending = 0
        return self.t

    def chain(self, k):
        def fn(x):
            self.pending += 50_000_000 + k * 2_000_000
            return x
        return fn


def _samples(s):
    return (s.iter_seconds, s.region_seconds, s.timed_out, s.count,
            s.mean_region, s.mean, s.p50, s.p99, s.min)


def _same(a, b):
    return all(x == y or (x != x and y != y) for x, y in zip(a, b))


def test_timing_arithmetic_equals_the_reference():
    for nbytes, secs, d in ((32 << 20, 1.0, 1), (32 << 20, 1e-3, 2),
                            (8, 2.5e-6, 1), (1, 0.0, 1), (1, math.nan, 1)):
        got, want = TTIM.gbps(nbytes, secs, d), JTIM.gbps(nbytes, secs, d)
        assert got == want or (math.isnan(got) and math.isnan(want))
    for vals in ([float(i) for i in range(1, 101)], [3.0, 1.0, 2.0], [],
                 np.random.default_rng(1).random(37).tolist()):
        t, j = TTIM.Samples(iter_seconds=list(vals)), JTIM.Samples(
            iter_seconds=list(vals))
        for q in (0.0, 1.0, 50.0, 90.0, 99.0, 100.0):
            assert _same([t.percentile(q)], [j.percentile(q)])
        assert _same(_samples(t), _samples(j))
    runs = []
    for mod in (TTIM, JTIM):
        calls, order = [], []
        ser = mod.measure_serialized(
            lambda x: calls.append(x) or x, 0, iters=4, warmup=2,
            clock=FakeClock(2_000_000),
            barrier=lambda: order.append("barrier"))
        fused = mod.measure_fused(lambda x: x, 0, iters=4, repeats=2,
                                  warmup=1, clock=FakeClock(8_000_000))
        clock = SlopeClock()
        diff = mod.measure_differential(clock.chain, 0, iters=32, repeats=3,
                                        clock=clock, fence=lambda y: None)
        runs.append((len(calls), order, _samples(ser), _samples(fused),
                     _samples(diff)))
    assert runs[0][:2] == runs[1][:2]
    for a, b in zip(runs[0][2:], runs[1][2:]):
        assert _same(a, b)


def test_timeouts_mark_the_cell_like_the_reference(monkeypatch):
    def hang(value, timeout_s, *fence):
        raise TTIM.TransferTimeout("wedged")

    monkeypatch.setattr(TTIM, "_block", hang)
    s = TTIM.measure_serialized(lambda x: x, 0, iters=4, warmup=0,
                                timeout_s=0.01)
    assert s.timed_out and math.isnan(s.mean_region)
    monkeypatch.undo()
    import threading

    with pytest.raises(TTIM.TransferTimeout):
        TTIM._block(0, 0.05, fence=lambda v: threading.Event().wait(10))
    s = TTIM.measure_differential(
        lambda k: (lambda x: x), 0, iters=8, repeats=2,
        fence=lambda y: threading.Event().wait(10), timeout_s=0.05)
    assert s.timed_out


# ----------------------------------------- arrivals on a world of 8


@pytest.fixture(scope="module")
def world8():
    return run_world(8, f"{WORLD}:cpu_arrivals_case", {"msg_bytes": 136},
                     timeout=240)


def _jax_permute_rows(rt, edges, x):
    """The reference's dma_ppermute (interpret mode) and ppermute of a
    [8, 5, 3] float32 payload inside a shard_map over the 8-device mesh,
    as tests/test_pallas_dma.py runs them."""
    spec = P("d", None, None)

    def run(fn):
        sm = JCOL._shard_map_unchecked(fn, rt.mesh, spec, spec)
        return np.asarray(jax.jit(sm)(jnp.asarray(x)))

    return (run(lambda v: JCOL.dma_ppermute(v, "d", edges)),
            run(lambda v: JCOL.ppermute(v, "d", edges)))


@pytest.mark.parametrize("name", sorted(EDGE_SETS_8))
def test_world_of_8_arrivals_equal_the_reference(rt, world8, name):
    edges = EDGE_SETS_8[name]
    cache = JCOL.CollectiveCache()
    x8 = JCOL.make_payload(rt.mesh, 136, jnp.int8)
    dma8, xla8 = (np.asarray(cache.permute(rt.mesh, "d", edges,
                                           transport=t)(x8))
                  for t in ("pallas_dma", "xla"))
    xf = float_payload(8)
    gf = float_payload(8, seed=1)
    dmaf, xlaf = _jax_permute_rows(rt, edges, xf)
    np.testing.assert_array_equal(dma8, xla8)
    for r, got in enumerate(world8):
        got = got[name]
        np.testing.assert_array_equal(got["dma_int8"], dma8[r:r + 1])
        np.testing.assert_array_equal(got["xla_int8"], xla8[r:r + 1])
        np.testing.assert_array_equal(got["dma_f32"], dmaf[r])
        np.testing.assert_array_equal(got["xla_f32"], xlaf[r])

    # The gradient: d/dx sum(g * dma_ppermute(x)) is the reverse permute.
    def loss(xs, gs):
        return jnp.sum(JPD.dma_ppermute(xs, "d", edges) * gs)

    spec = P("d", None, None)
    sm = JCOL._shard_map_unchecked(lambda xs, gs: jax.grad(loss)(xs, gs),
                                   rt.mesh, (spec, spec), spec)
    jgrad = np.asarray(jax.jit(sm)(jnp.asarray(xf), jnp.asarray(gf)))
    np.testing.assert_array_equal(
        jgrad, JCOL.expected_permute(gf, [(d, s) for s, d in edges]))
    for r, got in enumerate(world8):
        np.testing.assert_array_equal(got[name]["dma_grad"], jgrad[r])


# --------------------------------------------------------- CLI goldens


def _port_cli(args):
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_p2p_torch", *args],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


@pytest.mark.parametrize("name", ["pairwise", "p2p_pallas", "latency"])
def test_cli_output_equals_the_reference_goldens(name):
    if name == "pairwise":
        got = mask(_port_cli(ARGS))
        golden = os.path.join(GOLDEN_DIR, "cli_pairwise_8dev.txt")
    else:
        got = mask_floats(_port_cli(SUMMARY_PATTERNS[name]))
        golden = os.path.join(GOLDEN_DIR, f"cli_{name}_8dev.txt")
    with open(golden) as fh:
        assert got == fh.read()
