"""The port's collectives against the JAX reference: the host oracles,
every ``CollectiveCache`` reduction builder on a gloo world of 8, ring
permutes along each axis of 2-D meshes over both transports, the groups
a 2-D runtime forms, ``measure_headline``'s decisions, the device-clock
trace reading, and the refusal to run a reduction without NCCL on a card.

Int8 is compared bitwise; float32 on small-integer payloads, whose sums
are exact in any order, also bitwise. The world's ranks import only
torch and the port (``tests/torch_collectives_world.py``); this process
computes the reference values with the JAX package on its 8-device CPU
mesh.
"""

import contextlib
import math
import os

import jax
import numpy as np
import pytest
import torch

import torch_collectives_world as W
from tpu_p2p.parallel import collectives as JCOL
from tpu_p2p.parallel.runtime import make_runtime as j_make_runtime
from tpu_p2p.utils import profiling as JPROF
from tpu_p2p.utils import timing as JTIM
from tpu_p2p.utils.errors import TransferTimeout as JTransferTimeout
from tpu_p2p_torch.parallel import collectives as TCOL
from tpu_p2p_torch.parallel import runtime as RT
from tpu_p2p_torch.parallel.launch import run_world
from tpu_p2p_torch.utils import profiling as TPROF
from tpu_p2p_torch.utils import timing as TTIM
from tpu_p2p_torch.utils.errors import BackendError
from tpu_p2p_torch.utils.errors import TransferTimeout as TTransferTimeout

WORLD = os.path.join(os.path.dirname(__file__), "torch_collectives_world.py")
MSG, K, CHAIN = 64, 3, 3


# ------------------------------------------------------------- oracles


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_oracles_equal_the_reference(n):
    for dtype in (np.int8, np.int32):
        x = JCOL._payload_np((n,), 8 * 3, dtype)
        assert np.array_equal(TCOL._payload_np((n,), 8 * 3, dtype), x)
        pairs = [
            (TCOL.expected_all_reduce(x), JCOL.expected_all_reduce(x)),
            (TCOL.expected_reduce_scatter(x),
             JCOL.expected_reduce_scatter(x)),
            (TCOL.expected_all_gather(x), JCOL.expected_all_gather(x)),
            (TCOL.expected_all_to_all(x, n), JCOL.expected_all_to_all(x, n)),
        ]
        for got, want in pairs:
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.tobytes() == want.tobytes()
    # int8 sums wrap in two's complement, as on the card.
    if n >= 2:
        wrap = np.full((n, 8), 100, np.int8)
        wrap[1] = 101
        assert TCOL.expected_all_reduce(wrap)[0, 0] == \
            JCOL.expected_all_reduce(wrap)[0, 0]


@pytest.mark.parametrize("shape", W.SHAPES_2D, ids=str)
def test_axis_permute_oracle_equals_the_reference(shape):
    x = JCOL._payload_np(shape, 16, np.int8)
    for axis in (0, 1):
        size = shape[axis]
        for edges in (JCOL.ring_edges(size), ((0, size - 1),), ()):
            assert np.array_equal(TCOL.expected_permute(x, edges, axis),
                                  JCOL.expected_permute(x, edges, axis))
    mesh = RT.Mesh(ranks=tuple(range(8)), rank=0,
                   device=torch.device("cpu"), host_group=None,
                   axis_names=("x", "y"), dims=shape)
    assert TCOL.host_payload(mesh, 16).tobytes() == x.tobytes()


# --------------------------------------------------- a gloo world of 8


@pytest.fixture(scope="module")
def world8():
    return run_world(8, f"{WORLD}:cpu_collectives_case",
                     {"msg_bytes": MSG, "k": K, "chain": CHAIN}, timeout=240)


def _reference_builders(rt):
    """The reference's jitted builders on its 8-device CPU mesh, on the
    int8 payload and the small-integer float32 payload → name → (int8,
    float32) global arrays."""
    from tpu_p2p.parallel.collectives import payload_sharding

    cache = JCOL.CollectiveCache()
    x8 = JCOL.make_payload(rt.mesh, MSG, np.int8)
    xf = jax.device_put(W.small_int_payload(8, MSG),
                        payload_sharding(rt.mesh))
    out = {}
    for name in W.SINGLES:
        fn = getattr(cache, name)(rt.mesh, "d")
        out[name] = (np.asarray(fn(x8)), np.asarray(fn(xf)))
    for name in W.CHAINS:
        fn = getattr(cache, name)(rt.mesh, "d", K)
        out[name] = (np.asarray(fn(x8)), np.asarray(fn(xf)))
    return out


@pytest.fixture(scope="module")
def reference_builders():
    return _reference_builders(j_make_runtime(num_devices=8))


@pytest.mark.parametrize("name", W.SINGLES + W.CHAINS)
def test_builders_equal_the_reference_on_a_world_of_8(world8,
                                                      reference_builders,
                                                      name):
    want8, wantf = reference_builders[name]
    for r, got in enumerate(world8):
        got8, gotf = got["builders"][name]
        assert got8.dtype == np.int8 and gotf.dtype == np.float32
        assert got8.tobytes() == want8[r:r + 1].tobytes(), (name, r)
        assert gotf.tobytes() == wantf[r:r + 1].tobytes(), (name, r)
    assert all(got["payload_intact"] for got in world8)


@pytest.mark.parametrize("shape", W.SHAPES_2D, ids=str)
def test_axis_permutes_equal_the_reference_on_2d_meshes(world8, shape):
    # The reference's interpret-mode DMA lowers one named axis only, so
    # both port transports are held against its CollectivePermute (which
    # its pallas_dma equals bitwise on 1-D meshes) and the host oracle.
    rt = j_make_runtime(num_devices=8, mesh_shape=shape)
    cache = JCOL.CollectiveCache()
    x = JCOL.make_payload(rt.mesh, MSG, np.int8)
    host = JCOL.host_payload(rt.mesh, MSG, np.int8)
    for a, axis in enumerate(("x", "y")):
        ring = JCOL.ring_edges(shape[a])
        for hops in (1, CHAIN):
            fn = (cache.permute(rt.mesh, axis, ring) if hops == 1 else
                  cache.permute_chain(rt.mesh, axis, ring, hops))
            want = np.asarray(fn(x)).reshape(8, -1)
            oracle = host
            for _ in range(hops):
                oracle = JCOL.expected_permute(oracle, ring, axis=a)
            assert np.array_equal(want, oracle.reshape(8, -1))
            for r, got in enumerate(world8):
                for transport in ("xla", "pallas_dma"):
                    arr = got[shape]["permutes"][(axis, transport, hops)]
                    assert arr.tobytes() == want[r:r + 1].tobytes(), (
                        shape, axis, transport, hops, r)


@pytest.mark.parametrize("shape", W.SHAPES_2D, ids=str)
def test_2d_runtime_forms_one_group_per_line(world8, shape):
    a, b = shape
    x_lines = [tuple(range(j, a * b, b)) for j in range(b)]
    y_lines = [tuple(range(i * b, (i + 1) * b)) for i in range(a)]
    for r, got in enumerate(world8):
        g = got[shape]
        assert g["shape"] == {"x": a, "y": b} and g["index"] == r
        assert g["lines"]["x"] == x_lines[r % b]
        assert g["lines"]["y"] == y_lines[r // b]
        assert g["line_axes"] == {"x": ("x",), "y": ("y",)}
        # The world and every line of every axis, each rank set once.
        assert g["groups"] == sorted(
            [tuple(range(8))] + x_lines + y_lines)
        assert not g["windows_shared"] and g["windows_by_set"]


def test_2d_runtime_rejects_a_shape_that_does_not_cover_the_world():
    with pytest.raises(Exception, match=r"mesh shape \(3, 3\) != 1 devices"):
        RT.make_runtime(device="cpu", mesh_shape=(3, 3))
    with pytest.raises(Exception, match="1-D or 2-D"):
        RT.make_runtime(device="cpu", mesh_shape=(1, 1, 1))
    rt = RT.make_runtime(device="cpu", mesh_shape=(1, 1))
    try:
        assert rt.mesh.shape == {"x": 1, "y": 1}
        assert rt.mesh.line("x").ranks == (0,)
        with pytest.raises(ValueError, match="axis 'd'"):
            rt.mesh.line("d")
        assert rt.mesh.line("x").windows is rt.mesh.windows  # one set
    finally:
        rt.close()


# ------------------------------------------------ measure_headline


class FakeTiming:
    """``timing`` whose ``measure_differential`` returns the scripted
    host slopes in turn ("timeout" marks the cell)."""

    def __init__(self, samples_cls, hosts):
        self.samples_cls, self.hosts = samples_cls, list(hosts)

    def measure_differential(self, make_chain, x, iters, **kw):
        h = self.hosts.pop(0)
        s = self.samples_cls()
        if h == "timeout":
            s.timed_out = True
        else:
            s.iter_seconds, s.region_seconds = [h], h
        return s


# (host slopes, device captures): a capture is a slope, "track" (a
# device track whose slope cannot be read), None (no device track) or
# "timeout" (a fence outlived the watchdog).
HEADLINE_CASES = {
    "agree": ([1e-3], [1.1e-3]),
    "disagree_second_vouched": ([1e-3, 2e-3], [5e-3, 2.1e-3]),
    "disagree_captures_consistent": ([1e-3, 1e-3], [2e-3, 2.2e-3]),
    "disagree_none_vouched": ([1e-3, 1e-3], [5e-3, 3e-3]),
    "disagree_first_vouched_by_second_host": ([1e-3, 5e-3], [5e-3, 1e-3]),
    "host_timed_out": (["timeout"], []),
    "device_timed_out": ([1e-3], ["timeout"]),
    "remeasure_capture_timed_out": ([1e-3, 1e-3], [5e-3, "timeout"]),
    "remeasure_host_timed_out": ([1e-3, "timeout"], [5e-3, 1e-3]),
    "no_track": ([1e-3], [None]),
    "track_without_slope": ([1e-3], ["track"]),
    "degenerate_host": ([math.nan], [1e-3]),
    "degenerate_device": ([1e-3, 1e-3], [-1e-6, -2e-6]),
}


def _reference_headline(monkeypatch, hosts, devs):
    devs = list(devs)
    track = {"now": False}

    def from_trace(td, short, n_long, runs=1):
        d = devs.pop(0)
        track["now"] = d == "track"
        if d in (None, "track"):
            raise ValueError("trace has 0 top-level device program groups")
        return d

    def chain(k):
        def f(x):
            if devs and devs[0] == "timeout" and capturing["on"]:
                devs.pop(0)
                raise JTransferTimeout("wedged")
            return x
        return f

    capturing = {"on": False}

    @contextlib.contextmanager
    def trace(td):
        capturing["on"] = True
        try:
            yield
        finally:
            capturing["on"] = False

    monkeypatch.setattr(JPROF, "differential_from_trace", from_trace)
    monkeypatch.setattr(JPROF, "device_top_level_events",
                        lambda td: [1] if track["now"] else [])
    monkeypatch.setattr(jax.profiler, "trace", trace)
    x = jax.numpy.zeros((4,), jax.numpy.int8)
    return JPROF.measure_headline(chain, x, 16,
                                  timing=FakeTiming(JTIM.Samples, hosts))


def _port_headline(monkeypatch, hosts, devs, card=False):
    devs = list(devs)

    def capture(f_short, f_long, x, n_short, n_long, runs, timeout_s=None,
                barrier=None):
        d = devs.pop(0)
        if d == "timeout":
            raise TTransferTimeout("wedged")
        if d == "track":
            return None, "the trace holds no device work"
        return d, None

    monkeypatch.setattr(TPROF, "capture_device_slope", capture)
    monkeypatch.setattr(TPROF, "on_card", lambda x: card)
    return TPROF.measure_headline(lambda k: (lambda x: x), torch.zeros(4),
                                  16, timing=FakeTiming(TTIM.Samples, hosts))


def _decision(m):
    return (m.per_op_s, m.source, m.remeasured, m.ok, m.timed_out,
            m.note is not None, m.n_short, m.n_long)


def _same(a, b):
    return all(x == y or (x != x and y != y) for x, y in zip(a, b))


@pytest.mark.parametrize("case", sorted(HEADLINE_CASES))
def test_measure_headline_decides_like_the_reference(monkeypatch, case):
    hosts, devs = HEADLINE_CASES[case]
    want = _reference_headline(monkeypatch, hosts, devs)
    got = _port_headline(monkeypatch, hosts, devs)
    assert _same(_decision(got), _decision(want)), (got, want)
    assert _same([got.host_per_op_s, got.device_per_op_s, got.ratio],
                 [want.host_per_op_s, want.device_per_op_s, want.ratio])
    assert got.validation_fields() == want.validation_fields()
    s, t = got.as_samples(), want.as_samples()
    assert (s.source, s.timed_out) == (t.source, t.timed_out)
    assert _same([s.mean_region, s.mean], [t.mean_region, t.mean])


@pytest.mark.parametrize("case", ["no_track", "track_without_slope",
                                  "degenerate_device"])
def test_measure_headline_on_a_card_never_publishes_the_host_slope(
        monkeypatch, case):
    hosts, devs = HEADLINE_CASES[case]
    m = _port_headline(monkeypatch, hosts, devs, card=True)
    assert m.per_op_s is None and m.source == "none"
    assert m.note and m.ok is False


def test_timing_validation_text_equals_the_reference():
    rows = [(1e-3, None, None, None), (1e-3, None, None, "no groups"),
            (1e-3, 1.1e-3, 1.1, None), (1e-3, 3e-3, 3.0, None),
            (-1e-6, 2e-3, None, None), (1e-3, -1.0, None, None)]
    for host, dev, ratio, note in rows:
        got = TPROF.TimingValidation(host, dev, ratio, 2.0, 16, 128, note)
        want = JPROF.TimingValidation(host, dev, ratio, 2.0, 16, 128, note)
        assert got.describe() == want.describe()
        assert got.ok == want.ok


# ------------------------------------------- reading the card's clock


def _trace(chains):
    """A Chrome trace as torch.profiler writes it: per chain run a host
    range, one runtime call per device event inside it, and the device
    events (start, duration in us) on the card's timeline."""
    events, corr = [], 0
    for i, (name, spans) in enumerate(chains):
        t0 = 1000.0 * (i + 1)
        events.append({"cat": "user_annotation", "name": name, "pid": 7,
                       "tid": 7, "ts": t0, "dur": 500.0})
        for j, (start, dur) in enumerate(spans):
            corr += 1
            events.append({"cat": "cuda_runtime", "name": "cudaLaunch",
                           "pid": 7, "tid": 7, "ts": t0 + 1 + j, "dur": 1,
                           "args": {"correlation": corr}})
            events.append({"cat": "kernel", "name": "k", "pid": 0,
                           "tid": 9, "ts": start, "dur": dur,
                           "args": {"correlation": corr}})
    # A device event outside every range (the fence's copy) and one with
    # no runtime call in a range count for nothing.
    events.append({"cat": "gpu_memcpy", "name": "copy", "pid": 0, "tid": 9,
                   "ts": 0.0, "dur": 50.0, "args": {"correlation": 999}})
    return events


def test_device_slope_is_busy_time_not_span():
    tag = TPROF.CHAIN_TAG
    # Short chains: 2 ops of 10 us with a 100 us host gap between them;
    # long chains: 10 ops of 10 us, two of them overlapping by 5 us on
    # another stream. The busy-time slope is 10 us an op whatever the
    # gaps (the spans would give the host's issue rate). A third pair
    # of runs lost events in the tracer and counts for nothing.
    short = [(0.0, 10.0), (110.0, 10.0)]
    long = [(200.0 + 100 * i, 10.0) for i in range(9)] + [(205.0, 10.0)]
    ev = _trace([(f"{tag}:2:0", short), (f"{tag}:10:0", long),
                 (f"{tag}:2:1", short), (f"{tag}:10:1", long),
                 (f"{tag}:2:2", short[:1]), (f"{tag}:10:2", long[3:])])
    busy = TPROF.chain_busy_times(ev)
    assert busy[f"{tag}:2:0"] == pytest.approx((20e-6, 2))
    assert busy[f"{tag}:10:0"] == pytest.approx((95e-6, 10))
    for runs in (2, 3):
        assert TPROF.differential_from_kernels(ev, 2, 10, runs) == \
            pytest.approx((95e-6 - 20e-6) / 8)
    assert TPROF.has_device_track(ev)
    # A chain whose calls put nothing more on the card than the short
    # one (a collective over one rank) has no slope.
    flat = _trace([(f"{tag}:2:0", short), (f"{tag}:10:0", short)])
    with pytest.raises(ValueError, match="no device work"):
        TPROF.differential_from_kernels(flat, 2, 10, 1)
    with pytest.raises(ValueError, match="holds no device work"):
        TPROF.differential_from_kernels(_trace([]), 2, 10, 1)


def test_cpu_capture_has_no_track_and_publishes_the_host_slope():
    x = torch.zeros(1, 1024)
    dev, note = TPROF.capture_device_slope(lambda v: v + 1,
                                           lambda v: v + 2, x, 1, 8, 2)
    assert (dev, note) == (None, None)
    m = TPROF.measure_headline(lambda k: (lambda v: v + k), x, 16)
    assert m.source in ("host_differential", "none") and m.ok is None


# ------------------------------------------------------------ refusals


def test_reduction_on_a_card_without_nccl_raises_before_any_call(
        monkeypatch):
    calls = []
    for fn in ("all_reduce", "all_to_all_single", "reduce_scatter_tensor",
               "all_gather_into_tensor"):
        monkeypatch.setattr(torch.distributed, fn,
                            lambda *a, _n=fn, **k: calls.append(_n))
    mesh = RT.Mesh(ranks=(0, 1), rank=0, device=torch.device("cuda", 0),
                   host_group=object())
    cache = TCOL.CollectiveCache()
    for name in W.SINGLES:
        with pytest.raises(BackendError, match="one card per rank"):
            getattr(cache, name)(mesh, "d")
    for name in W.CHAINS:
        with pytest.raises(BackendError, match="NCCL collective"):
            getattr(cache, name)(mesh, "d", 4)
    with pytest.raises(BackendError, match="all_reduce is an NCCL"):
        TCOL.psum(torch.zeros(1, 4), mesh)
    assert calls == []
    with pytest.raises(ValueError, match="axis 'x'"):
        cache.all_reduce(mesh, "x")


@pytest.mark.parametrize("mode", ["serialized", "device"])
def test_smoke_counts_the_hops_the_ring_workload_makes(monkeypatch, mode):
    # chip_smoke.py holds the peer-push kernel's launches on the ring
    # cells to ring_launches(cfg); on a world of 1 every hop is one call
    # of dma_ppermute (the self-edge ring), counted here.
    import chip_smoke
    from tpu_p2p_torch.cli import run_benchmark
    from tpu_p2p_torch.config import BenchConfig
    from tpu_p2p_torch.parallel import pallas_dma as TPD

    calls = []
    real = TPD.dma_ppermute
    monkeypatch.setattr(TPD, "dma_ppermute",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = BenchConfig(pattern="ring", msg_size=4096, iters=16,
                      transport="pallas_dma", mode=mode,
                      check=mode == "serialized")
    rt = RT.make_runtime(device="cpu")
    try:
        run_benchmark(rt, cfg)
    finally:
        rt.close()
    assert len(calls) == chip_smoke.ring_launches(cfg)[0]
