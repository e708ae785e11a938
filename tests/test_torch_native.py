"""The port's native support library binding
(``tpu_p2p_torch/utils/native.py``) against its Python fallbacks and the
reference's, case for case with ``tests/test_native.py``.

The library builds from ``native/tpu_p2p_native.cc`` with ``g++`` into
``build/`` at first use; every entry point's library path and fallback
give equal outputs, and the report's matrix text is byte-equal with and
without it.
"""

import math

import pytest

from tpu_p2p.utils import native as JN
from tpu_p2p_torch.parallel import topology
from tpu_p2p_torch.utils import native

requires_native = pytest.mark.skipif(
    not native.available(), reason="no g++ to build native/ with")


def _without_lib(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)


@requires_native
def test_native_loaded():
    assert native.available()
    assert native.library_path().exists()
    assert native.library_path().parent.name == "build"


@requires_native
def test_djb2a_c_python_parity():
    for s in ["", "a", "worker-0", "tpu-vm-3", "x" * 257]:
        assert native.djb2a(s) == topology.djb2a_hash(s) == JN.djb2a(s), s


@requires_native
def test_host_hash_matches_python():
    assert native.host_hash() == topology.host_hash()


@requires_native
def test_monotonic_ns_advances():
    a = native.monotonic_ns()
    b = native.monotonic_ns()
    assert b >= a > 0
    from tpu_p2p_torch.utils import timing

    assert timing.default_clock() is native.monotonic_ns


@requires_native
def test_percentile_c_python_parity(monkeypatch):
    from tpu_p2p_torch.utils.timing import Samples

    samples = [5.0, 1.0, 4.0, 2.0, 3.0, 0.5, 7.25]
    lib = [native.percentile(samples, q) for q in (0.0, 50.0, 99.0, 100.0)]
    py = Samples(iter_seconds=samples)
    assert lib == [py.percentile(q) for q in (0.0, 50.0, 99.0, 100.0)]
    assert lib == [JN.percentile(samples, q)
                   for q in (0.0, 50.0, 99.0, 100.0)]
    _without_lib(monkeypatch)
    assert lib == [native.percentile(samples, q)
                   for q in (0.0, 50.0, 99.0, 100.0)]
    assert lib == [py.percentile(q) for q in (0.0, 50.0, 99.0, 100.0)]
    assert math.isnan(native.percentile([], 50.0))


@requires_native
def test_stats_native(monkeypatch):
    s = native.stats([3.0, 1.0, 2.0])
    assert s["mean"] == pytest.approx(2.0)
    assert (s["min"], s["max"], s["p50"], s["p99"]) == (1.0, 3.0, 2.0, 3.0)
    _without_lib(monkeypatch)
    assert native.stats([3.0, 1.0, 2.0]) == s


def test_stats_empty_fallback():
    assert all(math.isnan(v) for v in native.stats([]).values())


@requires_native
def test_check_placement_parity_and_errors():
    from tpu_p2p_torch.utils.errors import PlacementError

    keys = [7, 7, 7, 9, 9, 9]
    for rank in range(6):
        want = topology.validate_placement(keys).local_ids[rank]
        assert native.check_placement(keys, rank) == want, rank
    with pytest.raises(PlacementError, match="same number"):
        native.check_placement([7, 7, 7, 9, 9], 0)
    with pytest.raises(PlacementError, match="contiguous"):
        native.check_placement([7, 9, 7, 9], 0)
    with pytest.raises(PlacementError):
        native.check_placement([], 0)
    with pytest.raises(PlacementError):
        native.check_placement([7], 3)


@requires_native
def test_gbps_formula_parity(monkeypatch):
    from tpu_p2p_torch.utils import timing

    msg = 32 * 1024 * 1024
    lib = (native.gbps(msg, 1e-3), native.gbps(msg, 1e-3, bidir=True))
    assert lib == (timing.gbps(msg, 1e-3),
                   timing.gbps(msg, 1e-3, directions=2))
    assert lib[0] == pytest.approx(msg * 8 / 1e-3 / 1e9)
    assert math.isnan(native.gbps(msg, 0.0))
    _without_lib(monkeypatch)
    assert (native.gbps(msg, 1e-3),
            native.gbps(msg, 1e-3, bidir=True)) == lib


@requires_native
def test_native_formatting_byte_parity_with_printf():
    assert native.format_header("Title", 3) == (
        "Title\n   D\\D" + "".join("%6d " % i for i in range(3)) + "\n")
    for v in (0.0, 0.004, 3.14159, 123.456, 99999.9, float("nan")):
        assert native.format_cell(v) == "%6.02f " % v, v
    for s in (0, 7, 42, 100000):
        assert native.format_row_label(s) == "%6d " % s


@requires_native
def test_matrix_reporter_output_identical_with_and_without_native(
        monkeypatch):
    import io

    from tpu_p2p.utils.report import MatrixReporter as JReporter
    from tpu_p2p_torch.utils.report import MatrixReporter

    def render(cls):
        buf = io.StringIO()
        r = cls(3, "Evaluating X", stream=buf)
        r.header()
        for i in range(3):
            r.row_label(i)
            for j in range(3):
                r.diagonal(i) if i == j else r.cell(i, j, 10.0 * i + j)
            r.end_row()
        return buf.getvalue()

    with_native = render(MatrixReporter)
    assert with_native == render(JReporter)
    _without_lib(monkeypatch)
    assert render(MatrixReporter) == with_native


def test_check_placement_fallback_matches_native_contract(monkeypatch):
    from tpu_p2p_torch.utils.errors import PlacementError

    _without_lib(monkeypatch)
    assert not native.available()
    assert native.check_placement([7, 7, 9, 9], 3) == 1
    with pytest.raises(PlacementError):
        native.check_placement([7, 7, 9, 9], -1)
    with pytest.raises(PlacementError):
        native.check_placement([7], 3)
    with pytest.raises(PlacementError, match="same number"):
        native.check_placement([7, 7, 7, 9, 9], 0)
    assert math.isnan(native.gbps(1024, 0.0))
    assert native.gbps(1024, 1e-3, bidir=True) == pytest.approx(
        2 * 1024 * 8 / 1e-3 / 1e9)
    assert native.format_header("t", 2) is None
    assert native.djb2a("worker-0") == topology.djb2a_hash("worker-0")


@requires_native
def test_format_header_long_title_stays_native():
    long_title = "x" * 200
    got = native.format_header(long_title, 8)
    assert got is not None and got.startswith(long_title + "\n   D\\D")
