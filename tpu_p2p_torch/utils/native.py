"""ctypes bindings to the native C++ support library — the port of
``tpu_p2p/utils/native.py``.

The repo's ``native/tpu_p2p_native.cc`` holds the host-side runtime
support the reference program got from libc and ``<chrono>``, and its
hot host paths:

- a monotonic nanosecond clock (``clock_gettime(CLOCK_MONOTONIC)``) for
  the reference program's ``system_clock`` reads
  (``p2p_matrix.cc:153,174``);
- DJB2a host-name hashing (``getHostHash``, ``p2p_matrix.cc:44-51``) and
  the placement check (``:63-100``);
- the nearest-rank percentile and stats kernels over per-iteration
  samples, the Gbps formula, and the matrix report's ``printf`` fields.

The library is built with ``g++`` at first use into the git-ignored
``build/`` at the repo root, keyed by a hash of the source and the
flags, the way :mod:`tpu_p2p_torch.utils.cuda_build` builds the kernels
(``TPU_P2P_NATIVE_LIB`` names a prebuilt one instead). Every entry point
has a pure-Python fallback with equal output, used when no compiler or
library is there; :func:`available` says which runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional, Sequence

SOURCE = Path(__file__).resolve().parents[2] / "native" / "tpu_p2p_native.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")
_LIB_ENV = "TPU_P2P_NATIVE_LIB"
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """``build/libtpu_p2p_native-<hash>.so``: the hash covers the source
    bytes and the flags."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libtpu_p2p_native-{digest.hexdigest()[:12]}.so"


def build() -> Optional[Path]:
    """Compile the library unless a current one exists → its path, or
    None where there is no source or no ``g++``, or the compile fails
    (the Python fallbacks then run)."""
    if not SOURCE.exists():
        return None
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if not cxx:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode:
        return None
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a
    # half-written library
    return out


def _candidates():
    if os.environ.get(_LIB_ENV):
        yield os.environ[_LIB_ENV]
    built = build()
    if built is not None:
        yield str(built)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    for path in _candidates():
        if not os.path.exists(path):
            continue
        try:
            lib = ctypes.CDLL(path)
            lib.tpu_p2p_monotonic_ns.restype = ctypes.c_uint64
            lib.tpu_p2p_djb2a.argtypes = [ctypes.c_char_p]
            lib.tpu_p2p_djb2a.restype = ctypes.c_uint64
            lib.tpu_p2p_host_hash.restype = ctypes.c_uint64
            lib.tpu_p2p_percentile.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_size_t,
                ctypes.c_double]
            lib.tpu_p2p_percentile.restype = ctypes.c_double
            lib.tpu_p2p_stats.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_double)]
            lib.tpu_p2p_stats.restype = None
            lib.tpu_p2p_check_placement.argtypes = [
                ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
                ctypes.c_int]
            lib.tpu_p2p_check_placement.restype = ctypes.c_int
            lib.tpu_p2p_gbps.argtypes = [
                ctypes.c_uint64, ctypes.c_double, ctypes.c_int]
            lib.tpu_p2p_gbps.restype = ctypes.c_double
            lib.tpu_p2p_format_header.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
                ctypes.c_size_t]
            lib.tpu_p2p_format_header.restype = ctypes.c_long
            lib.tpu_p2p_format_cell.argtypes = [
                ctypes.c_double, ctypes.c_char_p, ctypes.c_size_t]
            lib.tpu_p2p_format_cell.restype = ctypes.c_long
            lib.tpu_p2p_format_row_label.argtypes = [
                ctypes.c_int, ctypes.c_char_p, ctypes.c_size_t]
            lib.tpu_p2p_format_row_label.restype = ctypes.c_long
            _lib = lib
            break
        except OSError:
            continue
    return _lib


def available() -> bool:
    return _load() is not None


def monotonic_ns() -> int:
    lib = _load()
    if lib is not None:
        return int(lib.tpu_p2p_monotonic_ns())
    return time.monotonic_ns()


def djb2a(s: str) -> int:
    lib = _load()
    if lib is not None:
        return int(lib.tpu_p2p_djb2a(s.encode()))
    from tpu_p2p_torch.parallel.topology import djb2a_hash

    return djb2a_hash(s)


def host_hash() -> int:
    lib = _load()
    if lib is not None:
        return int(lib.tpu_p2p_host_hash())
    from tpu_p2p_torch.parallel import topology

    return topology.host_hash()


def _nearest_rank(s: Sequence[float], q: float) -> float:
    import math

    return s[max(0, min(len(s) - 1, math.ceil(q / 100.0 * len(s)) - 1))]


def percentile(samples: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (as ``timing.Samples.percentile``)."""
    lib = _load()
    if lib is not None and len(samples):
        arr = (ctypes.c_double * len(samples))(*samples)
        return float(lib.tpu_p2p_percentile(arr, len(samples), q))
    import math

    s = sorted(samples)
    return _nearest_rank(s, q) if s else math.nan


def check_placement(host_keys: Sequence[int], rank: int) -> int:
    """Local device id for ``rank``, or raise on a bad placement — the
    native twin of :func:`tpu_p2p_torch.parallel.topology.
    validate_placement` (``check_process_placement_policy``,
    ``p2p_matrix.cc:63-100``). Both paths raise the same messages."""
    from tpu_p2p_torch.parallel import topology
    from tpu_p2p_torch.utils.errors import PlacementError

    if not 0 <= rank < len(host_keys):
        raise PlacementError(
            f"bad placement arguments: n={len(host_keys)}, {rank=}"
        )
    lib = _load()
    if lib is None:
        placement = topology.validate_placement(host_keys)
        return placement.local_ids[rank]
    arr = (ctypes.c_uint64 * len(host_keys))(*host_keys)
    r = int(lib.tpu_p2p_check_placement(arr, len(host_keys), rank))
    if r == -1:
        raise PlacementError(topology._MSG_NONUNIFORM)
    if r == -2:
        raise PlacementError(topology._MSG_NONCONTIGUOUS)
    return r


def gbps(msg_bytes: int, seconds: float, bidir: bool = False) -> float:
    """Gbps = bytes*8/t/1e9, ×2 bi-directional (``p2p_matrix.cc:177,
    258``); the fallback is :func:`tpu_p2p_torch.utils.timing.gbps`."""
    lib = _load()
    if lib is not None:
        return float(lib.tpu_p2p_gbps(msg_bytes, seconds, int(bidir)))
    from tpu_p2p_torch.utils import timing

    return timing.gbps(msg_bytes, seconds, directions=2 if bidir else 1)


def format_header(title: str, n: int) -> Optional[str]:
    """The matrix title + ``D\\D`` header line, natively formatted; None
    without the library (callers format in Python). The buffer is sized
    from the title."""
    lib = _load()
    if lib is None:
        return None
    buf = ctypes.create_string_buffer(len(title.encode()) + 16 + 7 * n)
    w = lib.tpu_p2p_format_header(title.encode(), n, buf, len(buf))
    return buf.raw[:w].decode() if w > 0 else None


def format_cell(value: float) -> Optional[str]:
    """One ``%6.02f`` cell, natively formatted; None without the
    library."""
    lib = _load()
    if lib is None:
        return None
    buf = ctypes.create_string_buffer(64)
    w = lib.tpu_p2p_format_cell(value, buf, len(buf))
    return buf.raw[:w].decode() if w > 0 else None


def format_row_label(src: int) -> Optional[str]:
    """One ``%6d`` row label, natively formatted; None without the
    library."""
    lib = _load()
    if lib is None:
        return None
    buf = ctypes.create_string_buffer(64)
    w = lib.tpu_p2p_format_row_label(src, buf, len(buf))
    return buf.raw[:w].decode() if w > 0 else None


def stats(samples: Sequence[float]) -> dict:
    """{mean, min, max, p50, p99} in one native pass, or the Python
    fallback."""
    import math

    if not samples:
        return {k: math.nan for k in ("mean", "min", "max", "p50", "p99")}
    lib = _load()
    if lib is not None:
        arr = (ctypes.c_double * len(samples))(*samples)
        out = (ctypes.c_double * 5)()
        lib.tpu_p2p_stats(arr, len(samples), out)
        return dict(zip(("mean", "min", "max", "p50", "p99"), out))
    s = sorted(samples)
    return {
        "mean": sum(s) / len(s),
        "min": s[0],
        "max": s[-1],
        "p50": _nearest_rank(s, 50.0),
        "p99": _nearest_rank(s, 99.0),
    }
