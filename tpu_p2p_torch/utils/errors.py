"""Fail-fast error handling — the port's copy of ``tpu_p2p/utils/errors.py``.

Typed exceptions raised where a failure happens, plus one CLI-level
handler (:func:`fail_fast`) that prints and picks the exit code, as the
reference program's ``MPICHECK`` / ``CUDACHECK`` / ``NCCLCHECK`` macros
print ``Failed: ...`` and exit (``p2p_matrix.cc:15-42``), and its
placement checks ``exit(-1)`` (``p2p_matrix.cc:85,97``).
"""

from __future__ import annotations

import sys
import traceback
from contextlib import contextmanager


class TpuP2PError(RuntimeError):
    """Base class for all framework errors."""


class PlacementError(TpuP2PError):
    """Topology/placement invariant violated: processes per host not
    uniform, per-host rank blocks not contiguous, or more ranks on a
    host than it has cards (``p2p_matrix.cc:83-98``)."""


class BackendError(TpuP2PError):
    """A device or collective operation failed, or the backend cannot
    do what was asked (``NCCLCHECK``/``CUDACHECK``,
    ``p2p_matrix.cc:25-42``)."""


class TransferTimeout(TpuP2PError):
    """A timed transfer exceeded its watchdog deadline, or a peer-push
    kernel gave up waiting for its peer. The reference hangs at the next
    ``MPI_Barrier`` instead; here the wedge surfaces as a marked cell or
    an error."""


def _caller_site(depth: int = 2) -> str:
    """``file:line`` of the calling frame (the macros' ``__FILE__`` /
    ``__LINE__``, ``p2p_matrix.cc:18,28,38``)."""
    frame = sys._getframe(depth)
    return f"{frame.f_code.co_filename}:{frame.f_lineno}"


def check(cond: bool, msg: str, exc: type = TpuP2PError) -> None:
    """Assert a runtime invariant, failing with the call site attached
    (the reference's bare ``assert``, ``p2p_matrix.cc:106``)."""
    if not cond:
        raise exc(f"Failed: {msg} at {_caller_site()}")


@contextmanager
def checked(what: str):
    """Wrap a backend call so a failure carries context and call site,
    as ``NCCLCHECK(ncclSend(...))`` does::

        with checked("ppermute dispatch"):
            out = fn(x)
    """
    site = _caller_site(3)  # 0=_caller_site, 1=checked,
    # 2=contextmanager.__enter__, 3=the caller's `with` statement
    try:
        yield
    except TpuP2PError:
        raise
    except Exception as e:  # noqa: BLE001 — deliberate catch-all, macro parity
        raise BackendError(
            f"Failed: {what} error {site} '{type(e).__name__}: {e}'"
        ) from e


def fail_fast(e: BaseException, *, stream=None) -> int:
    """CLI-level handler: print like the reference macros, return the
    exit code — 255 for a placement error (the reference's ``exit(-1)``),
    else 1 (``EXIT_FAILURE``) with a traceback for errors that are not
    the framework's own."""
    stream = stream if stream is not None else sys.stderr
    if isinstance(e, PlacementError):
        print(str(e), file=stream)
        return 255
    print(f"Failed: {type(e).__name__} '{e}'", file=stream)
    if not isinstance(e, TpuP2PError):
        traceback.print_exception(e, file=stream)
    return 1
