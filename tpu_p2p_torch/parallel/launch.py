"""Start a world of ranks on this host: one process per rank, each with
the environment ``torchrun`` gives its workers (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
``TORCHELASTIC_USE_AGENT_STORE`` and ``OMP_NUM_THREADS=1`` unless set).

:func:`spawn` runs any ``python`` command line once per rank and returns
the exit codes; ``python -m tpu_p2p_torch --cpu-mesh N`` is built on it.
:func:`run_world` calls an importable function on every rank and
returns what each returned:

    results = run_world(4, "my.module:case", {"msg": 4096})
    results = run_world(4, "path/to/cases.py:case", {"msg": 4096})

Every rank runs ``python -m tpu_p2p_torch.parallel.launch TARGET DIR``,
which imports the module (by name, or from the file when it ends in
``.py``), calls ``case(**kwargs)`` and pickles the result into ``DIR``. A rank that fails takes the world down: the
others get ``grace`` seconds to finish, then are killed, so a rank stuck
in a collective never outlives the run.
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional, Sequence

from torch.distributed import TCPStore

REPO = Path(__file__).resolve().parents[2]


def spawn(n: int, argv: Sequence[str], *, timeout: Optional[float] = None,
          grace: float = 10.0) -> List[int]:
    """Run ``python *argv`` as ranks ``0..n-1`` of one world and wait.

    → each rank's exit code; a rank killed for the time limit (or for
    outliving a failed peer by ``grace`` seconds) reads 124."""
    base = dict(os.environ)
    base.setdefault("OMP_NUM_THREADS", "1")  # as torchrun: the ranks of
    # a host share its cores
    base["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), base.get("PYTHONPATH")) if p)
    # This process hosts the world's store, as torchrun's agent does: it
    # holds the listening socket from the start, so no other program can
    # take the port between choosing it and rank 0 binding it.
    store = TCPStore("127.0.0.1", 0, None, True, wait_for_workers=False)
    base.update(WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n),
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(store.port),
                TORCHELASTIC_USE_AGENT_STORE="True")
    procs = [subprocess.Popen([sys.executable, *argv],
                              env=dict(base, RANK=str(r),
                                       LOCAL_RANK=str(r)))
             for r in range(n)]
    limits = [] if timeout is None else [time.monotonic() + timeout]
    codes: List[Optional[int]] = [None] * n
    failed = False
    try:
        while any(c is None for c in codes):
            for r, p in enumerate(procs):
                if codes[r] is None:
                    codes[r] = p.poll()
            if not failed and any(codes[r] for r in range(n)):
                failed = True
                limits.append(time.monotonic() + grace)
            if limits and time.monotonic() > min(limits):
                break
            time.sleep(0.02)
    finally:
        for r, p in enumerate(procs):
            if codes[r] is None:
                p.kill()
                p.wait()
                codes[r] = 124
        del store
    return [c if c >= 0 else 128 - c for c in codes]


def run_world(n: int, target: str, kwargs: Optional[dict] = None, *,
              timeout: float = 300.0) -> list:
    """``target(**kwargs)`` on every rank of a world of ``n`` → the list
    of per-rank results; raises when any rank fails."""
    with tempfile.TemporaryDirectory(prefix="tp_world_") as td:
        with open(os.path.join(td, "kwargs.pkl"), "wb") as fh:
            pickle.dump(kwargs or {}, fh)
        codes = spawn(n, ["-m", "tpu_p2p_torch.parallel.launch", target,
                          td], timeout=timeout)
        if any(codes):
            raise RuntimeError(
                f"world of {n} running {target} failed: exit codes {codes}")
        results = []
        for r in range(n):
            with open(os.path.join(td, f"result.{r}.pkl"), "rb") as fh:
                results.append(pickle.load(fh))
        return results


def _import(module: str):
    if not module.endswith(".py"):
        return importlib.import_module(module)
    spec = importlib.util.spec_from_file_location(Path(module).stem, module)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rank_main(target: str, workdir: str) -> int:
    module, _, name = target.rpartition(":")
    fn = getattr(_import(module), name)
    with open(os.path.join(workdir, "kwargs.pkl"), "rb") as fh:
        kwargs = pickle.load(fh)
    result = fn(**kwargs)
    rank = os.environ["RANK"]
    tmp = os.path.join(workdir, f"result.{rank}.tmp")
    with open(tmp, "wb") as fh:
        pickle.dump(result, fh)
    os.replace(tmp, os.path.join(workdir, f"result.{rank}.pkl"))
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1], sys.argv[2]))
