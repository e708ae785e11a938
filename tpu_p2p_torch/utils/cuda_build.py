"""Build the port's CUDA sources with ``nvcc`` at first use and bind
them with ``ctypes``.

Each ``tpu_p2p_torch/csrc/<name>.cu`` exposes a plain C interface and
compiles on its own into ``build/lib<name>-<hash>.so`` at the repo
root, where the hash covers the source bytes, every header under
``csrc/`` (``*.cuh``) and the flags, so an edited source or header never
loads a stale library. Building a file with a C
interface takes seconds (a source that includes PyTorch's headers
would take minutes, and every fresh checkout builds again). Nothing
here runs at import: the CPU test host has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOADED: Dict[tuple, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``PATH``, else ``$CUDA_HOME/bin`` (default
    ``/usr/local/cuda``); raises when neither has one."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin; the port's "
        "CUDA kernels build on a machine with the CUDA toolkit"
    )


def _flags(defines: Sequence[str]) -> list:
    return [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]


def library_path(name: str, defines: Sequence[str] = ()) -> Path:
    """``build/lib<name>-<hash>.so``: the hash covers ``csrc/<name>.cu``,
    every ``csrc/*.cuh`` (name and bytes) and the flags, ``defines``
    (``NAME=value`` macros) included."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(_flags(defines)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def nvcc_command(name: str, out: Path, defines: Sequence[str] = ()) -> list:
    return [nvcc_path(), *_flags(defines), "-o", str(out),
            str(CSRC / f"{name}.cu")]


def build(names: Sequence[str], defines: Sequence[str] = ()
          ) -> Dict[str, dict]:
    """Compile every source in ``names`` that has no current library,
    one ``nvcc`` per source, all started together, each with the macros
    ``defines``. → per name ``{"path", "cmd", "seconds", "cached",
    "log"}`` (``log``: the compiler's output, ``ptxas``'s registers,
    spills and shared memory per kernel; empty when cached); raises on
    a failed compile with the compiler's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    info: Dict[str, dict] = {}
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name, defines)
        if out.exists():
            info[name] = {"path": out, "cmd": None, "seconds": 0.0,
                          "cached": True, "log": ""}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = nvcc_command(name, tmp, defines)
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), cmd, tmp, out)
    for name, (proc, cmd, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {name}:\n"
                f"{' '.join(cmd)}\n{log}"
            )
        os.replace(tmp, out)  # atomic: a concurrent loader never sees
        # a half-written library
        info[name] = {"path": out, "cmd": " ".join(cmd),
                      "seconds": time.perf_counter() - t0,
                      "cached": False, "log": log}
    return info


def ptxas_usage(log: str, function: str) -> dict:
    """``ptxas -v``'s registers and spill bytes for the first kernel whose
    mangled name contains ``function``, from a build's ``log``; None
    where the log does not say (a cached build keeps no log)."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and function in line:
            text = "\n".join(lines[i:i + 4])
            found = [re.search(pat, text) for pat in (
                r"Used (\d+) registers", r"(\d+) bytes spill stores",
                r"(\d+) bytes spill loads")]
            return dict(zip(("registers", "spill_stores", "spill_loads"),
                            (int(f.group(1)) if f else None
                             for f in found)))
    return {"registers": None, "spill_stores": None, "spill_loads": None}


def load(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The bound library for ``csrc/<name>.cu`` built with the macros
    ``defines``, built on first use."""
    key = (name, tuple(defines))
    lib = _LOADED.get(key)
    if lib is None:
        lib = ctypes.CDLL(str(build([name], defines)[name]["path"]))
        _LOADED[key] = lib
    return lib
