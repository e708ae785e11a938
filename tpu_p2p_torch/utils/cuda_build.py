"""Build the port's CUDA sources with ``nvcc`` at first use and bind
them with ``ctypes``.

Each ``tpu_p2p_torch/csrc/<name>.cu`` exposes a plain C interface and
compiles on its own into ``build/lib<name>-<hash>.so`` at the repo
root, where the hash covers the source bytes and the flags, so an
edited source never loads a stale library. Building a file with a C
interface takes seconds (a source that includes PyTorch's headers
would take minutes, and every fresh checkout builds again). Nothing
here runs at import: the CPU test host has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOADED: Dict[str, ctypes.CDLL] = {}


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


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def nvcc_command(name: str, out: Path) -> list:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out),
            str(CSRC / f"{name}.cu")]


def build(names: Sequence[str]) -> Dict[str, dict]:
    """Compile every source in ``names`` that has no current library,
    one ``nvcc`` per source, all started together. → per name
    ``{"path", "cmd", "seconds", "cached"}``; raises on a failed
    compile with the compiler's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    info: Dict[str, dict] = {}
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            info[name] = {"path": out, "cmd": None, "seconds": 0.0,
                          "cached": True}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = nvcc_command(name, tmp)
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
                      "cached": False}
    return info


def load(name: str) -> ctypes.CDLL:
    """The bound library for ``csrc/<name>.cu``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]["path"]))
        _LOADED[name] = lib
    return lib
