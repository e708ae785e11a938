"""The port's build cache (``tpu_p2p_torch/utils/cuda_build.py``) on the
CPU: the library path of a source is its cache key, so it must change
whenever anything the compiler reads changes — the source, any header
beside it under ``csrc/`` (``*.cuh``), the flags or the macros — and
stay put otherwise. No compiler runs here.
"""

import pytest

from tpu_p2p_torch.utils import cuda_build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A throwaway ``csrc/`` with one source and one header."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('#include "sm90.cuh"\nint f() { return 1; }\n')
    (src / "sm90.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(cuda_build, "CSRC", src)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    return src


def test_library_path_follows_every_header(csrc):
    first = cuda_build.library_path("k")
    assert first == cuda_build.library_path("k")  # deterministic
    assert first.parent == csrc.parent / "build"
    (csrc / "sm90.cuh").write_text("#pragma once\n// a new helper\n")
    edited = cuda_build.library_path("k")
    assert edited != first
    (csrc / "extra.cuh").write_text("#pragma once\n")
    added = cuda_build.library_path("k")
    assert added not in (first, edited)
    (csrc / "extra.cuh").rename(csrc / "renamed.cuh")
    assert cuda_build.library_path("k") not in (first, edited, added)


def test_library_path_follows_source_flags_and_macros(csrc, monkeypatch):
    first = cuda_build.library_path("k")
    (csrc / "k.cu").write_text('#include "sm90.cuh"\nint f() { return 2; }\n')
    source = cuda_build.library_path("k")
    assert source != first
    macros = cuda_build.library_path("k", ("TP_FWD_BK=128",))
    assert macros != source
    assert macros == cuda_build.library_path("k", ("TP_FWD_BK=128",))
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS",
                        cuda_build.NVCC_FLAGS + ("-lineinfo",))
    assert cuda_build.library_path("k") != source


@pytest.mark.parametrize("macro", ["TP_DQ_WG=1", "TP_DQ_BK=128",
                                   "TP_DQ_MINB=2"])
def test_library_path_follows_the_dq_tile_macros(csrc, macro):
    base = cuda_build.library_path("k")
    tiled = cuda_build.library_path("k", (macro,))
    assert tiled != base
    assert tiled == cuda_build.library_path("k", (macro,))


def test_a_cached_library_is_not_rebuilt(csrc):
    out = cuda_build.library_path("k", ("X=1",))
    out.parent.mkdir(parents=True)
    out.write_bytes(b"")
    info = cuda_build.build(["k"], ("X=1",))["k"]
    assert info == {"path": out, "cmd": None, "seconds": 0.0,
                    "cached": True, "log": ""}


def test_nvcc_command_passes_the_macros(csrc, monkeypatch):
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: "nvcc")
    cmd = cuda_build.nvcc_command("k", csrc / "out.so", ("A=1", "B=2"))
    assert cmd[0] == "nvcc" and cmd[-1] == str(csrc / "k.cu")
    assert cmd[cmd.index("-o") - 2:cmd.index("-o")] == ["-DA=1", "-DB=2"]
    assert "-Xptxas=-v" in cmd


def test_ptxas_usage_reads_one_kernel():
    log = (
        "ptxas info    : Compiling entry function '_Z3fooILi64EEvv' for "
        "'sm_90a'\n"
        "ptxas info    : Function properties for _Z3fooILi64EEvv\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 96 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_Z3fooILi128EEvv' for "
        "'sm_90a'\n"
        "ptxas info    : Function properties for _Z3fooILi128EEvv\n"
        "    8 bytes stack frame, 28 bytes spill stores, 24 bytes spill "
        "loads\n"
        "ptxas info    : Used 128 registers, used 1 barriers\n")
    assert cuda_build.ptxas_usage(log, "fooILi128E") == {
        "registers": 128, "spill_stores": 28, "spill_loads": 24}
    assert cuda_build.ptxas_usage(log, "fooILi64E")["registers"] == 96
    assert cuda_build.ptxas_usage("", "foo") == {
        "registers": None, "spill_stores": None, "spill_loads": None}
