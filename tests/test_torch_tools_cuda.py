"""The topology smoke, the flight recorder, the checkpoint smoke and the
native library on the card — tests marked ``cuda``: each skips inside the
test where no card is visible. This file imports torch and the port only
(no JAX), so it also runs on the card machine (``python -m pytest
--noconftest -q -m cuda tests/test_torch_tools_cuda.py``); the worlds'
rank cases are this file's functions, run by path.
"""

import contextlib
import io
import json
import os

import pytest
import torch

from tpu_p2p_torch.parallel.launch import run_world

HERE = os.path.abspath(__file__)


@pytest.fixture
def card():
    """The card, or a skip: decided per test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def topo_case(artifacts_dir: str) -> dict:
    """One rank of a world sharing cuda:0: ``topo --smoke``."""
    from tpu_p2p_torch import cli
    from tpu_p2p_torch.parallel import pallas_dma as PD

    PD.reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["topo", "--smoke", "--device", "cuda:0",
                       "--skip-engine-parity",
                       "--artifacts-dir", artifacts_dir])
    return {"rc": rc, "out": buf.getvalue(), "launches": dict(PD.launches)}


@pytest.mark.cuda
def test_topo_smoke_on_processes_sharing_a_card(card, tmp_path):
    # The ring recommended around the throttled edge, its payloads over
    # the peer-push kernels bitwise the rank-order ring's; on 4 ranks
    # the migration grade is the reference's own (most migrations find
    # only the throttled shard free), so the exit is the smoke's verdict.
    res = run_world(4, f"{HERE}:topo_case", {"artifacts_dir": str(tmp_path)},
                    timeout=600)
    out = res[0]["out"]
    got = json.loads(out.strip().splitlines()[-1])
    assert {r["rc"] for r in res} == {0 if got["ok"] else 1}
    assert "degraded edge avoided=True" in out
    assert "ring_allgather_matmul bitwise OK" in out
    assert "time-sliced host timings, not link numbers" in out
    assert got["topo_route_gain"] > 1
    assert all(r["launches"]["dma_permute"] and r["launches"]["dma_ship"]
               for r in res)
    assert os.listdir(tmp_path) == []


def trace_case() -> dict:
    """One rank of a world sharing cuda:0: the flight recorder over the
    peer-push transport."""
    from tpu_p2p_torch.obs import tickprof as TP
    from tpu_p2p_torch.parallel import pallas_dma as PD
    from tpu_p2p_torch.parallel.runtime import make_runtime

    rt = make_runtime(device="cuda:0")
    PD.reset_launches()
    rep = TP.run_flight_recorder(rt, microbatches=3, steps=2, d_model=256,
                                 d_ff=1024)
    torch.cuda.synchronize()
    out = {"report": rep, "launches": dict(PD.launches)}
    rt.close()
    return out


@pytest.mark.cuda
def test_flight_recorder_on_processes_sharing_a_card(card):
    from tpu_p2p_torch.models import schedule as S
    from tpu_p2p_torch.obs import tickprof as TP

    res = run_world(2, f"{HERE}:trace_case", {}, timeout=600)
    rep = res[0]["report"]
    hops = sum(len(v) for v in TP.ship_slots(S.compile_zb(3, 2)).values())
    assert rep["stamp_clock"] == "cuda_event"
    assert rep["transport"] == "pallas_dma"
    dj = rep["device_join"]
    assert dj["device_track"] and dj["joined"]
    assert dj["events_per_rank"] == {0: hops, 1: hops}
    slots = TP.ship_slots(S.compile_zb(3, 2))
    assert all(j["tick"] in slots[j["site"]] for j in dj["joined"])
    # warmup, 2 measured steps and the profiled one
    assert [r["launches"]["dma_permute"] for r in res] == [4 * hops] * 2
    assert rep["decomposition"]["constant_overhead_ms"] > 0


@pytest.mark.cuda
def test_ckpt_smoke_on_the_card(card):
    from tpu_p2p_torch.obs.ckpt import run_ckpt_smoke

    res = run_ckpt_smoke(out=io.StringIO(), device=card)
    for name in ("crash_mid_write", "corrupt_latest", "transient_io"):
        assert res[name]["ok"], res[name]
    assert res["ckpt_recover_steps"] == 3 and res["ckpt_save_ms_p50"] > 0


@pytest.mark.cuda
def test_native_library_on_the_card_host(card):
    from tpu_p2p_torch.utils import native

    assert native.available()
    samples = [3.0, 1.0, 2.0, 8.5]
    lib = (native.stats(samples), native.percentile(samples, 99.0),
           native.djb2a("gpu-0"), native.gbps(1 << 25, 1e-3, bidir=True))
    saved = native._lib, native._tried
    native._lib, native._tried = None, True
    try:
        fallback = (native.stats(samples), native.percentile(samples, 99.0),
                    native.djb2a("gpu-0"),
                    native.gbps(1 << 25, 1e-3, bidir=True))
    finally:
        native._lib, native._tried = saved
    assert lib == fallback
