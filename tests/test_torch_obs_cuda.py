"""The obs report's join of a real profiled peer-push ring on the card —
tests marked ``cuda``: each skips inside the test where no card is
visible. This file imports torch and the port only (no JAX), so it also
runs on the card machine (``python -m pytest --noconftest -q -m cuda
tests/test_torch_obs_cuda.py``; ``--noconftest`` because
``tests/conftest.py`` boots JAX).
"""

import json
import os

import pytest
import torch

from tpu_p2p_torch.parallel.launch import spawn


@pytest.fixture
def card():
    """The card, or a skip: decided per test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (profiles the card's track)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_obs_joins_the_peer_push_ring_one_for_one(card, n, tmp_path):
    # `obs` on n processes of one card: every dma issue joined to a
    # dma_permute_kernel event of the first rank's window, nothing
    # ragged or unmatched, each ring edge of the peer-push matrix
    # measured, the matrix labelled time-sliced.
    codes = spawn(n, ["-m", "tpu_p2p_torch", "obs", "--device", "cuda:0",
                      "--msg-size", "1MiB", "--count", "4", "--no-gate",
                      "--artifacts-dir", str(tmp_path)], timeout=600)
    assert codes == [0] * n
    (name,) = [f for f in os.listdir(tmp_path)
               if f.startswith("MULTICHIP_r")]
    with open(tmp_path / name) as fh:
        art = json.load(fh)
    assert art["per_kind"]["dma"]["events"] == 4
    assert art["ragged"] == [] and art["unmatched"] == {}
    ring = [art["matrix_gbps_dma"][i][(i + 1) % n] for i in range(n)]
    assert all(isinstance(v, float) and v > 0 for v in ring), ring
    assert art["time_sliced"] is True
