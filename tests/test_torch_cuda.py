"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on an NVIDIA GPU. Every test here is marked ``cuda`` and
skips inside the test where no card is visible.

This file imports torch and the port only (no JAX), so it also runs on
a GPU host without the reference installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` boots JAX.) The
kernels are copies, so every comparison is bitwise.
"""

import pytest
import torch

from tpu_p2p_torch.ops import kvcache as TK


@pytest.fixture
def cuda():
    """The card, or a skip: decided per test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_rows_kernel_matches_plain_on_card(cuda, dtype):
    # The serving width: 32 slots, Hkv 8, page_len 32, Dh 128, with
    # n in {0, 1, 8} and every in-band offset.
    S, P, H, L, Dh, B = 2, 33, 8, 32, 128, 32
    g = torch.Generator(device="cpu").manual_seed(0)
    dt = getattr(torch, dtype)
    pool = torch.randn((S, P, H, L, Dh), generator=g).to(dt)
    slab8 = torch.randn((B, H, 8, Dh), generator=g)
    n = torch.tensor([(0, 1, 8)[b % 3] for b in range(B)], dtype=torch.int32)
    r0 = torch.where(n == 8, 0, torch.arange(B) % 8).to(torch.int32)
    page = torch.where(n > 0, torch.arange(B) + 1, 0).to(torch.int32)
    band = (torch.arange(B) % (L // 8)).to(torch.int32)
    want = TK.paged_rows_write(pool.clone(), slab8, page, band, r0, n, 1)
    got = pool.to(cuda)
    before = TK.launches["paged_rows_write"]
    TK.paged_rows_write(got, slab8.to(cuda), page.to(cuda), band.to(cuda),
                        r0.to(cuda), n.to(cuda), 1)
    torch.cuda.synchronize()
    assert TK.launches["paged_rows_write"] == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_row_kernel_matches_plain_on_card(cuda, dtype):
    S, B, H, T, Dh = 2, 8, 8, 64, 128
    g = torch.Generator(device="cpu").manual_seed(1)
    dt = getattr(torch, dtype)
    cache = torch.randn((S, B, H, T, Dh), generator=g).to(dt)
    slab = torch.randn((B, H, 1, Dh), generator=g)
    want = TK.cache_row_write(cache.clone(), slab, 37, 1)
    got = cache.to(cuda)
    before = TK.launches["cache_row_write"]
    TK.cache_row_write(got, slab.to(cuda), 37, 1)
    torch.cuda.synchronize()
    assert TK.launches["cache_row_write"] == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_kernels_take_narrow_rows_on_card(cuda):
    # Dh=6 float32 rows (24 bytes) go through the 8-byte vector path.
    pool = torch.randn((1, 3, 2, 8, 6))
    slab8 = torch.randn((2, 2, 8, 6))
    idx = [torch.tensor(v, dtype=torch.int32)
           for v in ([1, 2], [0, 0], [3, 0], [2, 8])]
    want = TK.paged_rows_write(pool.clone(), slab8, *idx, 0)
    got = pool.to(cuda)
    TK.paged_rows_write(got, slab8.to(cuda), *(v.to(cuda) for v in idx), 0)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_kernel_rejects_a_non_contiguous_pool_on_card(cuda):
    # No fallback: a CUDA tensor the kernel cannot take raises.
    pool = torch.zeros((1, 2, 1, 8, 8), device=cuda).transpose(3, 4)
    z = torch.zeros((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        TK.paged_rows_write(pool, torch.zeros((1, 1, 8, 8), device=cuda),
                            z, z, z, z, 0)
