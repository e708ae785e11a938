"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on an NVIDIA GPU. Every test here is marked ``cuda`` and
skips inside the test where no card is visible.

This file imports torch and the port only (no JAX), so it also runs on
a GPU host without the reference installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` boots JAX.) The
kernels are copies, so every comparison is bitwise.
"""

import os

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


# ------------------------------------------------------ flash kernels

from tpu_p2p_torch.ops import flash_attention as TFA  # noqa: E402

# (head dim, causal, window, q_off, k_off, Tq, Tk): ragged tiles, a
# window that is not a tile multiple, q_off != k_off, and q_off < k_off
# where the first queries see no key (fully-masked rows).
_FLASH_CASES = [(128, False, None, 0, 0, 200, 264),
                (128, True, None, 0, 0, 256, 256),
                (128, True, 96, 37, 5, 200, 264),
                (64, True, None, 3, 70, 130, 190),
                (32, True, 40, 100, 20, 64, 192)]
_B, _HQ, _HKV = 2, 4, 2


def _flash_inputs(dtype, d, tq, tk, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    bh, bhkv = _B * _HQ, _B * _HKV
    q = torch.randn((bh, tq, d), generator=g).to(dtype)
    k = torch.randn((bhkv, tk, d), generator=g).to(dtype)
    v = torch.randn((bhkv, tk, d), generator=g).to(dtype)
    o0 = torch.randn((bh, tq, d), generator=g)
    m0 = torch.randn((bh, tq), generator=g)
    l0 = torch.rand((bh, tq), generator=g)
    do = torch.randn((bh, tq, d), generator=g).to(dtype)
    return q, k, v, o0, m0, l0, do


def _bwd_plain(*args, **kw):
    """``(dq, dk, dv)`` from the two per-kernel plain versions."""
    return (TFA._flash_bwd_dq_plain(*args, **kw),
            *TFA._flash_bwd_dkdv_plain(*args, **kw))


def _norm_err(got, want):
    """max |got - want| / max |want|, the bf16 yardstick."""
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("case", _FLASH_CASES,
                         ids=[f"d{c[0]}_{'causal' if c[1] else 'dense'}"
                              f"_w{c[2]}_off{c[3]}-{c[4]}"
                              for c in _FLASH_CASES])
def test_flash_kernels_match_plain_on_card_f32(cuda, case):
    d, causal, window, q_off, k_off, tq, tk = case
    x = [t.to(cuda) for t in _flash_inputs(torch.float32, d, tq, tk, 2)]
    q, k, v, o0, m0, l0, do = x
    kw = dict(causal=causal, q_heads=_HQ, window=window)
    before = dict(TFA.launches)
    got = TFA._flash_call(q, k, v, o0, m0, l0, q_off, k_off, **kw)
    want = TFA._flash_call_plain(q, k, v, o0, m0, l0, q_off, k_off, **kw)
    for g_, w_, name in zip(got, want, "oml"):
        torch.testing.assert_close(g_, w_, atol=1e-4, rtol=1e-4,
                                   msg=name)
    o, m, l = want
    L = torch.where(l > 0, m + torch.log(torch.where(l > 0, l, 1.0)), 1e30)
    delta = torch.randn(L.shape, generator=torch.Generator(
        device="cpu").manual_seed(3)).to(cuda)
    args = (q, k, v, do, L, delta, q_off, k_off)
    got = TFA._flash_bwd_call(*args, **kw)
    want = _bwd_plain(*args, **kw)
    torch.cuda.synchronize()
    for g_, w_, name in zip(got, want, ("dq", "dk", "dv")):
        torch.testing.assert_close(g_, w_, atol=1e-4, rtol=1e-4, msg=name)
    assert {k_: TFA.launches[k_] - before[k_] for k_ in before} == {
        "flash_fwd": 1, "flash_bwd_dkdv": 1, "flash_bwd_dq": 1}


@pytest.mark.cuda
def test_flash_kernels_match_plain_on_card_bf16(cuda):
    # The train dtype at head dim 128: normalised L-inf <= 2e-2 (p and
    # ds are rounded to bf16 against tile-local vs whole-row maxima).
    x = [t.to(cuda) for t in _flash_inputs(torch.bfloat16, 128, 320, 320, 4)]
    q, k, v, o0, m0, l0, do = x
    kw = dict(causal=True, q_heads=_HQ)
    zero = TFA.zero_carry(q.shape[0], 320, 128, cuda)
    got = TFA._flash_call(q, k, v, *zero, **kw)
    want = TFA._flash_call_plain(q, k, v, *zero, **kw)
    for g_, w_ in zip(got, want):
        assert _norm_err(g_, w_) <= 2e-2
    o, m, l = want
    L = m + torch.log(l)
    delta = (do.float() * (o / l[..., None])).sum(-1)
    got = TFA._flash_bwd_call(q, k, v, do, L, delta, **kw)
    want = _bwd_plain(q, k, v, do, L, delta, **kw)
    for g_, w_ in zip(got, want):
        assert _norm_err(g_, w_) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 100])
def test_flash_attention_grads_match_dense_on_card(cuda, window):
    g = torch.Generator(device="cpu").manual_seed(5)
    q = torch.randn((2, 4, 192, 64), generator=g).to(cuda)
    k, v = (torch.randn((2, 2, 192, 64), generator=g).to(cuda)
            for _ in range(2))
    from tpu_p2p_torch.ops.attention import dense_attention

    outs = []
    for fn in (lambda a, b, c: TFA.flash_attention(a, b, c, True, window),
               lambda a, b, c: dense_attention(a, b, c, causal=True,
                                               window=window)):
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*ts)
        torch.sum(out ** 2).backward()
        outs.append((out.detach(), *(t.grad for t in ts)))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-4)


@pytest.mark.cuda
def test_flash_kernel_rejects_what_it_cannot_take_on_card(cuda):
    q = torch.zeros((2, 64, 48), device=cuda)      # head dim 48
    with pytest.raises(ValueError, match="head dims"):
        TFA._flash_call(q, q, q, *TFA.zero_carry(2, 64, 48, cuda),
                        causal=True, q_heads=2)
    q = torch.zeros((2, 64, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        TFA._flash_call(q, q, q, *TFA.zero_carry(2, 64, 64, cuda),
                        causal=True, q_heads=2)


# ------------------------------------------- peer-push (pallas_dma)
# A world of 2 ranks, both on cuda:0: each rank's kernel pushes into the
# other's CUDA IPC window. The rank-side cases live in
# tests/test_torch_p2p_world.py.


def _card_world(case, **kwargs):
    from tpu_p2p_torch.parallel.launch import run_world

    cases = os.path.join(os.path.dirname(__file__), "test_torch_p2p_world.py")
    return run_world(2, f"{cases}:{case}", kwargs, timeout=900)


@pytest.mark.cuda
def test_dma_kernel_matches_plain_and_oracle_on_card(cuda):
    # Six edge sets at 136 B, 4 KiB and 32 MiB int8, a float32 row with
    # its backward pass, then back-to-back launches with no drain
    # between them (a 9-hop ring chain and a 12-hop mixed sequence),
    # each held bitwise against the plain version and expected_permute.
    for rank, res in enumerate(_card_world("card_checks_case")):
        assert res["bad"] == [], f"rank {rank}: {res['bad']}"
        assert res["launches"] == res["expected_launches"], res


@pytest.mark.cuda
def test_dma_kernel_times_out_when_the_peer_never_launches(cuda):
    got = _card_world("card_timeout_case", timeout_s=0.5)
    assert got[1] is None
    assert got[0] is not None and "gave up waiting for rank 1" in got[0]


@pytest.mark.cuda
def test_dma_check_fails_when_the_peer_never_launches(cuda):
    # The --check hop times out on rank 0 after a good check left the
    # expected arrival in a freed block: no rank may report it verified,
    # and a serialized cell whose last hop times out is marked so.
    (err0, timed_out), (err1, _) = _card_world("card_check_timeout_case",
                                               timeout_s=0.5)
    assert err0 is not None and err0[0] == "TransferTimeout", err0
    assert "gave up waiting for rank 1" in err0[1]
    assert err1 is not None and err1[0] == "BackendError", err1
    assert timed_out is True
