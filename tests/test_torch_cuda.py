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


def _fused_case(S, P, H, L, Dh, B, C, dt, seed):
    """Pools, K rows as an einsum gives them (the permuted view of a
    [B, C, H, Dh] tensor), V rows as a slice out of wider rows, and
    every in-band offset over n in {0, 1, C}."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    pools = [torch.randn((S, P, H, L, Dh), generator=g).to(dt)
             for _ in range(2)]
    k = torch.randn((B, C, H, Dh), generator=g).to(dt).permute(0, 2, 1, 3)
    v = torch.randn((B, H, C + 2, Dh), generator=g).to(dt)[:, :, 1:1 + C]
    n = torch.tensor([(0, 1, C)[b % 3] for b in range(B)], dtype=torch.int32)
    r0 = torch.where(n == C, 8 - C, torch.arange(B) % 8).to(torch.int32)
    page = torch.where(n > 0, torch.arange(B) + 1, 0).to(torch.int32)
    band = (torch.arange(B) % (L // 8)).to(torch.int32)
    return pools, (k, v), (page, band, r0, n)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_kv_kernels_match_plain_on_card(cuda, dtype):
    # The serving width (32 slots, Hkv 8, page_len 32, Dh 128, chunk 8)
    # from strided projections, then the dense cache.
    dt = getattr(torch, dtype)
    pools, rows, idx = _fused_case(2, 33, 8, 32, 128, 32, 8, dt, 2)
    want = TK.paged_kv_write_plain(*(p.clone() for p in pools), *rows,
                                   *idx, 1)
    got = [p.to(cuda) for p in pools]
    before = dict(TK.launches)
    TK.paged_kv_write(*got, *(r.to(cuda) for r in rows),
                      *(v.to(cuda) for v in idx), 1)
    torch.cuda.synchronize()
    assert TK.launches["paged_kv_write"] == before["paged_kv_write"] + 1
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    g = torch.Generator(device="cpu").manual_seed(3)
    caches = [torch.randn((2, 8, 8, 64, 128), generator=g).to(dt)
              for _ in range(2)]
    k = torch.randn((8, 1, 8, 128), generator=g).to(dt).permute(0, 2, 1, 3)
    v = torch.randn((8, 8, 3, 128), generator=g).to(dt)[:, :, 2:]
    want = TK.cache_kv_write_plain(*(c.clone() for c in caches), k, v, 37, 1)
    got = [c.to(cuda) for c in caches]
    TK.cache_kv_write(*got, k.to(cuda), v.to(cuda), 37, 1)
    torch.cuda.synchronize()
    assert TK.launches["cache_kv_write"] == before["cache_kv_write"] + 1
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,dh,vec", [("float32", 6, 8),
                                          ("float32", 3, 4),
                                          ("bfloat16", 3, 2)])
def test_fused_kv_kernel_takes_narrow_rows_on_card(cuda, dtype, dh, vec):
    dt = getattr(torch, dtype)
    pools, rows, idx = _fused_case(1, 7, 2, 16, dh, 6, 4, dt, 4)
    want = TK.paged_kv_write_plain(*(p.clone() for p in pools), *rows,
                                   *idx, 0)
    got = [p.to(cuda) for p in pools]
    rows_c = [r.to(cuda) for r in rows]
    assert TK._vec_bytes(dh * got[0].element_size(), *got, *rows_c) == vec
    TK.paged_kv_write(*got, *rows_c, *(v.to(cuda) for v in idx), 0)
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
def test_fused_kv_kernel_rejects_what_it_cannot_take_on_card(cuda):
    pool = torch.zeros((1, 3, 2, 16, 8), device=cuda)
    rows = torch.zeros((2, 2, 4, 8), device=cuda)
    z = torch.zeros((2,), dtype=torch.int32, device=cuda)
    before = dict(TK.launches)
    with pytest.raises(ValueError, match="unit stride on Dh"):
        TK.paged_kv_write(pool, pool.clone(), rows,
                          torch.zeros((2, 2, 4, 16), device=cuda)[..., ::2],
                          z, z, z, z, 0)
    with pytest.raises(ValueError, match="K and V pools differ"):
        TK.paged_kv_write(pool, torch.zeros((1, 3, 2, 8, 8), device=cuda),
                          rows, rows, z, z, z, z, 0)
    with pytest.raises(ValueError, match="K and V pools differ"):
        TK.paged_kv_write(pool, pool.to(torch.bfloat16), rows, rows,
                          z, z, z, z, 0)
    with pytest.raises(ValueError, match="K and V pools differ"):
        TK.cache_kv_write(pool, pool.cpu(), rows[:, :, :1], rows[:, :, :1],
                          0, 0)
    assert TK.launches == before


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


# bf16 on the tensor-core kernels (forward, dk/dv, dq):
# (head dim, causal, window, q_off, k_off, Tq, Tk, Hq, Hkv, random
# carry). Head dims 32/64/128; GQA groups 1, 2 and 4; Tq != Tk, neither a
# multiple of any tile; q_off < k_off with a window, where the first
# queries see no key (fully masked rows keep their carry).
_BF16_CASES = [(32, True, None, 0, 0, 100, 150, 4, 4, True),
               (64, True, 100, 37, 5, 200, 264, 4, 2, True),
               (128, True, 96, 3, 70, 130, 190, 8, 2, True),
               (128, True, 40, 50, 0, 333, 77, 4, 1, False),
               (64, False, None, 0, 0, 65, 129, 8, 2, True),
               (32, True, 17, 64, 100, 129, 190, 4, 1, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _BF16_CASES,
                         ids=[f"d{c[0]}_{'causal' if c[1] else 'dense'}"
                              f"_w{c[2]}_off{c[3]}-{c[4]}_t{c[5]}-{c[6]}"
                              f"_gqa{c[7] // c[8]}" for c in _BF16_CASES])
def test_flash_bf16_kernels_match_plain_on_ragged_shapes_on_card(cuda, case):
    d, causal, window, q_off, k_off, tq, tk, hq, hkv, rand = case
    g = torch.Generator(device="cpu").manual_seed(11)
    q, do = (torch.randn((2 * hq, tq, d), generator=g).bfloat16().to(cuda)
             for _ in range(2))
    k, v = (torch.randn((2 * hkv, tk, d), generator=g).bfloat16().to(cuda)
            for _ in range(2))
    carry = ((torch.randn((2 * hq, tq, d), generator=g).to(cuda),
              torch.randn((2 * hq, tq), generator=g).to(cuda),
              torch.rand((2 * hq, tq), generator=g).to(cuda))
             if rand else TFA.zero_carry(2 * hq, tq, d, cuda))
    kw = dict(causal=causal, q_heads=hq, window=window)
    fargs = (q, k, v, *carry, q_off, k_off)
    want = TFA._flash_call_plain(*fargs, **kw)
    o, m, l = want
    live = l > 0
    L = torch.where(live, m + torch.log(torch.where(live, l, 1.0)), 1e30)
    delta = (do.float() * (o / torch.where(live, l, 1.0)[..., None])).sum(-1)
    bargs = (q, k, v, do, L, delta, q_off, k_off)
    want += _bwd_plain(*bargs, **kw)
    before = dict(TFA.launches)
    runs = [TFA._flash_call(*fargs, **kw) + TFA._flash_bwd_call(*bargs, **kw)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert {k_: TFA.launches[k_] - before[k_] for k_ in before} == {
        "flash_fwd": 2, "flash_bwd_dkdv": 2, "flash_bwd_dq": 2}
    for name, g_, w_ in zip(("o", "m", "l", "dq", "dk", "dv"), runs[0], want):
        assert _norm_err(g_, w_) <= 2e-2, name
    for a, b in zip(*runs):  # no atomics: the same bits every launch
        assert torch.equal(a, b)
    # Rows that see no key keep their carry bit for bit.
    blind = torch.zeros(tq, dtype=torch.bool, device=cuda)
    if causal:
        q_pos = q_off + torch.arange(tq, device=cuda)
        lo = q_pos - (window - 1) if window else torch.full_like(q_pos, -2**30)
        blind = (q_pos < k_off) | (lo > k_off + tk - 1)
    if blind.any():
        o_k, _, l_k = runs[0][:3]
        assert torch.equal(o_k[:, blind], carry[0][:, blind])
        assert torch.equal(l_k[:, blind], carry[2][:, blind])


@pytest.mark.cuda
def test_flash_bf16_dq_at_the_training_shape_windowed_on_card(cuda):
    # The training shape (B 4, Hq 16 over Hkv 8, T 4096, D 128) with
    # window 1024: dq alone against its plain version, one batch element
    # at a time, and two launches bitwise equal.
    b, hq, hkv, t, d, window = 4, 16, 8, 4096, 128, 1024
    g = torch.Generator(device=cuda).manual_seed(7)
    q, do = (torch.randn((b * hq, t, d), generator=g, device=cuda).bfloat16()
             for _ in range(2))
    k, v = (torch.randn((b * hkv, t, d), generator=g, device=cuda).bfloat16()
            for _ in range(2))
    kw = dict(causal=True, q_heads=hq, window=window)
    o, m, l = TFA._flash_call(q, k, v, *TFA.zero_carry(b * hq, t, d, cuda),
                              **kw)
    L = m + torch.log(l)
    delta = (do.float() * (o / l[..., None])).sum(-1)
    args = (q, k, v, do, L, delta)
    before = TFA.launches["flash_bwd_dq"]
    runs = [TFA._flash_bwd_dq(*args, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    assert TFA.launches["flash_bwd_dq"] == before + 2
    assert torch.equal(runs[0], runs[1])
    want = torch.cat([TFA._flash_bwd_dq_plain(*(x.chunk(b)[i] for x in args),
                                              **kw) for i in range(b)])
    assert _norm_err(runs[0], want) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_bf16_dq_of_a_row_that_sees_no_key_is_zero_on_card(cuda, d):
    # q_off < k_off with a window: queries 0..k_off - q_off - 1 see no key,
    # so their L is +1e30, P underflows to 0 and dq is exactly 0.
    hq, hkv, tq, tk, q_off, k_off, window = 4, 2, 200, 150, 0, 90, 64
    g = torch.Generator(device="cpu").manual_seed(13)
    q, do = (torch.randn((2 * hq, tq, d), generator=g).bfloat16().to(cuda)
             for _ in range(2))
    k, v = (torch.randn((2 * hkv, tk, d), generator=g).bfloat16().to(cuda)
            for _ in range(2))
    kw = dict(causal=True, q_heads=hq, window=window)
    o, m, l = TFA._flash_call_plain(
        q, k, v, *TFA.zero_carry(2 * hq, tq, d, cuda), q_off, k_off, **kw)
    live = l > 0
    L = torch.where(live, m + torch.log(torch.where(live, l, 1.0)), 1e30)
    delta = (do.float() * (o / torch.where(live, l, 1.0)[..., None])).sum(-1)
    args = (q, k, v, do, L, delta, q_off, k_off)
    dq = TFA._flash_bwd_dq(*args, **kw)
    want = TFA._flash_bwd_dq_plain(*args, **kw)
    torch.cuda.synchronize()
    blind = ~live[0]
    assert blind.sum() == k_off - q_off
    assert not dq[:, blind].any()
    assert _norm_err(dq, want) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_bf16_dq_config_reports_the_wgmma_kernel_on_card(cuda, d):
    cfg = TFA.kernel_config("flash_bwd_dq", torch.bfloat16, d)
    bq, bk = cfg["bq"], cfg["bk"]
    assert cfg["entry"] == "tp_flash_bwd_dq_wgmma"
    assert bq % 64 == 0 and bk % 64 == 0
    assert cfg["threads"] == 128 * (bq // 64)  # a warpgroup per 64 q rows
    # 1 KiB of alignment slack, the q and dO tiles, a two-stage K/V ring.
    assert cfg["smem"] == 1024 + 2 * bq * d * 2 + 4 * bk * d * 2
    assert cfg["ctas_per_sm"] >= 1
    f32 = TFA.kernel_config("flash_bwd_dq", torch.float32, d)
    assert f32["entry"] == "tp_flash_bwd_dq" and f32["ctas_per_sm"] >= 1


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


# ------------------------------ fused ship on in-process ranks (LocalMesh)
# Ranks that live in this process and share cuda:0, each with its own
# streams: their kernels run concurrently (not time-sliced), so these
# tests also prove the grids leave room for each other.

_SHIP_EDGES = {   # tests/test_pallas_dma.py:101, cut to the rank count
    "ring": lambda n: tuple((i, (i + 1) % n) for i in range(n)),
    "shift3": lambda n: tuple((i, (i + 3) % n) for i in range(n)),
    "unidir": lambda n: ((n - 1, 0),),
    "bidir": lambda n: ((0, n - 1), (n - 1, 0)),
    "partial": lambda n: ((0, 1),) if n == 2 else ((0, 1), (3, 2)),
    "empty": lambda n: (),
}


def _local(n):
    from tpu_p2p_torch.parallel.runtime import LocalMesh

    return LocalMesh([torch.device("cuda", 0)] * n), LocalMesh(["cpu"] * n)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_ship_kernel_matches_plain_on_local_ranks_on_card(cuda, n):
    from tpu_p2p_torch.parallel import pallas_dma as PD

    mesh, cpu = _local(n)
    gen = torch.Generator().manual_seed(n)
    payloads = {
        "int8 136 B": [torch.randint(-128, 128, (136,), generator=gen,
                                     dtype=torch.int8) for _ in range(n)],
        "bf16 chunk": [torch.randn((8, 1, 8, 8, 128), generator=gen)
                       .to(torch.bfloat16) for _ in range(n)],
    }
    w = torch.randn((136, 24), generator=gen)
    PD.reset_launches()
    made = 0
    for name, mk in _SHIP_EDGES.items():
        edges = mk(n)
        for what, rows in payloads.items():
            dev_rows = [r.to(cuda) for r in rows]
            ops = [r.float().reshape(-1)[:136].reshape(1, 136).to(cuda)
                   for r in rows]
            arr, y = PD.dma_ship_compute(dev_rows, mesh, edges,
                                         lambda a: a @ w.to(cuda), ops)
            mesh.synchronize()
            made += n
            want, _ = PD.dma_ship_compute(rows, cpu, edges, lambda a: a,
                                          rows)
            for i in range(n):
                assert torch.equal(arr[i].cpu(), want[i]), (name, what, i)
                assert torch.equal(y[i], ops[i] @ w.to(cuda)), (name, i)
    assert PD.launches["dma_ship"] == made
    # Back-to-back waves with changing edge sets, no drain in between:
    # each wave ships the previous wave's arrivals.
    seq = [mk(n) for mk in _SHIP_EDGES.values()] * 2
    x = [torch.randn((3, 1000), generator=gen) for _ in range(n)]
    got, want = [r.to(cuda) for r in x], list(x)
    for edges in seq:
        got, _ = PD.dma_ship_compute(got, mesh, edges, lambda a: a * 2, got)
        want = PD.dma_ppermute(want, cpu, edges)
    mesh.synchronize()
    assert all(torch.equal(g.cpu(), w_) for g, w_ in zip(got, want))
    # The one-shot hop on the same windows, and one backward pass.
    xs = [r.to(cuda).requires_grad_(True) for r in x]
    arr, y = PD.dma_ship_compute(xs, mesh, seq[0], lambda a: a * 3, xs)
    sum((a * a).sum() + b.sum() for a, b in zip(arr, y)).backward()
    rev = tuple((d, s) for s, d in seq[0])
    back = PD.dma_ppermute([2 * a.detach().cpu() for a in arr], cpu, rev)
    for i in range(n):
        assert torch.equal(xs[i].grad.cpu(), back[i] + 3)
    mesh.close()


@pytest.mark.cuda
def test_ship_times_out_when_the_peer_never_pushes(cuda):
    from tpu_p2p_torch.parallel import pallas_dma as PD
    from tpu_p2p_torch.utils.errors import TransferTimeout

    mesh, _ = _local(2)
    rows = [torch.ones(4096, device=cuda) for _ in range(2)]
    tables = PD.complete_permutation(((0, 1), (1, 0)), 2)
    win = PD._begin(mesh, rows)
    outs = [torch.empty_like(r) for r in rows]
    hop = PD._plan(mesh, win, tables, outs)[0]
    # Rank 0 pushes and waits for its arrival; rank 1 never launches.
    PD._launch("tp_dma_ship_push", hop, rows[0], outs[0], mesh, win, 0,
               tables, 0.5, mesh.side_streams[0])
    PD._launch("tp_dma_ship_arrive", hop, None, outs[0], mesh, win, 0,
               tables, 0.5, mesh.streams[0])
    with pytest.raises(TransferTimeout,
                       match="rank 0 gave up waiting for rank 1's .* at "
                             f"epoch {win.epoch}"):
        mesh.synchronize()
    PD.close_windows(mesh.windows)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_back_to_back_hops_survive_allocator_reuse_on_card(cuda, n):
    # Pushes store straight into the receivers' outputs. Between waves,
    # with no drain, the caller copies the arrivals and frees the
    # outputs, and blocks of their size are freed again with a fill still
    # pending behind a sleep on the caller's stream: the next wave's
    # outputs take those blocks, and no push may land before the fill.
    from tpu_p2p_torch.parallel import pallas_dma as PD

    mesh, cpu = _local(n)
    gen = torch.Generator().manual_seed(n + 10)
    x = [torch.randn((3, 1000), generator=gen) for _ in range(n)]
    got, want = [r.to(cuda) for r in x], list(x)
    seq = [mk(n) for mk in _SHIP_EDGES.values()] * 2
    for k, edges in enumerate(seq):
        if k % 2:
            got = PD.dma_ppermute(got, mesh, edges)
        else:
            got, _ = PD.dma_ship_compute(got, mesh, edges,
                                         lambda a: a * 2, got)
        want = PD.dma_ppermute(want, cpu, edges)
        got = [g.clone() for g in got]
        torch.cuda._sleep(200_000)
        junk = [torch.full_like(g, 7.0) for g in got]
        del junk
    mesh.synchronize()
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    mesh.close()


@pytest.mark.cuda
def test_dma_slab_segments_landing_out_of_order_on_card(cuda):
    # A 32 MiB hop between two processes goes through the receiver's slab
    # in 1024 segments; this build pushes them last first, so each lands
    # in the opposite order to the one the arrival copies them out in.
    for rank, res in enumerate(_card_world("card_reversed_segments_case")):
        assert res["bad"] == [], f"rank {rank}: {res['bad']}"
        assert res["launches"] == res["expected_launches"], res


# ------------------------------------------ collectives (NCCL, 2-D mesh)
# The rank-side cases live in tests/torch_collectives_world.py.


def _collective_world(n, case, **kwargs):
    from tpu_p2p_torch.parallel.launch import run_world

    cases = os.path.join(os.path.dirname(__file__),
                         "torch_collectives_world.py")
    return run_world(n, f"{cases}:{case}", kwargs, timeout=900)


@pytest.mark.cuda
def test_nccl_builders_in_a_world_of_1_equal_the_oracles(cuda):
    # Every reduction builder, single and 3-chained, over a real NCCL
    # communicator of one rank, int8 and small-integer float32, bitwise.
    assert _collective_world(1, "card_collectives_case") == [[]]


@pytest.mark.cuda
@pytest.mark.parametrize("n, shape", [(2, None), (4, None), (4, (2, 2))],
                         ids=["ring2", "ring4", "torus2x2"])
def test_axis_rings_over_the_kernel_equal_expected_permute(cuda, n, shape):
    # Ranks sharing cuda:0: full-permutation rings (every rank sends and
    # receives, no dummy edge) along each axis, one hop and 3 hops, each
    # launch counted.
    for rank, res in enumerate(_collective_world(n, "card_permute_case",
                                                 shape=shape)):
        assert res["bad"] == [], f"rank {rank}: {res['bad']}"
        assert res["launches"] == res["made"], res


@pytest.mark.cuda
def test_device_mode_slope_is_positive_and_near_the_host_slope(cuda):
    # The 32 MiB self-edge floor (the loopback rewrite chain, a world of
    # 1): the card's busy-time slope must exist, be positive, and sit
    # within 2x of the host slope, which the card's time dominates here.
    import numpy as np

    from tpu_p2p_torch.parallel import collectives as C
    from tpu_p2p_torch.parallel.runtime import make_runtime
    from tpu_p2p_torch.utils.profiling import measure_headline

    rt = make_runtime(device=cuda)
    try:
        cache = C.CollectiveCache()
        x = C.make_payload(rt.mesh, 32 << 20, np.int8)
        m = measure_headline(lambda k: cache.loopback_chain(rt.mesh, k), x,
                             64, group=rt.mesh.host_group)
        assert m.source == "device_trace" and m.per_op_s > 0, m
        assert m.ok is True, m
    finally:
        rt.close()


# ------------------------------------------ the flagship step's mesh
# chip_smoke.py's phase 10 at a small size: every rank of a ring driven
# through ring_flash's per-hop steps in one process, against the
# full-sequence kernels and the plain hop calls; the step through the
# mesh code on a world of one; ranks sharing a card refused.


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("layout,window", [
    ("contiguous", None), ("zigzag", None), ("contiguous", 100),
    ("zigzag", 100)], ids=["contiguous", "zigzag", "contiguous_window",
                           "zigzag_window"])
def test_ring_hops_on_card_match_full_kernels_and_plain(cuda, n, layout,
                                                        window):
    import chip_smoke
    from tpu_p2p_torch.ops.attention import from_zigzag, to_zigzag

    g = torch.Generator(device="cpu").manual_seed(n)
    bf = torch.bfloat16
    q, do = (torch.randn((2, 4, 512, 64), generator=g).to(cuda, bf)
             for _ in range(2))
    k, v = (torch.randn((2, 2, 512, 64), generator=g).to(cuda, bf)
            for _ in range(2))
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = TFA.flash_attention(*ts, True, window)
    full = (out,) + torch.autograd.grad(out, ts, do)
    args = [to_zigzag(t, n) if layout == "zigzag" else t
            for t in (q, k, v, do)]
    kw = dict(causal=True, layout=layout, window=window)
    TFA.reset_launches()
    got = chip_smoke.ring_in_one_process(
        *args, n, carry_block=TFA.flash_carry_block,
        bwd_block=TFA.flash_bwd_block, **kw)
    torch.cuda.synchronize()
    want_calls = chip_smoke.ring_calls(n, 512 // n, layout, window)
    assert TFA.launches == dict.fromkeys(TFA.launches, want_calls)
    plain = chip_smoke.ring_in_one_process(
        *args, n, carry_block=TFA.flash_carry_block_plain,
        bwd_block=TFA.flash_bwd_block_plain, **kw)
    for a, b in zip(got, plain):
        assert chip_smoke.norm_err(a, b) <= chip_smoke.FLASH_BF16_TOL
    if layout == "zigzag":
        got = tuple(from_zigzag(t, n) for t in got)
    for a, b in zip(got, full):
        assert chip_smoke.norm_err(a, b) <= chip_smoke.FLASH_BF16_TOL


@pytest.mark.cuda
def test_mesh_step_in_a_world_of_one_equals_the_step_and_no_nccl(cuda):
    # The five axes of size 1 launch nothing: bitwise the mesh-free step,
    # and no NCCL kernel on the card in a profiled step.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpu_p2p_torch.models import flagship as F
    from tpu_p2p_torch.parallel.runtime import make_runtime

    cfg = F.FlagshipConfig(batch=2, seq=256, heads=4, kv_heads=2,
                           head_dim=64, stages=2, microbatches=2,
                           dense_ffn=True, vocab=256, use_flash=True,
                           rope=True, norm=True, dtype="bfloat16")
    toks, tgts = F.flagship_token_batch(cfg, seed=1, device=cuda)
    rt = make_runtime(device=cuda, mesh_shape=(1,) * 5, axis_names=F.AXES)
    try:
        results = []
        for mesh in (None, rt.mesh):
            params = F.init_flagship_params(cfg, seed=0, device=cuda)
            step = F.make_flagship_lm_train_step(cfg, mesh=mesh)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                new, loss = step(params, toks, tgts)
                torch.cuda.synchronize()
            names = [e.name for e in prof.events()
                     if e.device_type == DeviceType.CUDA]
            assert names and not [n for n in names if "nccl" in n.lower()]
            results.append((loss, new))
        (l0, p0), (l1, p1) = results
        assert torch.equal(l0, l1)
        for k in p0:
            assert torch.equal(p0[k], p1[k]), k
    finally:
        rt.close()


@pytest.mark.cuda
def test_mesh_step_on_ranks_sharing_a_card_raises(cuda):
    from tpu_p2p_torch.parallel.launch import run_world

    cases = os.path.join(os.path.dirname(__file__), "torch_flagship_world.py")
    for err in run_world(2, f"{cases}:shared_card_case", {}, timeout=600):
        assert err is not None and "needs one card per rank" in err, err


# ------------------------------------------ the benchmark's SP patterns
# chip_smoke.py's phase 13 (a) at a small size: the ring_attention
# entry on a world of one, the flash kernels against the plain path.


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 100], ids=["causal", "window"])
def test_ring_attention_entry_flash_matches_plain_on_card(cuda, window):
    import chip_smoke
    from tpu_p2p_torch.ops import attention as A
    from tpu_p2p_torch.parallel.runtime import make_runtime

    g = torch.Generator(device="cpu").manual_seed(13)
    q, k, v = (torch.randn((2, 4, 512, 64), generator=g).to(
        cuda, torch.bfloat16) for _ in range(3))
    rt = make_runtime(device=cuda)
    try:
        TFA.reset_launches()
        got = A.ring_attention(rt.mesh, "d", True, use_flash=True,
                               window=window)(q, k, v)
        torch.cuda.synchronize()
        assert TFA.launches["flash_fwd"] == 1
        want = A.ring_attention(rt.mesh, "d", True, use_flash=False,
                                window=window)(q, k, v)
        assert TFA.launches["flash_fwd"] == 1
        assert chip_smoke.norm_err(got, want) <= chip_smoke.FLASH_BF16_TOL
    finally:
        rt.close()
