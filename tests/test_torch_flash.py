"""The port's flash attention against the JAX reference, on the CPU.

CPU tensors run the plain versions of the three kernels
(``tpu_p2p_torch/ops/flash_attention.py``); the reference runs its
Pallas kernels in interpret mode, as its own tests do. Inputs come from
numpy seeds and reach both sides as the same float32 arrays.

Tolerances are the reference's own for flash vs dense
(tests/test_flash_train.py): ``atol = rtol = 2e-5`` on forward values
and the carry, ``2e-4`` on gradients — float32 reassociation between
tiled and whole-row sums, and exp2 vs exp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_p2p.ops import attention as JA
from tpu_p2p.ops import flash_attention as JFA
from tpu_p2p_torch.ops import attention as TA
from tpu_p2p_torch.ops import flash_attention as TFA

FWD = dict(atol=2e-5, rtol=2e-5)
BWD = dict(atol=2e-4, rtol=2e-4)
B, HQ, HKV, TQ, TK, D = 2, 4, 2, 32, 48, 8

# (causal, window, q_off, k_off): offsets where q_off != k_off, a window
# that is not a multiple of the 16-row tiles, and q_off < k_off, where
# the first queries see no key at all (fully-masked rows).
CASES = [(False, None, 40, 8), (True, None, 40, 8), (True, 16, 40, 8),
         (True, None, 5, 9), (True, 16, 5, 9)]
IDS = ["dense", "causal", "window16", "causal_masked_rows",
       "window16_masked_rows"]


def _arrays(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               err_msg=what, **tol)


# ------------------------------------------------------ carry forward


@pytest.mark.parametrize("causal,window,q_off,k_off", CASES, ids=IDS)
def test_plain_carry_forward_matches_pallas(causal, window, q_off, k_off):
    q, k, v, o0 = _arrays(0, (B * HQ, TQ, D), (B * HKV, TK, D),
                          (B * HKV, TK, D), (B * HQ, TQ, D))
    m0, = _arrays(1, (B * HQ, TQ))
    l0 = np.random.default_rng(2).random((B * HQ, TQ)).astype(np.float32)
    want = JFA._flash_call(
        *map(jnp.asarray, (q, k, v, o0, m0, l0)), q_off, k_off,
        causal=causal, window=window, block_q=16, block_k=16,
        q_heads=HQ, interpret=True)
    before = dict(TFA.launches)
    for fn in (TFA._flash_call_plain, TFA._flash_call):
        got = fn(*map(_t, (q, k, v, o0, m0, l0)), q_off, k_off,
                 causal=causal, q_heads=HQ, window=window)
        for g, w, name in zip(got, want, "oml"):
            _close(g, w, FWD, name)
    assert TFA.launches == before  # CPU tensors launch nothing


def test_carry_forward_keeps_the_carry_of_fully_masked_rows():
    # Queries at 0..7 against keys from 100: nothing is visible, so the
    # carry passes through (m only through the log2 round trip).
    q, k, v, o0 = _arrays(3, (2, 8, D), (2, 16, D), (2, 16, D), (2, 8, D))
    m0, l0 = _arrays(4, (2, 8), (2, 8))
    o, m, l = TFA._flash_call(*map(_t, (q, k, v, o0, m0, l0)), 0, 100,
                              causal=True, q_heads=1)
    assert torch.equal(o, _t(o0)) and torch.equal(l, _t(l0))
    _close(m, m0, dict(atol=0, rtol=1e-6))


# ----------------------------------------------------------- backward


@pytest.mark.parametrize("causal,window,q_off,k_off", CASES, ids=IDS)
def test_plain_backward_matches_pallas(causal, window, q_off, k_off):
    q, k, v, do = _arrays(5, (B * HQ, TQ, D), (B * HKV, TK, D),
                          (B * HKV, TK, D), (B * HQ, TQ, D))
    L, delta = _arrays(6, (B * HQ, TQ), (B * HQ, TQ))
    L = L + 3.0
    L[:, :3] = 1e30  # rows the forward found fully masked
    want = JFA._flash_bwd_call(
        *map(jnp.asarray, (q, k, v, do, L, delta)), q_off, k_off,
        causal=causal, window=window, block_q=16, block_k=16,
        q_heads=HQ, interpret=True)
    # The reference returns dk/dv per query head; fold each GQA group.
    w_dq = np.asarray(want[0])
    w_dk, w_dv = (np.asarray(a).reshape(B, HKV, HQ // HKV, TK, D).sum(2)
                  .reshape(B * HKV, TK, D) for a in want[1:])
    args = [*map(_t, (q, k, v, do, L, delta)), q_off, k_off]
    kw = dict(causal=causal, q_heads=HQ, window=window)
    before = dict(TFA.launches)
    dq, dk, dv = TFA._flash_bwd_call(*args, **kw)
    _close(dq, w_dq, BWD, "dq")
    _close(dk, w_dk, BWD, "dk")
    _close(dv, w_dv, BWD, "dv")
    assert TFA.launches == before  # CPU tensors launch nothing
    # The per-kernel plain versions, which the card holds the kernels to.
    _close(TFA._flash_bwd_dq_plain(*args, **kw), w_dq, BWD, "dq")
    pk, pv = TFA._flash_bwd_dkdv_plain(*args, **kw)
    _close(pk, w_dk, BWD, "dk")
    _close(pv, w_dv, BWD, "dv")
    # A fully-masked row (L = +1e30) contributes exactly nothing.
    assert torch.count_nonzero(dq[:, :3]) == 0


# ------------------------------------------------- the trainable op


@pytest.mark.parametrize("causal,window", [(False, None), (True, None),
                                           (True, 8), (True, 5)],
                         ids=["dense", "causal", "window8", "window5"])
def test_flash_attention_matches_pallas_and_dense(causal, window):
    q, = _arrays(7, (B, HQ, 32, D))
    k, v = _arrays(8, (B, HKV, 32, D), (B, HKV, 32, D))

    def jloss(fn):
        return lambda q, k, v: jnp.sum(fn(q, k, v).astype(jnp.float32) ** 2)

    jflash = lambda q, k, v: JFA.flash_attention(q, k, v, causal, window)  # noqa: E731
    jargs = tuple(map(jnp.asarray, (q, k, v)))
    want_out = np.asarray(jflash(*jargs))
    want_g = jax.grad(jloss(jflash), argnums=(0, 1, 2))(*jargs)

    def run(fn):
        ts = [_t(a).requires_grad_(True) for a in (q, k, v)]
        out = fn(*ts)
        torch.sum(out.float() ** 2).backward()
        return out, [t.grad for t in ts]

    flash = lambda q, k, v: TFA.flash_attention(q, k, v, causal, window)  # noqa: E731
    dense = lambda q, k, v: TA.dense_attention(q, k, v, causal=causal,  # noqa: E731
                                               window=window)
    out_f, g_f = run(flash)
    out_d, g_d = run(dense)
    _close(out_f, want_out, FWD, "out vs pallas")
    _close(out_f, out_d.detach().numpy(), FWD, "out vs dense")
    for a, b, c, name in zip(g_f, want_g, g_d, "qkv"):
        _close(a, b, BWD, f"d{name} vs pallas")
        _close(a, c.numpy(), BWD, f"d{name} vs dense")


def test_flash_attention_rejects_like_reference():
    x = torch.zeros((1, 2, 8, 4))
    with pytest.raises(ValueError, match="requires causal"):
        TFA.flash_attention(x, x, x, False, 4)
    with pytest.raises(ValueError, match="window must be >= 1"):
        TFA.flash_attention(x, x, x, True, 0)
    with pytest.raises(ValueError, match="multiple of KV heads"):
        TFA.flash_attention(x, torch.zeros((1, 3, 8, 4)),
                            torch.zeros((1, 3, 8, 4)), True)
    with pytest.raises(ValueError, match="no kernel for device"):
        m = x.to("meta")
        TFA._flash_call(m.reshape(2, 8, 4), m.reshape(2, 8, 4),
                        m.reshape(2, 8, 4),
                        *TFA.zero_carry(2, 8, 4, "meta"), causal=True,
                        q_heads=2)


# -------------------------------------------------------- attention.py


@pytest.mark.parametrize("causal,window", [(False, None), (True, None),
                                           (True, 7)])
def test_dense_attention_matches_reference(causal, window):
    q, = _arrays(9, (2, 4, 16, 8))
    k, v = _arrays(10, (2, 2, 16, 8), (2, 2, 16, 8))
    want = JA.dense_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                              window=window)
    got = TA.dense_attention(*map(_t, (q, k, v)), causal=causal,
                             window=window)
    _close(got, want, FWD)


def test_repeat_kv_finalize_merge_match_reference():
    x, = _arrays(11, (2, 2, 5, 3))
    np.testing.assert_array_equal(TA.repeat_kv(_t(x), 6).numpy(),
                                  np.asarray(JA.repeat_kv(jnp.asarray(x), 6)))
    with pytest.raises(ValueError, match="multiple"):
        TA.repeat_kv(_t(x), 3)
    o, s, v = _arrays(12, (2, 3, 4, 5), (2, 3, 4, 6), (2, 3, 6, 5))
    m, = _arrays(13, (2, 3, 4))
    l = np.random.default_rng(14).random((2, 3, 4)).astype(np.float32)
    l[0, 0, :2] = 0.0  # fully-masked rows (o = 0, l = 0) finalize to 0
    o[0, 0, :2] = 0.0
    want = JA.finalize(*map(jnp.asarray, (o, m, l)), jnp.float32)
    got = TA.finalize(*map(_t, (o, m, l)), torch.float32)
    _close(got, want, FWD)
    assert torch.count_nonzero(got[0, 0, :2]) == 0
    want = JA._merge(*map(jnp.asarray, (o, m, l, s, v)))
    got = TA._merge(*map(_t, (o, m, l, s, v)))
    for g, w in zip(got, want):
        _close(g, w, FWD)
