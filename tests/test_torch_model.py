"""The port's model layer against the JAX reference: configs, the
seeded init and the weight carry, the dense LM decode step and the
paged mixed step.

Inputs come from numpy seeds and reach both sides through the carry
(``params_from_numpy``). Tolerances: float32 model steps agree within
``atol=rtol=1e-5`` — the reference's own tolerance for the same kind
of comparison (chunked prefill vs dense, tests/test_serve.py), covering
reassociation between XLA's and ATen's CPU matmuls; copies, configs and
host logic are exact. The port's own paged-vs-dense decode at chunk 1
is bitwise, the reference's load-bearing pin.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_p2p import config as JC
from tpu_p2p.models import decode as JD
from tpu_p2p.models import flagship as JF
from tpu_p2p.serve import paged_cache as JP
from tpu_p2p.serve.engine import serve_mesh
from tpu_p2p_torch import config as TC
from tpu_p2p_torch.models import decode as TD
from tpu_p2p_torch.models import flagship as TF
from tpu_p2p_torch.serve import paged_cache as TP

TOL = dict(atol=1e-5, rtol=1e-5)
MODEL = dict(batch=4, seq=16, heads=4, kv_heads=2, head_dim=8, stages=2,
             microbatches=1, dense_ffn=True, vocab=64, norm=True,
             rope=True)


def _bits(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.view(torch.int16) if a.dtype == torch.bfloat16
                else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _np_params(params):
    return {k: np.asarray(v) for k, v in params.items()}


# ------------------------------------------------------------- configs


def test_parse_range_matches_reference():
    assert TC.parse_range("4:12") == JC.parse_range("4:12") == (4, 12)
    for bad in ("12:4", "0:5", "x:y", "5"):
        with pytest.raises(ValueError):
            JC.parse_range(bad)
        with pytest.raises(ValueError):
            TC.parse_range(bad)


_SC = dict(slots=4, page_len=8, num_pages=24, max_blocks=3, chunk=4,
           requests=6, seed=0, rate=1.0, prompt_len=(4, 12),
           gen_len=(4, 8), vocab=64)


@pytest.mark.parametrize("bad,match", [
    (dict(chunk=3), "chunk"),
    (dict(page_len=12), "page_len"),
    (dict(batching="rolling"), "batching"),
    (dict(prompt_len=(30, 30), gen_len=(8, 8)), "overruns"),
    (dict(rate=0.0), "rate"),
    (dict(spec_k=8), "spec_k"),
    (dict(stop="eos", eos_prob=1.0), "eos_prob"),
    (dict(queue_depth=-1), "queue_depth"),
    (dict(gen_len=(5, 4)), "gen_len"),
    (dict(slots=0), "slots"),
])
def test_serve_config_rejects_like_reference(bad, match):
    kw = {**_SC, **bad}
    with pytest.raises(ValueError, match=match):
        JC.ServeConfig(**kw)
    with pytest.raises(ValueError, match=match):
        TC.ServeConfig(**kw)


def test_serve_config_accepts_like_reference():
    for kw in (_SC, {**_SC, "spec_k": 7, "prefix_cache": True},
               {**_SC, "stop": "eos", "eos_prob": 0.2, "queue_depth": 3}):
        j, t = JC.ServeConfig(**kw), TC.ServeConfig(**kw)
        for k in kw:
            assert getattr(j, k) == getattr(t, k)
    assert TC.BATCHING == JC.BATCHING
    assert TC.SERVE_STOPS == JC.SERVE_STOPS


@pytest.mark.parametrize("kw", [
    MODEL,
    dict(heads=16, kv_heads=8, head_dim=128, stages=8, dense_ffn=True,
         moe_mult=4, vocab=32768, rope=True, norm=True, dtype="bfloat16"),
    dict(heads=8, kv_heads=0, dtype="bfloat16", param_dtype="float32"),
], ids=["tiny", "flagship_large", "mixed"])
def test_flagship_config_properties_match_reference(kw):
    j, t = JF.FlagshipConfig(**kw), TF.FlagshipConfig(**kw)
    assert (t.model_dim, t.num_kv_heads, t.params_dtype) \
        == (j.model_dim, j.num_kv_heads, j.params_dtype)
    assert TF.flagship_param_shapes(t) == JF.flagship_param_shapes(j)


# ------------------------------------------------------- params carry


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_equals_reference_and_carry_round_trips(dtype):
    kw = {**MODEL, "dtype": dtype}
    ref = _np_params(JF.init_flagship_params(JF.FlagshipConfig(**kw),
                                             seed=3))
    own = TF.init_flagship_params(TF.FlagshipConfig(**kw), seed=3,
                                  device="cpu")
    carried = TF.params_from_numpy(ref, "cpu")
    assert list(own) == list(ref)
    for k in ref:
        # float64 -> float32/bf16 rounding agrees with the reference,
        # so the port's own init needs no carry at either dtype.
        np.testing.assert_array_equal(_bits(own[k]), _bits(ref[k]),
                                      err_msg=k)
        np.testing.assert_array_equal(_bits(carried[k]), _bits(ref[k]),
                                      err_msg=k)
    # The carry copies read-only host views: writing the tensor leaves
    # the source array alone.
    carried["wq"].zero_()
    assert np.any(_bits(ref["wq"]) != 0)


def test_pool_carry_is_bitwise():
    arr = np.asarray(jnp.asarray(np.arange(24.0).reshape(2, 3, 4) / 7,
                                 jnp.bfloat16))
    got = TF.pool_from_numpy({"k": arr, "v": arr}, "cpu")
    np.testing.assert_array_equal(_bits(got["k"]), _bits(arr))
    assert got["k"].data_ptr() != got["v"].data_ptr()


# --------------------------------------------------- decode and paged


def _setup(seed=1, T=16, **kw):
    mk = {**MODEL, **kw}
    jcfg, tcfg = JF.FlagshipConfig(**mk), TF.FlagshipConfig(**mk)
    np_params = _np_params(JF.init_flagship_params(jcfg))
    toks = np.random.default_rng(seed).integers(
        0, mk["vocab"], (mk["batch"], T)).astype(np.int32)
    return jcfg, tcfg, np_params, toks


def _jax_dense(jcfg, np_params, toks):
    mesh = serve_mesh(1)
    params = JF.place_flagship_params(
        {k: jnp.asarray(v) for k, v in np_params.items()}, mesh)
    step = JD.make_flagship_lm_decode_step(mesh, jcfg)
    cache = JD.init_kv_cache(jcfg, max_len=toks.shape[1], mesh=mesh)
    out = []
    for t in range(toks.shape[1]):
        cache, lg = step(params, cache, jnp.asarray(toks[:, t:t + 1]), t)
        out.append(np.asarray(lg)[:, 0])
    return np.stack(out, 1), {k: np.asarray(v) for k, v in cache.items()}


def _torch_dense(tcfg, np_params, toks):
    params = TF.params_from_numpy(np_params, "cpu")
    step = TD.make_flagship_lm_decode_step(tcfg)
    cache = TD.init_kv_cache(tcfg, toks.shape[1], "cpu")
    out = []
    for t in range(toks.shape[1]):
        cache, lg = step(params, cache,
                         torch.from_numpy(toks[:, t:t + 1]).long(), t)
        out.append(lg[:, 0].numpy())
    return np.stack(out, 1), cache


def _tables(batch, max_blocks):
    """Each slot owns max_blocks distinct pages (page 0 is trash)."""
    return (1 + np.arange(batch * max_blocks, dtype=np.int32)
            ).reshape(batch, max_blocks)


def _teacher_force_paged(run_step, batch, toks, chunk):
    """Feed ``toks`` through a paged step in ``chunk``-token slices;
    → logits ``[B, T, V]``."""
    T = toks.shape[1]
    got = []
    pos = 0
    while pos < T:
        n = min(chunk, T - pos)
        tk = np.zeros((batch, chunk), np.int32)
        tk[:, :n] = toks[:, pos:pos + n]
        lg = run_step(tk, np.full(batch, pos, np.int32),
                      np.full(batch, n, np.int32))
        got.append(np.asarray(lg)[:, :n])
        pos += n
    return np.concatenate(got, 1)


def _jax_paged(jcfg, np_params, toks, chunk, page_len=8, max_blocks=2):
    mesh = serve_mesh(1)
    params = JF.place_flagship_params(
        {k: jnp.asarray(v) for k, v in np_params.items()}, mesh)
    step = JP.make_paged_lm_step(mesh, jcfg, page_len=page_len,
                                 max_blocks=max_blocks, chunk=chunk)
    b = toks.shape[0]
    state = {"pool": JP.init_paged_pool(jcfg, b * max_blocks + 1,
                                        page_len, mesh)}
    table = jnp.asarray(_tables(b, max_blocks))

    def run(tk, pos, n):
        state["pool"], lg = step(params, state["pool"], jnp.asarray(tk),
                                 jnp.asarray(pos), jnp.asarray(n), table)
        return lg

    logits = _teacher_force_paged(run, b, toks, chunk)
    return logits, {k: np.asarray(v) for k, v in state["pool"].items()}


def _torch_paged(tcfg, np_params, toks, chunk, page_len=8, max_blocks=2):
    params = TF.params_from_numpy(np_params, "cpu")
    step = TP.make_paged_lm_step(tcfg, page_len=page_len,
                                 max_blocks=max_blocks, chunk=chunk)
    b = toks.shape[0]
    pool = TP.init_paged_pool(tcfg, b * max_blocks + 1, page_len, "cpu")
    table = torch.from_numpy(_tables(b, max_blocks)).long()

    def run(tk, pos, n):
        _, lg = step(params, pool, torch.from_numpy(tk).long(),
                     torch.from_numpy(pos).long(),
                     torch.from_numpy(n).long(), table)
        return lg.numpy()

    return _teacher_force_paged(run, b, toks, chunk), pool


def test_dense_decode_step_matches_reference():
    jcfg, tcfg, np_params, toks = _setup()
    want, want_cache = _jax_dense(jcfg, np_params, toks)
    got, cache = _torch_dense(tcfg, np_params, toks)
    np.testing.assert_allclose(got, want, **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].numpy(), want_cache[k], **TOL)


@pytest.mark.parametrize("chunk", [1, 4, 8])
def test_paged_step_matches_reference(chunk):
    jcfg, tcfg, np_params, toks = _setup(seed=2)
    want, want_pool = _jax_paged(jcfg, np_params, toks, chunk)
    got, pool = _torch_paged(tcfg, np_params, toks, chunk)
    np.testing.assert_allclose(got, want, **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(pool[k].numpy(), want_pool[k], **TOL)


@pytest.mark.parametrize("kw", [{}, dict(heads=8, kv_heads=2, batch=8)],
                         ids=["gqa2", "gqa4_b8"])
def test_paged_decode_bitwise_vs_dense_teacher_forced(kw):
    # The load-bearing pin, on the port alone: chunk-1 paged decode
    # equals the dense decode step bitwise per position (one shared
    # _attend_ffn body; NEG_INF-masked page garbage).
    _, tcfg, np_params, toks = _setup(seed=4, **kw)
    dense, _ = _torch_dense(tcfg, np_params, toks)
    paged, _ = _torch_paged(tcfg, np_params, toks, chunk=1)
    np.testing.assert_array_equal(paged, dense)


def test_paged_step_validates_inputs():
    tcfg = TF.FlagshipConfig(**MODEL)
    with pytest.raises(ValueError, match="chunk"):
        TP.make_paged_lm_step(tcfg, page_len=8, max_blocks=2, chunk=3)
    with pytest.raises(ValueError, match="page_len"):
        TP.make_paged_lm_step(tcfg, page_len=12, max_blocks=2, chunk=1)
    with pytest.raises(ValueError, match="vocab"):
        TP.make_paged_lm_step(TF.FlagshipConfig(**{**MODEL, "vocab": 0}),
                              page_len=8, max_blocks=2, chunk=1)
    with pytest.raises(ValueError, match="attn_window"):
        TP.make_paged_lm_step(
            TF.FlagshipConfig(**{**MODEL, "attn_window": 8}),
            page_len=8, max_blocks=2, chunk=1)
    with pytest.raises(ValueError, match="page_len"):
        TP.init_paged_pool(tcfg, num_pages=8, page_len=12, device="cpu")


@pytest.mark.parametrize("chunk", [1, 4])
def test_moe_paged_step_matches_reference(chunk):
    # The MoE FFN in the paged step (every expert on the device): the
    # step's rows route together, as in the reference.
    jcfg, tcfg, np_params, toks = _setup(seed=3, dense_ffn=False,
                                         num_experts=4)
    want, want_pool = _jax_paged(jcfg, np_params, toks, chunk)
    got, pool = _torch_paged(tcfg, np_params, toks, chunk)
    np.testing.assert_allclose(got, want, **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(pool[k].numpy(), want_pool[k], **TOL)


def test_kv_page_bytes_matches_reference():
    for dtype in ("float32", "bfloat16"):
        kw = {**MODEL, "dtype": dtype}
        assert TP.kv_page_bytes(TF.FlagshipConfig(**kw), 32) \
            == JP.kv_page_bytes(JF.FlagshipConfig(**kw), 32)
