"""The port's KV-cache writes against the JAX reference.

The plain versions (what the port runs on CPU tensors) must equal the
reference's Pallas kernels (interpret mode on the CPU) and their DUS
fallback, and a row-by-row numpy oracle, bitwise — these are copies —
in float32 and bfloat16. The hand-written CUDA kernels are held against
the plain versions on the card in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_p2p.ops import kvcache as KV
from tpu_p2p_torch.models.flagship import tensor_from_numpy
from tpu_p2p_torch.ops import kvcache as TK

DTYPES = ["float32", "bfloat16"]


def _bits(a):
    """Bit pattern of a numpy/JAX/torch array, for exact comparison."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.view(torch.int16) if a.dtype == torch.bfloat16
                else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _paged_case(dtype, seed=0):
    """The reference's band-kernel vectors (tests/test_serve.py): pages,
    bands, in-band offsets, a 4-row chunk and the n=0 no-op."""
    S, P, H, L, Dh = 2, 5, 2, 16, 8
    rng = np.random.default_rng(seed)
    pool = np.asarray(jnp.asarray(rng.standard_normal((S, P, H, L, Dh)),
                                  jnp.dtype(dtype)))
    slab8 = rng.standard_normal((4, H, 8, Dh)).astype(np.float32)
    idx = {"page": np.array([1, 3, 4, 0], np.int32),
           "band": np.array([1, 0, 1, 0], np.int32),
           "r0": np.array([2, 0, 7, 0], np.int32),
           "n": np.array([1, 4, 1, 0], np.int32)}
    return pool, slab8, idx


def _paged_oracle(pool, slab8, idx, stage):
    want = pool.copy()
    slab = np.asarray(jnp.asarray(slab8, pool.dtype))
    for i in range(slab8.shape[0]):
        for r in range(idx["r0"][i], idx["r0"][i] + idx["n"][i]):
            want[stage, idx["page"][i], :, idx["band"][i] * 8 + r, :] = \
                slab[i, :, r, :]
    return want


@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_rows_write_plain_matches_reference_and_oracle(dtype):
    pool, slab8, idx = _paged_case(dtype)
    want = _paged_oracle(pool, slab8, idx, stage=1)
    j = {k: jnp.asarray(v) for k, v in idx.items()}
    for pallas in (True, False):
        got_j = jax.jit(
            lambda p, pl_=pallas: KV.paged_rows_write(
                p, jnp.asarray(slab8), j["page"], j["band"], j["r0"],
                j["n"], 1, pallas=pl_)
        )(jnp.asarray(pool))
        np.testing.assert_array_equal(_bits(got_j), _bits(want))
    t_pool = tensor_from_numpy(pool, "cpu")
    before = dict(TK.launches)
    out = TK.paged_rows_write(
        t_pool, torch.from_numpy(slab8),
        *(torch.from_numpy(idx[k]) for k in ("page", "band", "r0", "n")),
        stage=1)
    assert out is t_pool  # in place, like the reference's donation
    np.testing.assert_array_equal(_bits(t_pool), _bits(want))
    assert TK.launches == before  # CPU tensors never count a launch


@pytest.mark.parametrize("dtype", DTYPES)
def test_cache_row_write_plain_matches_reference(dtype):
    S, B, H, T, Dh = 2, 3, 2, 16, 8
    rng = np.random.default_rng(1)
    cache = np.asarray(jnp.asarray(
        rng.standard_normal((S, B, H, T, Dh)), jnp.dtype(dtype)))
    slab = rng.standard_normal((B, H, 1, Dh)).astype(np.float32)
    for pos, stage in ((5, 1), (0, 0), (15, 1)):
        got_j = jax.jit(
            lambda c, p=pos, s=stage: KV.cache_row_write(
                c, jnp.asarray(slab), jnp.int32(p), s)
        )(jnp.asarray(cache))
        want = cache.copy()
        want[stage, :, :, pos, :] = np.asarray(
            jnp.asarray(slab[:, :, 0, :], jnp.dtype(dtype)))
        np.testing.assert_array_equal(_bits(got_j), _bits(want))
        t_cache = tensor_from_numpy(cache, "cpu")
        TK.cache_row_write(t_cache, torch.from_numpy(slab), pos, stage)
        np.testing.assert_array_equal(_bits(t_cache), _bits(want))


def test_paged_rows_write_validates_like_reference():
    z = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="page_len"):
        TK.paged_rows_write(torch.zeros((1, 2, 1, 12, 4)),
                            torch.zeros((1, 1, 8, 4)), z, z, z, z, 0)
    with pytest.raises(ValueError, match="slab8"):
        TK.paged_rows_write(torch.zeros((1, 2, 1, 16, 4)),
                            torch.zeros((1, 2, 8, 4)), z, z, z, z, 0)
    with pytest.raises(ValueError, match="stage"):
        TK.paged_rows_write(torch.zeros((1, 2, 1, 16, 4)),
                            torch.zeros((1, 1, 8, 4)), z, z, z, z, 1)
    with pytest.raises(ValueError, match="pos"):
        TK.cache_row_write(torch.zeros((1, 1, 1, 8, 4)),
                           torch.zeros((1, 1, 1, 4)), 8, 0)
    with pytest.raises(ValueError, match="slab"):
        TK.cache_row_write(torch.zeros((1, 1, 1, 8, 4)),
                           torch.zeros((1, 2, 1, 4)), 0, 0)


def test_vector_width_follows_row_size_and_alignment():
    t = torch.zeros(64, dtype=torch.float32)
    assert TK._vec_bytes(256, t) == 16
    assert TK._vec_bytes(12, t) == 4
    assert TK._vec_bytes(6, t) == 2
    assert TK._vec_bytes(256, t[1:]) == 4   # base pointer 4-aligned


# ------------------------------------- fused K+V writes (one launch each)

from tpu_p2p.serve import paged_cache as JP  # noqa: E402
from tpu_p2p_torch.models import decode as TD  # noqa: E402
from tpu_p2p_torch.models import flagship as TF  # noqa: E402
from tpu_p2p_torch.serve import paged_cache as TP  # noqa: E402

_LAYOUTS = ["contiguous", "strided"]


def _rows_pair(rng, b, h, c, dh, layout):
    """K and V rows ``[B, H, C, Dh]`` as numpy (the JAX operands) and as
    torch tensors in ``layout``: ``strided`` gives K as the permuted
    view of a ``[B, C, H, Dh]`` tensor (an einsum's output layout) and
    V as a slice of rows out of a wider tensor."""
    k = rng.standard_normal((b, h, c, dh)).astype(np.float32)
    v = rng.standard_normal((b, h, c, dh)).astype(np.float32)
    if layout == "contiguous":
        return (k, v), (torch.from_numpy(k), torch.from_numpy(v))
    tk = torch.from_numpy(np.ascontiguousarray(
        k.transpose(0, 2, 1, 3))).permute(0, 2, 1, 3)
    wide = np.zeros((b, h, c + 3, dh), np.float32)
    wide[:, :, 1:1 + c] = v
    tv = torch.from_numpy(wide)[:, :, 1:1 + c]
    assert not tv.is_contiguous() and (c == 1 or not tk.is_contiguous())
    return (k, v), (tk, tv)


@pytest.mark.parametrize("layout", _LAYOUTS)
@pytest.mark.parametrize("n,c", [(0, 8), (1, 1), (1, 8), (4, 8), (8, 8)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_kv_write_plain_matches_two_reference_band_writes(
        dtype, n, c, layout):
    # One fused write == the reference's two band writes, each fed by
    # its own _place_band_rows, at every in-band r0; slot 3 idles on
    # the trash page.
    S, P, H, L, Dh, B, stage = 2, 6, 2, 16, 8, 4, 1
    rng = np.random.default_rng(10 + n)
    pools = [np.asarray(jnp.asarray(rng.standard_normal((S, P, H, L, Dh)),
                                    jnp.dtype(dtype))) for _ in range(2)]
    (k, v), (tk, tv) = _rows_pair(rng, B, H, c, Dh, layout)
    page = np.array([1, 3, 5, 0], np.int32)
    band = np.array([1, 0, 1, 0], np.int32)
    nn = np.array([n, n, n, 0], np.int32)

    @jax.jit
    def ref(kp, vp, r0):
        j = [jnp.asarray(x) for x in (page, band, r0, nn)]
        kp = KV.paged_rows_write(kp, JP._place_band_rows(jnp.asarray(k),
                                                         j[2]),
                                 *j, stage)
        vp = KV.paged_rows_write(vp, JP._place_band_rows(jnp.asarray(v),
                                                         j[2]),
                                 *j, stage)
        return kp, vp

    for r in range(0, 8 - n + 1 if n else 8):
        r0 = np.array([r, r, r, 0], np.int32)
        want_k, want_v = ref(jnp.asarray(pools[0]), jnp.asarray(pools[1]),
                             jnp.asarray(r0))
        got_k, got_v = (tensor_from_numpy(p, "cpu") for p in pools)
        before = dict(TK.launches)
        out = TK.paged_kv_write(
            got_k, got_v, tk, tv,
            *(torch.from_numpy(x) for x in (page, band, r0, nn)), stage)
        assert out[0] is got_k and out[1] is got_v     # in place
        assert TK.launches == before   # CPU tensors never count a launch
        np.testing.assert_array_equal(_bits(got_k), _bits(want_k))
        np.testing.assert_array_equal(_bits(got_v), _bits(want_v))
        if n == 0:
            np.testing.assert_array_equal(_bits(got_k), _bits(pools[0]))


@pytest.mark.parametrize("layout", _LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cache_kv_write_plain_matches_two_reference_row_writes(dtype,
                                                               layout):
    S, B, H, T, Dh = 2, 3, 2, 16, 8
    rng = np.random.default_rng(2)
    caches = [np.asarray(jnp.asarray(rng.standard_normal((S, B, H, T, Dh)),
                                     jnp.dtype(dtype))) for _ in range(2)]
    (k, v), (tk, tv) = _rows_pair(rng, B, H, 1, Dh, layout)

    @jax.jit
    def ref(kc, vc, pos, stage):
        return (KV.cache_row_write(kc, jnp.asarray(k), pos, 1),
                KV.cache_row_write(vc, jnp.asarray(v), pos, 1))

    for pos in (0, 5, 15):
        want_k, want_v = ref(jnp.asarray(caches[0]), jnp.asarray(caches[1]),
                             jnp.int32(pos), 1)
        got_k, got_v = (tensor_from_numpy(c, "cpu") for c in caches)
        out = TK.cache_kv_write(got_k, got_v, tk, tv, pos, 1)
        assert out[0] is got_k and out[1] is got_v
        np.testing.assert_array_equal(_bits(got_k), _bits(want_k))
        np.testing.assert_array_equal(_bits(got_v), _bits(want_v))


def test_fused_writes_validate_before_any_copy():
    z = torch.zeros((2,), dtype=torch.int32)
    pool = torch.zeros((1, 3, 2, 16, 4))
    rows = torch.zeros((2, 2, 4, 4))
    with pytest.raises(ValueError, match="unit stride on Dh"):
        TK.paged_kv_write(pool, pool.clone(), rows,
                          torch.zeros((2, 2, 4, 8))[..., ::2], z, z, z, z, 0)
    with pytest.raises(ValueError, match="K and V pools differ"):
        TK.paged_kv_write(pool, torch.zeros((1, 3, 2, 8, 4)), rows, rows,
                          z, z, z, z, 0)
    with pytest.raises(ValueError, match="K and V pools differ"):
        TK.paged_kv_write(pool, pool.to(torch.bfloat16), rows, rows,
                          z, z, z, z, 0)
    with pytest.raises(ValueError, match="C <= 8"):
        TK.paged_kv_write(pool, pool.clone(), torch.zeros((2, 2, 9, 4)),
                          torch.zeros((2, 2, 9, 4)), z, z, z, z, 0)
    with pytest.raises(ValueError, match="r0 must be an int vector"):
        TK.paged_kv_write(pool, pool.clone(), rows, rows, z, z,
                          torch.zeros(2), z, 0)
    cache = torch.zeros((1, 2, 2, 8, 4))
    one = torch.zeros((2, 2, 1, 4))
    with pytest.raises(ValueError, match="K and V pools differ"):
        TK.cache_kv_write(cache, cache.to(torch.float64), one, one, 0, 0)
    with pytest.raises(ValueError, match="unit stride on Dh"):
        TK.cache_kv_write(cache, cache.clone(), one,
                          torch.zeros((2, 2, 1, 8))[..., ::2], 0, 0)
    with pytest.raises(ValueError, match="pos"):
        TK.cache_kv_write(cache, cache.clone(), one, one, 8, 0)


def _count_calls(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def counting(*args, **kw):
        calls.append(args[-1])                    # the stage
        return real(*args, **kw)

    monkeypatch.setattr(module, name, counting)
    return calls


@pytest.mark.parametrize("stages", [1, 3])
def test_steps_write_kv_once_per_layer(monkeypatch, stages):
    # The paged step and the dense decode step each write a layer's K
    # and V in one fused call, and build no band image.
    cfg = TF.FlagshipConfig(batch=2, seq=16, heads=4, kv_heads=2,
                            head_dim=8, stages=stages, microbatches=1,
                            dense_ffn=True, vocab=32, norm=True, rope=True)
    params = TF.init_flagship_params(cfg, seed=0, device="cpu")
    paged = _count_calls(monkeypatch, TP, "paged_kv_write")
    dense = _count_calls(monkeypatch, TD, "cache_kv_write")
    single = _count_calls(monkeypatch, TK, "paged_rows_write") \
        + _count_calls(monkeypatch, TK, "cache_row_write")
    step = TP.make_paged_lm_step(cfg, page_len=8, max_blocks=2, chunk=4)
    pool = TP.init_paged_pool(cfg, 5, 8, "cpu")
    table = torch.tensor([[1, 2], [3, 4]])
    tokens = torch.tensor([[1, 2, 3, 4], [5, 6, 0, 0]])
    step(params, pool, tokens, torch.tensor([0, 4]), torch.tensor([4, 2]),
         table)
    assert paged == list(range(stages))
    dstep = TD.make_flagship_lm_decode_step(cfg)
    cache = TD.init_kv_cache(cfg, 8, "cpu")
    for t in range(2):
        dstep(params, cache, torch.tensor([[1], [2]]), t)
    assert dense == list(range(stages)) * 2
    assert single == []
    assert not hasattr(TP, "_place_band_rows")


# ------------------------- the launch path on the CPU, into a fake library


class _FakeLib:
    """Stands in for the built ``kvcache`` library: each ``tp_kv_*``
    entry point records its name and arguments and returns ``err``."""

    def __init__(self, err=0):
        self.calls, self.err = [], err

    def __getattr__(self, name):
        if not name.startswith("tp_kv_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return self.err

        return entry


@pytest.fixture
def fake(monkeypatch):
    """CPU tensors take the kernel path, into a fake library on a fake
    stream (77)."""
    lib = _FakeLib()
    monkeypatch.setattr(TK, "_lib", lambda: lib)
    monkeypatch.setattr(TK, "_on_card", lambda t: True)
    monkeypatch.setattr(TK, "_launch", lambda fn, dev, *a: fn(*a, 77))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "fake")
    return lib


def test_paged_kv_write_launch_arguments(fake):
    # The C order of tp_kv_rows_paged: K's pool, rows and byte strides,
    # V's, the four index vectors, then nproj, src_at_r0, C, B, stage,
    # pages, heads, page_len, row bytes, vector, threads, stream.
    S, P, H, L, Dh, B, C = 2, 5, 2, 16, 8, 3, 4
    kp, vp = torch.zeros((S, P, H, L, Dh)), torch.zeros((S, P, H, L, Dh))
    k = torch.zeros((B, C, H, Dh)).permute(0, 2, 1, 3)
    v = torch.zeros((B, H, C + 1, Dh))[:, :, 1:]
    idx = [torch.zeros(B, dtype=torch.int32) for _ in range(4)]
    before = dict(TK.launches)
    TK.paged_kv_write(kp, vp, k, v, *idx, 1)
    (name, args), = fake.calls
    assert name == "tp_kv_rows_paged"
    assert args == (
        kp.data_ptr(), k.data_ptr(), C * H * Dh * 4, Dh * 4, H * Dh * 4,
        vp.data_ptr(), v.data_ptr(), H * (C + 1) * Dh * 4,
        (C + 1) * Dh * 4, Dh * 4, *(t.data_ptr() for t in idx),
        2, 0, C, B, 1, P, H, L, Dh * 4, 16, 32, 77)
    assert TK.launches["paged_kv_write"] == before["paged_kv_write"] + 1
    # The band-image form: one destination (V's slots repeat K's), the
    # source read from r0; int64 indices become int32 copies.
    slab8 = torch.zeros((B, H, 8, Dh))
    idx64 = [torch.zeros(B, dtype=torch.int64) for _ in range(4)]
    TK.paged_rows_write(kp, slab8, *idx64, 0)
    name, args = fake.calls[-1]
    assert args[:10] == (kp.data_ptr(), slab8.data_ptr(), *args[2:5],
                         kp.data_ptr(), slab8.data_ptr(), *args[2:5])
    assert all(a not in (t.data_ptr() for t in idx64) for a in args[10:14])
    assert args[14:] == (1, 1, 8, B, 0, P, H, L, Dh * 4, 16, 32, 77)


def test_cache_kv_write_launch_arguments_and_refusals(fake):
    S, B, H, T, Dh = 2, 3, 2, 16, 6
    kc, vc = torch.zeros((S, B, H, T, Dh)), torch.zeros((S, B, H, T, Dh))
    k = torch.zeros((B, H, 1, Dh))
    v = torch.zeros((B, 1, H, Dh)).permute(0, 2, 1, 3)
    TK.cache_kv_write(kc, vc, k, v, 5, 1)
    (name, args), = fake.calls
    assert name == "tp_kv_rows_dense"
    # 24-byte rows: 8-byte vectors, one warp a CTA.
    assert args == (kc.data_ptr(), k.data_ptr(), H * Dh * 4, Dh * 4,
                    vc.data_ptr(), v.data_ptr(), H * Dh * 4, Dh * 4,
                    2, 5, B, 1, H, T, Dh * 4, 8, 32, 77)
    fake.err = 9
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        TK.cache_kv_write(kc, vc, k, v, 5, 1)
    fake.err, n = 0, len(fake.calls)
    with pytest.raises(ValueError, match="contiguous"):
        TK.cache_kv_write(kc.transpose(3, 4).contiguous().transpose(3, 4),
                          vc, k, v, 5, 1)
    assert len(fake.calls) == n
