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
