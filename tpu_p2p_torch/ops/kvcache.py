"""KV-cache row writes — the two kernels of the serving path.

Port of ``tpu_p2p/ops/kvcache.py``. Each write has three forms side by
side:

- the **kernel**, hand-written CUDA C++ for Hopper
  (``tpu_p2p_torch/csrc/kvcache.cu``, built by
  :mod:`tpu_p2p_torch.utils.cuda_build`), launched for CUDA tensors;
- the **plain version** (``*_plain``), indexed copies in PyTorch, used
  for CPU tensors and as the kernel's yardstick on the card;
- the **wrapper** (:func:`paged_rows_write`, :func:`cache_row_write`),
  which validates, casts the slab to the pool dtype as the reference
  does, and picks the form by the pool's device: the plain version for
  a CPU tensor, the kernel for a CUDA tensor (no fallback — a CUDA
  tensor the kernel cannot take raises).

Both write in place and return the updated tensor: the reference
donates the buffer (``input_output_aliases``), the port mutates it.

What bounds them and what the design does about it: both are pure data
movement — each live row read once from the slab and written once into
the pool. The TPU kernels move a whole 8-row band (TPU blocks are 8
rows deep); the Hopper kernels move exactly the live rows, one CTA per
(slot, KV head) copying its contiguous run of rows in 16-byte vectors.
"""

from __future__ import annotations

import ctypes

import torch

# Kernel launches per wrapper since the last reset — a plain count, so
# a run can show that its main path went through the kernels. Only a
# launch counts: the plain version (CPU) adds nothing.
launches = {"paged_rows_write": 0, "cache_row_write": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


_argtypes_set = False


def _lib():
    """The built kernel library, with its C signatures declared."""
    global _argtypes_set
    from tpu_p2p_torch.utils.cuda_build import load

    lib = load("kvcache")
    if not _argtypes_set:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tp_paged_rows_write.argtypes = [p, p, p, p, p, p, i, i, i, i,
                                            i, i, i, p]
        lib.tp_paged_rows_write.restype = i
        lib.tp_cache_row_write.argtypes = [p, p, i, i, i, i, i, i, i, p]
        lib.tp_cache_row_write.restype = i
        _argtypes_set = True
    return lib


def _vec_bytes(row_bytes: int, *tensors: torch.Tensor) -> int:
    """Widest vector (16/8/4/2 bytes) that divides the row size and
    every base pointer, so each access is aligned."""
    for v in (16, 8, 4, 2):
        if row_bytes % v == 0 and all(t.data_ptr() % v == 0
                                      for t in tensors):
            return v
    raise ValueError(f"row of {row_bytes} bytes is not 2-byte aligned")


def _check_launch(err: int, what: str) -> None:
    if err:
        raise RuntimeError(
            f"{what} kernel launch failed: CUDA error {err} "
            f"({torch.cuda.get_device_name()})"
        )


def _cuda_operands(dst: torch.Tensor, *others: torch.Tensor) -> None:
    if not dst.is_contiguous():
        raise ValueError("the cache/pool must be contiguous to be "
                         "written in place by the kernel")
    for t in others:
        if t.device != dst.device:
            raise ValueError(
                f"operand on {t.device}, cache/pool on {dst.device}")


# ------------------------------------------------------ paged band write


def paged_rows_write_plain(pool, slab8, page_ids, band_ids, r0, n,
                           stage: int):
    """Plain version of the paged write: one indexed slice copy per
    live slot. Same arguments and result as :func:`paged_rows_write`."""
    for b, (pg, bd, r, k) in enumerate(zip(page_ids.tolist(),
                                           band_ids.tolist(), r0.tolist(),
                                           n.tolist())):
        if k > 0:
            row = bd * 8 + r
            pool[stage, pg, :, row:row + k, :] = slab8[b, :, r:r + k, :]
    return pool


def paged_rows_write(pool, slab8, page_ids, band_ids, r0, n, stage: int):
    """In-place write of each slot's token rows into its page of
    ``pool [stages, num_pages, H, page_len, Dh]``.

    ``slab8 [B, H, 8, Dh]``: per-slot band image with the slot's
    ``n[b]`` live rows at rows ``r0[b] .. r0[b]+n[b]-1``; those rows land
    at ``pool[stage, page_ids[b], :, band_ids[b]*8 + r0[b] + i, :]``.
    ``page_ids``/``band_ids``/``r0``/``n``: int vectors ``[B]`` on the
    pool's device. ``n == 0`` writes nothing (idle slots park on the
    trash page). The caller keeps each slot's rows inside one 8-row band
    and never gives two live slots the same page.

    Replaces ``tpu_p2p/ops/kvcache.py::_paged_band_kernel`` (:89).
    """
    if pool.dim() != 5 or slab8.dim() != 4:
        raise ValueError(
            f"pool must be [S, P, H, L, Dh] and slab8 [B, H, 8, Dh]; got "
            f"{tuple(pool.shape)} and {tuple(slab8.shape)}")
    s_, p_, h, plen, dh = pool.shape
    b = slab8.shape[0]
    if plen % 8:
        raise ValueError(
            f"page_len ({plen}) must be a multiple of the 8-row band "
            "granularity"
        )
    if tuple(slab8.shape) != (b, h, 8, dh):
        raise ValueError(
            f"slab8 {tuple(slab8.shape)} does not match the pool's "
            f"(B, {h}, 8, {dh})")
    for name, v in (("page_ids", page_ids), ("band_ids", band_ids),
                    ("r0", r0), ("n", n)):
        if tuple(v.shape) != (b,) or v.dtype.is_floating_point:
            raise ValueError(f"{name} must be an int vector [{b}]")
    if not 0 <= stage < s_:
        raise ValueError(f"stage {stage} out of range for {s_} stages")
    slab8 = slab8.to(pool.dtype)
    if pool.device.type == "cpu":
        return paged_rows_write_plain(pool, slab8, page_ids, band_ids,
                                      r0, n, stage)
    if pool.device.type != "cuda":
        raise ValueError(f"no kernel for device {pool.device}")
    _cuda_operands(pool, slab8, page_ids, band_ids, r0, n)
    slab8 = slab8.contiguous()
    idx = [v.to(torch.int32).contiguous()
           for v in (page_ids, band_ids, r0, n)]
    row_bytes = dh * pool.element_size()
    vec = _vec_bytes(row_bytes, pool, slab8)
    with torch.cuda.device(pool.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().tp_paged_rows_write(
            pool.data_ptr(), slab8.data_ptr(),
            *(t.data_ptr() for t in idx), b, stage, p_, h, plen,
            row_bytes, vec, stream)
    _check_launch(err, "paged_rows_write")
    launches["paged_rows_write"] += 1
    return pool


# -------------------------------------------------------- dense row write


def cache_row_write_plain(cache, slab, pos: int, stage: int):
    """Plain version of the dense write: one indexed slice copy."""
    cache[stage, :, :, pos, :] = slab[:, :, 0, :]
    return cache


def cache_row_write(cache, slab, pos: int, stage: int):
    """In-place write of ``slab [B, H, 1, Dh]`` at time ``pos`` of
    ``cache [stages, B, H, T, Dh]``'s ``stage``.

    Replaces ``tpu_p2p/ops/kvcache.py::_cache_row_kernel`` (:25).
    """
    if cache.dim() != 5 or slab.dim() != 4:
        raise ValueError(
            f"cache must be [S, B, H, T, Dh] and slab [B, H, 1, Dh]; got "
            f"{tuple(cache.shape)} and {tuple(slab.shape)}")
    s_, b, h, t, dh = cache.shape
    if tuple(slab.shape) != (b, h, 1, dh):
        raise ValueError(
            f"slab {tuple(slab.shape)} does not match the cache's "
            f"({b}, {h}, 1, {dh})")
    pos, stage = int(pos), int(stage)
    if not 0 <= pos < t:
        raise ValueError(f"pos {pos} outside the {t}-row cache")
    if not 0 <= stage < s_:
        raise ValueError(f"stage {stage} out of range for {s_} stages")
    slab = slab.to(cache.dtype)
    if cache.device.type == "cpu":
        return cache_row_write_plain(cache, slab, pos, stage)
    if cache.device.type != "cuda":
        raise ValueError(f"no kernel for device {cache.device}")
    _cuda_operands(cache, slab)
    slab = slab.contiguous()
    row_bytes = dh * cache.element_size()
    vec = _vec_bytes(row_bytes, cache, slab)
    with torch.cuda.device(cache.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().tp_cache_row_write(
            cache.data_ptr(), slab.data_ptr(), stage, b, h, t, pos,
            row_bytes, vec, stream)
    _check_launch(err, "cache_row_write")
    launches["cache_row_write"] += 1
    return cache
