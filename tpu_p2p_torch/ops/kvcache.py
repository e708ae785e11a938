"""KV-cache row writes — the kernel of the serving path.

Port of ``tpu_p2p/ops/kvcache.py``. One hand-written CUDA kernel
(``tpu_p2p_torch/csrc/kvcache.cu::kv_rows_kernel``, built by
:mod:`tpu_p2p_torch.utils.cuda_build`) stands behind four wrappers:

- :func:`paged_kv_write` and :func:`cache_kv_write`, what the serving
  and decode steps call: one launch writes a layer's K and V rows
  straight from the projections ``[B, H_kv, C, Dh]`` (any batch, head
  and row strides, unit stride on ``Dh``) into the page pool or the
  dense cache;
- :func:`paged_rows_write` and :func:`cache_row_write`, the reference's
  single-destination API (a ``[B, H, 8, Dh]`` band image, a ``[B, H, 1,
  Dh]`` slab), each one launch of the same kernel.

Each has its **plain version** (``*_plain``) beside it, indexed copies
in PyTorch, used for CPU tensors and as the kernel's yardstick on the
card. A wrapper picks the form by its destination's device: the plain
version for a CPU tensor, the kernel for a CUDA tensor (no fallback — a
CUDA tensor the kernel cannot take raises). Rows are cast to the
destination's dtype, as the reference does, only where the dtypes
differ.

All write in place and return the updated tensor(s): the reference
donates the buffer (``input_output_aliases``), the port mutates it.

What bounds them and what the design does about it: pure data movement,
each live row read once and written once, so bytes on paper; in
practice the launch floor. The TPU kernels move a whole 8-row band (TPU
blocks are 8 rows deep) from a band image the caller built first; the
Hopper kernel reads the projections as they are, moves exactly the live
rows, and writes K and V in one launch.
"""

from __future__ import annotations

import ctypes
import threading

import torch

# Kernel launches per wrapper since the last reset — a plain count, so
# a run can show that its main path went through the kernel. Only a
# launch counts: the plain version (CPU) adds nothing.
launches = {"paged_kv_write": 0, "cache_kv_write": 0,
            "paged_rows_write": 0, "cache_row_write": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


_LIB = None
_raw_stream = None
# Ranks of an in-process mesh launch from threads of their own: the
# library loads once and each launch counts once.
_LOCK = threading.Lock()


def _lib():
    """The built kernel library with its C signatures declared, and the
    current-stream getter; both resolved once."""
    if _LIB is None:
        with _LOCK:
            _load_lib()
    return _LIB


def _load_lib() -> None:
    global _LIB, _raw_stream
    if _LIB is None:
        from tpu_p2p_torch.utils.cuda_build import load

        lib = load("kvcache")
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.tp_kv_rows_paged.argtypes = [p, p, q, q, q, p, p, q, q, q,
                                         p, p, p, p, *[i] * 11, p]
        lib.tp_kv_rows_dense.argtypes = [p, p, q, q, p, p, q, q,
                                         *[i] * 9, p]
        lib.tp_kv_empty.argtypes = [i, i, i, i, p]
        for fn in (lib.tp_kv_rows_paged, lib.tp_kv_rows_dense,
                   lib.tp_kv_empty):
            fn.restype = i
        # The raw pointer of the current stream without building a
        # Stream object (the private getter where this build has it).
        _raw_stream = getattr(
            torch._C, "_cuda_getCurrentRawStream",
            lambda idx: torch.cuda.current_stream(idx).cuda_stream)
        _LIB = lib


def _launch(fn, dev: torch.device, *args) -> int:
    """``fn(*args, stream)`` on ``dev``'s current stream, switching the
    current device only where it is another card."""
    if dev.index == torch.cuda.current_device():
        return fn(*args, _raw_stream(dev.index))
    with torch.cuda.device(dev):
        return fn(*args, _raw_stream(dev.index))


def _vec_bytes(row_bytes: int, *tensors: torch.Tensor,
               contiguous=()) -> int:
    """Widest vector (16/8/4/2 bytes) that divides the row size, every
    base pointer and every byte stride the kernel steps by (outer dims
    longer than 1), so each access is aligned: the lowest set bit of
    them all, capped at 16. Only the base pointer counts for a tensor
    in ``contiguous`` (its strides are multiples of the row)."""
    acc = row_bytes | 16
    for t in contiguous:
        acc |= t.data_ptr()
    for t in tensors:
        acc |= t.data_ptr()
        es = t.element_size()
        for s, n in zip(t.stride()[:-1], t.shape[:-1]):
            if n > 1:
                acc |= s * es
    vec = acc & -acc
    if vec < 2:
        raise ValueError(f"row of {row_bytes} bytes is not 2-byte aligned")
    return vec


def _threads(rows: int, row_bytes: int, vec: int) -> int:
    """One vector a thread for a CTA's rows, in whole warps (32..256)."""
    return min(256, max(32, -(-(rows * row_bytes // vec) // 32) * 32))


def _check_launch(err: int, what: str) -> None:
    if err:
        raise RuntimeError(
            f"{what} kernel launch failed: CUDA error {err} "
            f"({torch.cuda.get_device_name()})"
        )


def _int32(v: torch.Tensor) -> torch.Tensor:
    if v.dtype == torch.int32 and v.is_contiguous():
        return v
    return v.to(torch.int32).contiguous()


def _check_dsts(what: str, dsts, rows) -> tuple:
    """Shape, dtype and device checks shared by every wrapper (no
    device sync); → the destination shape ``(S, P, H, L, Dh)``."""
    d0 = dsts[0]
    if d0.dim() != 5:
        raise ValueError(f"{what}: the cache/pool must be 5-D "
                         f"[S, P, H, L, Dh], got {tuple(d0.shape)}")
    for d in dsts[1:]:
        if d.shape != d0.shape or d.dtype != d0.dtype \
                or d.get_device() != d0.get_device():
            raise ValueError(
                f"{what}: K and V pools differ: {tuple(d0.shape)} "
                f"{d0.dtype} {d0.device} vs {tuple(d.shape)} {d.dtype} "
                f"{d.device}")
    for r in rows:
        if r.dim() != 4:
            raise ValueError(f"{what}: rows must be [B, H, C, Dh], got "
                             f"{tuple(r.shape)}")
        if r.stride(-1) != 1:
            raise ValueError(
                f"{what}: rows need a unit stride on Dh, got strides "
                f"{r.stride()}")
    return tuple(d0.shape)


def _on_card(t: torch.Tensor) -> bool:
    """Whether a write into ``t`` takes the kernel path: a CUDA tensor.
    A CPU tensor takes the plain version; any other device raises."""
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"no kernel for device {t.device}")
    return False


def _cuda_operands(what: str, dsts, others) -> None:
    dev = dsts[0].device
    for d in dsts:
        if not d.is_contiguous():
            raise ValueError(f"{what}: the cache/pool must be contiguous "
                             "to be written in place by the kernel")
    card = dsts[0].get_device()
    for t in others:
        if t.get_device() != card:
            raise ValueError(
                f"{what}: operand on {t.device}, cache/pool on {dev}")


def _as_dtype(rows, dtype):
    return [r if r.dtype == dtype else r.to(dtype) for r in rows]


def _launch_rows(what, entry, dsts, rows, idx, nstrides, ints, c):
    """The kernel's path once the shapes are checked: card, contiguity
    and alignment checks, then one launch of the library's ``entry``
    with K from ``dsts[0]``/``rows[0]`` and V from ``dsts[-1]``/
    ``rows[-1]`` (the same pair where there is one destination), the
    source's first ``nstrides`` byte strides, the index pointers,
    ``ints``, the row size, the vector width and the block for ``c``
    rows a CTA."""
    _cuda_operands(what, dsts, (*rows, *idx))
    kd, vd, k, v = dsts[0], dsts[-1], rows[0], rows[-1]
    es = kd.element_size()
    row_bytes = kd.shape[-1] * es
    vec = _vec_bytes(row_bytes, *rows, contiguous=dsts)
    ks, vs = k.stride(), v.stride()
    err = _launch(
        getattr(_lib(), entry), kd.device,
        kd.data_ptr(), k.data_ptr(), *[x * es for x in ks[:nstrides]],
        vd.data_ptr(), v.data_ptr(), *[x * es for x in vs[:nstrides]],
        *[t.data_ptr() for t in idx], *ints, row_bytes, vec,
        _threads(c, row_bytes, vec))
    _check_launch(err, what)
    with _LOCK:
        launches[what] += 1


# ------------------------------------------------------------ paged pool


def _paged(what, dsts, rows, page, band, r0, n, stage, band_image):
    """Validate, then launch once for CUDA destinations (→ None), or
    hand back the rows, cast, for the plain version (CPU)."""
    s_, p_, h, plen, dh = _check_dsts(what, dsts, rows)
    b, c = rows[0].shape[0], rows[0].shape[2]
    if plen % 8:
        raise ValueError(
            f"{what}: page_len ({plen}) must be a multiple of the 8-row "
            "band granularity")
    want = (b, h, 8, dh) if band_image else (b, h, c, dh)
    for r in rows:
        if tuple(r.shape) != want or c > 8:
            raise ValueError(
                f"{what}: {'slab8' if band_image else 'rows'} "
                f"{tuple(r.shape)} does not match the pool's (B, {h}, "
                f"{'8' if band_image else 'C <= 8'}, {dh})")
    for name, v in (("page_ids", page), ("band_ids", band), ("r0", r0),
                    ("n", n)):
        if v.shape != (b,) or v.dtype.is_floating_point:
            raise ValueError(f"{what}: {name} must be an int vector [{b}]")
    if not 0 <= stage < s_:
        raise ValueError(f"{what}: stage {stage} out of range for {s_} "
                         "stages")
    rows = _as_dtype(rows, dsts[0].dtype)
    if not _on_card(dsts[0]):
        return rows
    _launch_rows(what, "tp_kv_rows_paged", dsts, rows,
                 [_int32(v) for v in (page, band, r0, n)], 3,
                 (len(rows), int(band_image), c, b, stage, p_, h, plen), c)
    return None


def paged_kv_write_plain(k_pool, v_pool, k_rows, v_rows, page, band, r0,
                         n, stage: int):
    """Plain version of :func:`paged_kv_write`: one indexed slice copy
    per live slot and projection."""
    for b, (pg, bd, r, k) in enumerate(zip(page.tolist(), band.tolist(),
                                           r0.tolist(), n.tolist())):
        if k > 0:
            row = bd * 8 + r
            k_pool[stage, pg, :, row:row + k, :] = k_rows[b, :, :k, :]
            v_pool[stage, pg, :, row:row + k, :] = v_rows[b, :, :k, :]
    return k_pool, v_pool


def paged_kv_write(k_pool, v_pool, k_rows, v_rows, page, band, r0, n,
                   stage: int):
    """In-place write of a layer's K and V token rows into the slots'
    pages of ``k_pool``/``v_pool [stages, num_pages, H, page_len, Dh]``,
    one launch for both.

    ``k_rows``/``v_rows [B, H, C, Dh]`` (C ≤ 8, the projections as they
    come: any batch, head and row strides, unit stride on ``Dh``): slot
    ``b``'s rows ``i < n[b]`` land at ``pool[stage, page[b], :, band[b]*8
    + r0[b] + i, :]``. ``page``/``band``/``r0``/``n``: int vectors
    ``[B]`` on the pools' device (int32 is passed as it is). ``n == 0``
    writes nothing (idle slots park on the trash page). The caller keeps
    each slot's rows inside one 8-row band and never gives two live
    slots the same page. → ``(k_pool, v_pool)``.

    Replaces ``tpu_p2p/ops/kvcache.py::_paged_band_kernel`` (:89) twice
    and the band images the reference builds for it.
    """
    rows = _paged("paged_kv_write", (k_pool, v_pool), (k_rows, v_rows),
                  page, band, r0, n, int(stage), band_image=False)
    if rows is not None:
        paged_kv_write_plain(k_pool, v_pool, *rows, page, band, r0, n,
                             int(stage))
    return k_pool, v_pool


def paged_rows_write_plain(pool, slab8, page_ids, band_ids, r0, n,
                           stage: int):
    """Plain version of the single-destination paged write: one indexed
    slice copy per live slot. Same arguments and result as
    :func:`paged_rows_write`."""
    for b, (pg, bd, r, k) in enumerate(zip(page_ids.tolist(),
                                           band_ids.tolist(), r0.tolist(),
                                           n.tolist())):
        if k > 0:
            row = bd * 8 + r
            pool[stage, pg, :, row:row + k, :] = slab8[b, :, r:r + k, :]
    return pool


def paged_rows_write(pool, slab8, page_ids, band_ids, r0, n, stage: int):
    """In-place write of each slot's token rows into its page of
    ``pool [stages, num_pages, H, page_len, Dh]`` — the reference's API,
    one launch of the same kernel.

    ``slab8 [B, H, 8, Dh]``: per-slot band image with the slot's
    ``n[b]`` live rows at rows ``r0[b] .. r0[b]+n[b]-1``; those rows land
    at ``pool[stage, page_ids[b], :, band_ids[b]*8 + r0[b] + i, :]``.
    Otherwise as :func:`paged_kv_write`.

    Replaces ``tpu_p2p/ops/kvcache.py::_paged_band_kernel`` (:89).
    """
    rows = _paged("paged_rows_write", (pool,), (slab8,), page_ids,
                  band_ids, r0, n, int(stage), band_image=True)
    if rows is not None:
        paged_rows_write_plain(pool, rows[0], page_ids, band_ids, r0, n,
                               int(stage))
    return pool


# ----------------------------------------------------------- dense cache


def _dense(what, dsts, rows, pos, stage):
    """:func:`_paged`'s twin for the dense cache: ``[B, H, 1, Dh]`` of
    each projection at time ``pos``."""
    s_, b, h, t, dh = _check_dsts(what, dsts, rows)
    for r in rows:
        if tuple(r.shape) != (b, h, 1, dh):
            raise ValueError(
                f"{what}: slab {tuple(r.shape)} does not match the "
                f"cache's ({b}, {h}, 1, {dh})")
    if not 0 <= pos < t:
        raise ValueError(f"{what}: pos {pos} outside the {t}-row cache")
    if not 0 <= stage < s_:
        raise ValueError(f"{what}: stage {stage} out of range for {s_} "
                         "stages")
    rows = _as_dtype(rows, dsts[0].dtype)
    if not _on_card(dsts[0]):
        return rows
    _launch_rows(what, "tp_kv_rows_dense", dsts, rows, (), 2,
                 (len(rows), pos, b, stage, h, t), 1)
    return None


def cache_kv_write_plain(k_cache, v_cache, k_rows, v_rows, pos: int,
                         stage: int):
    """Plain version of :func:`cache_kv_write`: two indexed slice
    copies."""
    k_cache[stage, :, :, pos, :] = k_rows[:, :, 0, :]
    v_cache[stage, :, :, pos, :] = v_rows[:, :, 0, :]
    return k_cache, v_cache


def cache_kv_write(k_cache, v_cache, k_rows, v_rows, pos: int, stage: int):
    """In-place write of a layer's K and V rows ``[B, H, 1, Dh]`` (any
    batch and head strides, unit stride on ``Dh``) at time ``pos`` of
    ``k_cache``/``v_cache [stages, B, H, T, Dh]``'s ``stage``, one launch
    for both. → ``(k_cache, v_cache)``.

    Replaces ``tpu_p2p/ops/kvcache.py::_cache_row_kernel`` (:25) twice.
    """
    pos, stage = int(pos), int(stage)
    rows = _dense("cache_kv_write", (k_cache, v_cache), (k_rows, v_rows),
                  pos, stage)
    if rows is not None:
        cache_kv_write_plain(k_cache, v_cache, *rows, pos, stage)
    return k_cache, v_cache


def cache_row_write_plain(cache, slab, pos: int, stage: int):
    """Plain version of the single-destination dense write: one indexed
    slice copy."""
    cache[stage, :, :, pos, :] = slab[:, :, 0, :]
    return cache


def cache_row_write(cache, slab, pos: int, stage: int):
    """In-place write of ``slab [B, H, 1, Dh]`` at time ``pos`` of
    ``cache [stages, B, H, T, Dh]``'s ``stage`` — the reference's API,
    one launch of the same kernel.

    Replaces ``tpu_p2p/ops/kvcache.py::_cache_row_kernel`` (:25).
    """
    pos, stage = int(pos), int(stage)
    rows = _dense("cache_row_write", (cache,), (slab,), pos, stage)
    if rows is not None:
        cache_row_write_plain(cache, rows[0], pos, stage)
    return cache


def launch_empty(like: torch.Tensor, batch: int, heads: int, nproj: int,
                 threads: int) -> None:
    """One launch of an empty kernel over a write's grid ``(batch,
    heads, nproj)`` and block on ``like``'s card: the launch floor that
    ``chip_smoke.py`` times beside the writes. Counts no launch."""
    _check_launch(_launch(_lib().tp_kv_empty, like.device, batch, heads,
                          nproj, threads), "kv_empty")
