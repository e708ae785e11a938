"""Flash attention — the three kernels of the training path.

Port of ``tpu_p2p/ops/flash_attention.py``. Three functions keep the
reference's contracts, and each has three forms side by side:

- the **kernel**, hand-written CUDA C++ for Hopper
  (``tpu_p2p_torch/csrc/flash_attention.cu``, built by
  :mod:`tpu_p2p_torch.utils.cuda_build`), launched for CUDA tensors:
  bfloat16 on the tensor cores (``wgmma``, entry points
  ``tp_flash_fwd_wgmma``, ``tp_flash_bwd_dkdv_wgmma`` and
  ``tp_flash_bwd_dq_wgmma``), float32 on the SIMT kernels
  (``tp_flash_fwd``, ``tp_flash_bwd_dkdv``, ``tp_flash_bwd_dq``);
- the **plain version** (``*_plain``), whole-row PyTorch with the
  kernel's own math, used for CPU tensors and as the kernel's
  yardstick on the card;
- the **wrapper**, which validates and picks the form by the tensors'
  device: the plain version for CPU tensors, the kernel for CUDA
  tensors (no fallback — a CUDA tensor the kernel cannot take raises).

The functions:

- :func:`_flash_call` — one accumulate pass of ``q3 [B·Hq, Tq, D]``
  against ``k3/v3 [B·Hkv, Tk, D]`` on an ``(o, m, l)`` carry, with
  global offsets ``q_off/k_off``, ``causal`` and ``window`` (kernel
  ``flash_fwd``; replaces ``_kernel`` and ``_kernel_flat``);
- :func:`_flash_bwd_call` — FlashAttention-2 gradients from the saved
  logsumexp ``L`` and ``delta = rowsum(dO·O)``: dq from kernel
  ``flash_bwd_dq`` (replaces ``_bwd_dq_kernel`` and the fused path's
  ``_dq_reduce_kernel``), dk/dv from kernel ``flash_bwd_dkdv`` (replaces
  ``_bwd_dkdv_kernel``), already folded to the narrow ``B·Hkv`` rows;
- :func:`flash_attention` — the trainable ``[B, H, T, D]`` op, a
  ``torch.autograd.Function`` saving ``(q, k, v, out, L)`` and never P;
- :func:`flash_carry_block` and :func:`flash_bwd_block` — the ring
  hop's steps on ``[B, H, T, D]`` blocks at global offsets (reference
  :569 and :606), over :func:`_flash_call` and :func:`_flash_bwd_call`;
  their ``*_plain`` twins run the plain versions on any device (what
  the kernels are held against on the card).

The math both forms share with the reference: the softmax scale and
``log2 e`` are folded into q with one rounding back to q's dtype (the
forward and both backward recomputes alike), every exponential is an
``exp2``, ``m`` crosses the call boundary in natural log, ``p`` is cast
to v's dtype before the PV / dV products and ``ds`` to q's (k's) before
the dK (dq) product, all products accumulate in float32. Masked scores
leave the running max alone in the forward (a fully-masked row keeps
its carry: ``l`` stays 0, which :func:`finalize` and ``L = +1e30`` turn
into zero output and an all-zero P row) and are ``NEG_INF`` in the
backward recompute, whose ``exp2`` underflows to exactly 0.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Optional, Tuple

import torch

from tpu_p2p_torch.ops.attention import (
    NEG_INF,
    _check_window,
    finalize,
    repeat_kv,
)

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453

# Kernel launches per kernel since the last reset — a plain count, so a
# run can show that its main path went through the kernels. Only a
# launch counts: the plain versions add nothing.
launches = {"flash_fwd": 0, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


KERNEL_HEAD_DIMS = (32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_LIB = None  # the bound library, once built


def declare(lib):
    """Declare the C signatures of a built ``flash_attention`` library
    (the default build's, or one built with other tile macros); →
    ``lib``."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ints = [i] * 11  # rows tq tk d q_heads group q_off k_off causal
    # window dtype
    for name, sig in (("tp_flash_fwd", [p] * 9 + ints + [f, p]),
                      ("tp_flash_fwd_wgmma", [p] * 9 + ints + [f, p]),
                      ("tp_flash_bwd_dkdv", [p] * 8 + ints + [f, f, p]),
                      ("tp_flash_bwd_dkdv_wgmma", [p] * 8 + ints + [f, f, p]),
                      ("tp_flash_bwd_dq", [p] * 7 + ints + [f, f, p]),
                      ("tp_flash_bwd_dq_wgmma", [p] * 7 + ints + [f, f, p]),
                      ("tp_flash_config", [i, i, i, p])):
        getattr(lib, name).argtypes = sig
        getattr(lib, name).restype = i
    return lib


def _lib():
    """The built kernel library, with its C signatures declared."""
    global _LIB
    if _LIB is None:
        from tpu_p2p_torch.utils.cuda_build import load

        _LIB = declare(load("flash_attention"))
    return _LIB


# The C entry point of each kernel by dtype: bfloat16 runs on the tensor
# cores, float32 on the SIMT kernels.
ENTRY = {
    ("flash_fwd", torch.float32): "tp_flash_fwd",
    ("flash_fwd", torch.bfloat16): "tp_flash_fwd_wgmma",
    ("flash_bwd_dkdv", torch.float32): "tp_flash_bwd_dkdv",
    ("flash_bwd_dkdv", torch.bfloat16): "tp_flash_bwd_dkdv_wgmma",
    ("flash_bwd_dq", torch.float32): "tp_flash_bwd_dq",
    ("flash_bwd_dq", torch.bfloat16): "tp_flash_bwd_dq_wgmma",
}
_KERNEL_CODE = {"flash_fwd": 0, "flash_bwd_dkdv": 1, "flash_bwd_dq": 2}


def kernel_config(kernel: str, dtype: torch.dtype, d: int) -> dict:
    """How the built library launches ``kernel`` for ``dtype`` and head
    dim ``d`` (``tp_flash_config``, on the current card): its entry
    point, q and k tile rows, threads and dynamic shared bytes a CTA,
    CTAs resident on an SM."""
    out = (ctypes.c_int * 5)()
    err = _lib().tp_flash_config(_KERNEL_CODE[kernel], _DTYPE_CODE[dtype],
                                 d, ctypes.addressof(out))
    if err:
        raise ValueError(f"no {kernel} kernel for {dtype}, head dim {d}")
    return {"entry": ENTRY[(kernel, dtype)], "bq": out[0], "bk": out[1],
            "threads": out[2], "smem": out[3], "ctas_per_sm": out[4]}


def _fold(d: int) -> float:
    """The q fold: softmax scale times ``log2 e`` (one multiply, one
    rounding of q)."""
    return (1.0 / (d ** 0.5)) * LOG2E


def _gqa_group(bh_q: int, bh_kv: int, q_heads: int) -> int:
    """The GQA group size from the flattened row counts ``B·Hq`` and
    ``B·Hkv`` and the per-batch query head count; raises on counts that
    do not divide."""
    b = bh_q // q_heads if q_heads > 0 else 0
    if b < 1 or b * q_heads != bh_q or bh_kv % b:
        raise ValueError(f"inconsistent shapes: {bh_q=}, {bh_kv=}, {q_heads=}")
    h_kv = bh_kv // b
    if q_heads % h_kv:
        raise ValueError(
            f"query heads ({q_heads}) must be a multiple of KV heads ({h_kv})"
        )
    return q_heads // h_kv


def _expand_kv_rows(k3: torch.Tensor, bh: int, q_heads: int) -> torch.Tensor:
    """GQA: widen ``[B·Hkv, T, D]`` to ``[B·Hq, T, D]`` (the plain
    versions' stand-in for the kernels' narrow-row read)."""
    b = bh // q_heads
    tk, d = k3.shape[1], k3.shape[2]
    return repeat_kv(k3.reshape(b, -1, tk, d), q_heads).reshape(bh, tk, d)


def _fold_groups(x: torch.Tensor, bh_kv: int, q_heads: int) -> torch.Tensor:
    """Sum per-query-head rows ``[B·Hq, T, D]`` over each GQA group →
    ``[B·Hkv, T, D]``."""
    bh, t, d = x.shape
    b = bh // q_heads
    return x.reshape(b, bh_kv // b, -1, t, d).sum(2).reshape(bh_kv, t, d)


def _causal_mask(tq: int, tk: int, q_off: int, k_off: int, window,
                 device) -> torch.Tensor:
    """``[tq, tk]`` bool: key visible from query at global positions
    ``q_off + i`` and ``k_off + j``."""
    q_pos = q_off + torch.arange(tq, device=device)[:, None]
    k_pos = k_off + torch.arange(tk, device=device)[None, :]
    vis = q_pos >= k_pos
    if window is not None:
        vis &= q_pos - k_pos < window
    return vis


def zero_carry(bh: int, t: int, d: int, device
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fresh ``(o, m, l)`` streaming-softmax accumulators."""
    return (torch.zeros((bh, t, d), dtype=torch.float32, device=device),
            torch.full((bh, t), NEG_INF, dtype=torch.float32, device=device),
            torch.zeros((bh, t), dtype=torch.float32, device=device))


# ------------------------------------------------------------- checks


def _check_qkv(q3, k3, v3, q_heads: int) -> int:
    if q3.dim() != 3 or k3.dim() != 3 or tuple(k3.shape) != tuple(v3.shape):
        raise ValueError(
            f"need q3 [B·Hq, Tq, D] and k3 = v3 [B·Hkv, Tk, D]; got "
            f"{tuple(q3.shape)}, {tuple(k3.shape)}, {tuple(v3.shape)}")
    if q3.shape[2] != k3.shape[2]:
        raise ValueError(f"head dims differ: {q3.shape[2]} vs {k3.shape[2]}")
    if not (q3.dtype == k3.dtype == v3.dtype):
        raise ValueError(f"q/k/v dtypes differ: {q3.dtype}, {k3.dtype}, "
                         f"{v3.dtype}")
    return _gqa_group(q3.shape[0], k3.shape[0], q_heads)


def _check_rows(name: str, t: torch.Tensor, shape) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32 {tuple(shape)}; got "
                         f"{t.dtype} {tuple(t.shape)}")


def _on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises for any other
    device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return True


def _route(q3: torch.Tensor, *others: torch.Tensor) -> bool:
    """True: launch the kernel (every operand on one CUDA device, a
    dtype and head dim the kernel takes). False: CPU tensors, the plain
    version. Anything else raises — no fallback."""
    for t in others:
        if t.device != q3.device:
            raise ValueError(f"operand on {t.device}, q on {q3.device}")
    if not _on_card(q3):
        return False
    if q3.dtype not in _DTYPE_CODE:
        raise ValueError(f"the flash kernels take float32 or bfloat16, "
                         f"got {q3.dtype}")
    if q3.shape[2] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the flash kernels take head dims "
                         f"{KERNEL_HEAD_DIMS}, got {q3.shape[2]}")
    if min(q3.shape[1], others[0].shape[1]) < 1:
        raise ValueError("empty sequence")
    return True


def _check_launch(err: int, what: str) -> None:
    if err:
        raise RuntimeError(
            f"{what} kernel launch failed: CUDA error {err} "
            f"({torch.cuda.get_device_name()})"
        )


def _ptrs(*tensors: torch.Tensor):
    return [t.data_ptr() for t in tensors]


def _operands(*tensors: torch.Tensor):
    """Contiguous, each on a 16-byte boundary (the tensor-core kernels
    copy tiles 16 bytes at a time): a tensor that starts elsewhere, a
    view at an odd offset, is copied."""
    out = []
    for t in tensors:
        t = t.contiguous()
        out.append(t if t.data_ptr() % 16 == 0 else t.clone())
    return out


@contextlib.contextmanager
def _card_stream(device: torch.device):
    """``device`` made the current card for a launch; yields the handle
    of its current stream."""
    with torch.cuda.device(device):
        yield torch.cuda.current_stream().cuda_stream


# ------------------------------------------------------------ forward


def _flash_call_plain(q3, k3, v3, o0, m0, l0, q_off: int = 0,
                      k_off: int = 0, *, causal: bool, q_heads: int,
                      window: Optional[int] = None):
    """Plain version of :func:`_flash_call`: the same accumulate over
    whole rows."""
    bh, tq, d = q3.shape
    tk = k3.shape[1]
    qf = (q3 * _fold(d)).to(q3.dtype)
    ke = _expand_kv_rows(k3, bh, q_heads)
    ve = _expand_kv_rows(v3, bh, q_heads)
    s = torch.matmul(qf.float(), ke.float().transpose(1, 2))  # log2 units
    if causal:
        vis = _causal_mask(tq, tk, q_off, k_off, window, q3.device)
        s = s.masked_fill(~vis, float("-inf"))
    m0l = m0 * LOG2E
    m_new = torch.maximum(m0l, s.amax(dim=-1))
    alpha = torch.exp2(m0l - m_new)
    p = torch.exp2(s - m_new[..., None])
    pv = torch.matmul(p.to(v3.dtype).float(), ve.float())
    return (o0 * alpha[..., None] + pv, m_new * LN2,
            l0 * alpha + p.sum(dim=-1))


def _flash_call(q3, k3, v3, o0, m0, l0, q_off: int = 0, k_off: int = 0, *,
                causal: bool, q_heads: int, window: Optional[int] = None):
    """One accumulate pass of ``q3`` against the whole of ``k3/v3``.

    Shapes: ``q3 [B·Hq, Tq, D]``, ``k3/v3 [B·Hkv, Tk, D]`` (bf16 or
    f32), carry ``o0 [B·Hq, Tq, D]`` and ``m0/l0 [B·Hq, Tq]`` float32,
    ``m`` in natural log. ``q_off/k_off``: global positions of row 0 of
    q and k, which place the causal/window mask. Returns the updated
    un-normalized ``(o, m, l)``; :func:`finalize` divides by ``l``.
    ``q_heads``: query heads per batch, from which the GQA group is
    derived.

    Replaces ``tpu_p2p/ops/flash_attention.py::_kernel`` (:101) and
    ``_kernel_flat`` (:208), via ``_flash_call`` (:414).
    """
    _check_window(window, causal)
    _check_qkv(q3, k3, v3, q_heads)
    bh, tq, d = q3.shape
    _check_rows("o0", o0, (bh, tq, d))
    _check_rows("m0", m0, (bh, tq))
    _check_rows("l0", l0, (bh, tq))
    q_off, k_off = int(q_off), int(k_off)
    if not _route(q3, k3, v3, o0, m0, l0):
        return _flash_call_plain(q3, k3, v3, o0, m0, l0, q_off, k_off,
                                 causal=causal, q_heads=q_heads,
                                 window=window)
    group = _gqa_group(bh, k3.shape[0], q_heads)
    q3, k3, v3, o0, m0, l0 = _operands(q3, k3, v3, o0, m0, l0)
    o, m, l = torch.empty_like(o0), torch.empty_like(m0), torch.empty_like(l0)
    with _card_stream(q3.device) as stream:
        err = getattr(_lib(), ENTRY[("flash_fwd", q3.dtype)])(
            *_ptrs(q3, k3, v3, o0, m0, l0, o, m, l),
            bh, tq, k3.shape[1], d, q_heads, group, q_off, k_off,
            int(causal), window or 0, _DTYPE_CODE[q3.dtype], _fold(d),
            stream)
    _check_launch(err, "flash_fwd")
    launches["flash_fwd"] += 1
    return o, m, l


# ----------------------------------------------------------- backward


def _bwd_plain_parts(q3, k3, v3, do3, L, delta, q_off, k_off, causal,
                     q_heads, window):
    """``(p, ds, ke)`` of the FlashAttention-2 backward over whole
    rows: P rebuilt from L with the forward's q rounding, and
    ``ds = P∘(dP − delta)·scale``."""
    bh, tq, d = q3.shape
    tk = k3.shape[1]
    qf = (q3 * _fold(d)).to(q3.dtype)
    ke = _expand_kv_rows(k3, bh, q_heads)
    ve = _expand_kv_rows(v3, bh, q_heads)
    s = torch.matmul(qf.float(), ke.float().transpose(1, 2))
    if causal:
        vis = _causal_mask(tq, tk, q_off, k_off, window, q3.device)
        s = torch.where(vis, s, NEG_INF)
    p = torch.exp2(s - (L * LOG2E)[..., None])
    dp = torch.matmul(do3.float(), ve.float().transpose(1, 2))
    ds = p * (dp - delta[..., None]) * (1.0 / (d ** 0.5))
    return p, ds, ke


def _flash_bwd_dkdv_plain(q3, k3, v3, do3, L, delta, q_off: int = 0,
                          k_off: int = 0, *, causal: bool, q_heads: int,
                          window: Optional[int] = None):
    """Plain version of :func:`_flash_bwd_dkdv`."""
    p, ds, _ = _bwd_plain_parts(q3, k3, v3, do3, L, delta, q_off, k_off,
                                causal, q_heads, window)
    dv = torch.matmul(p.to(v3.dtype).float().transpose(1, 2), do3.float())
    dk = torch.matmul(ds.to(q3.dtype).float().transpose(1, 2), q3.float())
    return (_fold_groups(dk, k3.shape[0], q_heads),
            _fold_groups(dv, k3.shape[0], q_heads))


def _flash_bwd_dq_plain(q3, k3, v3, do3, L, delta, q_off: int = 0,
                        k_off: int = 0, *, causal: bool, q_heads: int,
                        window: Optional[int] = None):
    """Plain version of :func:`_flash_bwd_dq`."""
    _, ds, ke = _bwd_plain_parts(q3, k3, v3, do3, L, delta, q_off, k_off,
                                 causal, q_heads, window)
    return torch.matmul(ds.to(k3.dtype).float(), ke.float())


def _check_bwd(q3, k3, v3, do3, L, delta, causal, q_heads, window):
    _check_window(window, causal)
    _check_qkv(q3, k3, v3, q_heads)
    if tuple(do3.shape) != tuple(q3.shape) or do3.dtype != q3.dtype:
        raise ValueError(f"do3 must match q3 {q3.dtype} "
                         f"{tuple(q3.shape)}; got {do3.dtype} "
                         f"{tuple(do3.shape)}")
    _check_rows("L", L, q3.shape[:2])
    _check_rows("delta", delta, q3.shape[:2])
    return _route(q3, k3, v3, do3, L, delta)


def _bwd_launch(kernel: str, q3, k3, v3, do3, L, delta, outs, rows, q_off,
                k_off, causal, q_heads, window):
    bh, tq, d = q3.shape
    group = _gqa_group(bh, k3.shape[0], q_heads)
    q3, k3, v3, do3, L, delta = _operands(q3, k3, v3, do3, L, delta)
    with _card_stream(q3.device) as stream:
        return getattr(_lib(), ENTRY[(kernel, q3.dtype)])(
            *_ptrs(q3, k3, v3, do3, L, delta, *outs),
            rows, tq, k3.shape[1], d, q_heads, group, int(q_off),
            int(k_off), int(causal), window or 0, _DTYPE_CODE[q3.dtype],
            _fold(d), 1.0 / (d ** 0.5), stream)


def _flash_bwd_dkdv(q3, k3, v3, do3, L, delta, q_off: int = 0,
                    k_off: int = 0, *, causal: bool, q_heads: int,
                    window: Optional[int] = None):
    """dk, dv (float32, narrow ``[B·Hkv, Tk, D]``) of one attention
    block from the forward's logsumexp ``L [B·Hq, Tq]`` and
    ``delta = rowsum(dO·O) [B·Hq, Tq]``; ``do3`` in q's dtype.

    Replaces ``tpu_p2p/ops/flash_attention.py::_bwd_dkdv_kernel`` (:717)
    and the GQA group sum after it (``_flash_bwd`` :1310-1314).
    """
    if not _check_bwd(q3, k3, v3, do3, L, delta, causal, q_heads, window):
        return _flash_bwd_dkdv_plain(q3, k3, v3, do3, L, delta, q_off,
                                     k_off, causal=causal, q_heads=q_heads,
                                     window=window)
    dk = torch.empty(k3.shape, dtype=torch.float32, device=k3.device)
    dv = torch.empty_like(dk)
    err = _bwd_launch("flash_bwd_dkdv", q3, k3, v3, do3, L, delta,
                      (dk, dv), k3.shape[0], q_off, k_off, causal, q_heads,
                      window)
    _check_launch(err, "flash_bwd_dkdv")
    launches["flash_bwd_dkdv"] += 1
    return dk, dv


def _flash_bwd_dq(q3, k3, v3, do3, L, delta, q_off: int = 0,
                  k_off: int = 0, *, causal: bool, q_heads: int,
                  window: Optional[int] = None):
    """dq (float32 ``[B·Hq, Tq, D]``) of one attention block; arguments
    as :func:`_flash_bwd_dkdv`.

    Replaces ``tpu_p2p/ops/flash_attention.py::_bwd_dq_kernel`` (:826)
    and, in the fused causal form, ``_dq_reduce_kernel`` (:693) with the
    partial-dq slabs it sums.
    """
    if not _check_bwd(q3, k3, v3, do3, L, delta, causal, q_heads, window):
        return _flash_bwd_dq_plain(q3, k3, v3, do3, L, delta, q_off, k_off,
                                   causal=causal, q_heads=q_heads,
                                   window=window)
    dq = torch.empty(q3.shape, dtype=torch.float32, device=q3.device)
    err = _bwd_launch("flash_bwd_dq", q3, k3, v3, do3, L, delta, (dq,),
                      q3.shape[0], q_off, k_off, causal, q_heads, window)
    _check_launch(err, "flash_bwd_dq")
    launches["flash_bwd_dq"] += 1
    return dq


def _flash_bwd_call(q3, k3, v3, do3, L, delta, q_off: int = 0,
                    k_off: int = 0, *, causal: bool, q_heads: int,
                    window: Optional[int] = None):
    """``(dq, dk, dv)`` in float32 for one attention block,
    FlashAttention-2 style; dk/dv narrow ``[B·Hkv, Tk, D]``: the dk/dv
    wrapper, then the dq wrapper (each routes by device)."""
    kw = dict(causal=causal, q_heads=q_heads, window=window)
    dk, dv = _flash_bwd_dkdv(q3, k3, v3, do3, L, delta, q_off, k_off, **kw)
    dq = _flash_bwd_dq(q3, k3, v3, do3, L, delta, q_off, k_off, **kw)
    return dq, dk, dv


def _flash_bwd_call_plain(q3, k3, v3, do3, L, delta, q_off: int = 0,
                          k_off: int = 0, *, causal: bool, q_heads: int,
                          window: Optional[int] = None):
    """Plain version of :func:`_flash_bwd_call`."""
    kw = dict(causal=causal, q_heads=q_heads, window=window)
    dk, dv = _flash_bwd_dkdv_plain(q3, k3, v3, do3, L, delta, q_off, k_off,
                                   **kw)
    dq = _flash_bwd_dq_plain(q3, k3, v3, do3, L, delta, q_off, k_off, **kw)
    return dq, dk, dv


# ------------------------------------------------------ ring blocks


def _carry_block(call, q, k, v, o, m, l, q_off, k_off, causal, window):
    b, h, tq, d = q.shape
    h_kv, tk = k.shape[1], k.shape[2]
    bh = b * h
    o3, m3, l3 = call(q.reshape(bh, tq, d), k.reshape(b * h_kv, tk, d),
                      v.reshape(b * h_kv, tk, d), o.reshape(bh, tq, d),
                      m.reshape(bh, tq), l.reshape(bh, tq), int(q_off),
                      int(k_off), causal=causal, q_heads=h, window=window)
    return (o3.reshape(b, h, tq, d), m3.reshape(b, h, tq),
            l3.reshape(b, h, tq))


def flash_carry_block(q, k, v, o, m, l, q_off: int, k_off: int, *,
                      causal: bool = False, window: Optional[int] = None):
    """Fold one KV block into the carry — the ring hop's forward step
    (reference :569). ``q [B, H, Tq, D]`` against ``k/v [B, H_kv, Tk,
    D]`` (GQA) at global offsets ``q_off``/``k_off`` (host integers);
    carry ``o [B, H, Tq, D]``, ``m/l [B, H, Tq]`` float32, ``m`` in
    natural log. The kernel on card tensors, the plain version on CPU
    tensors (:func:`_flash_call`)."""
    return _carry_block(_flash_call, q, k, v, o, m, l, q_off, k_off,
                        causal, window)


def flash_carry_block_plain(q, k, v, o, m, l, q_off: int, k_off: int, *,
                            causal: bool = False,
                            window: Optional[int] = None):
    """:func:`flash_carry_block` through the plain version on any
    device."""
    return _carry_block(_flash_call_plain, q, k, v, o, m, l, q_off, k_off,
                        causal, window)


def _bwd_block(call, q, k, v, do, L, delta, q_off, k_off, causal, window):
    b, h, tq, d = q.shape
    h_kv, tk = k.shape[1], k.shape[2]
    bh = b * h
    dq, dk, dv = call(q.reshape(bh, tq, d), k.reshape(b * h_kv, tk, d),
                      v.reshape(b * h_kv, tk, d),
                      do.to(q.dtype).reshape(bh, tq, d),
                      L.reshape(bh, tq), delta.reshape(bh, tq), int(q_off),
                      int(k_off), causal=causal, q_heads=h, window=window)
    return (dq.reshape(b, h, tq, d), dk.reshape(b, h_kv, tk, d),
            dv.reshape(b, h_kv, tk, d))


def flash_bwd_block(q, k, v, do, L, delta, q_off: int, k_off: int, *,
                    causal: bool = False, window: Optional[int] = None):
    """FlashAttention-2 gradients of one q block against one KV block
    from the *global* logsumexp ``L`` and ``delta = rowsum(dO·O)``
    (``[B, H, Tq]``) — the ring hop's backward step (reference :606).
    → float32 partial sums ``(dq [B, H, Tq, D], dk [B, H_kv, Tk, D],
    dv)``, GQA groups folded. Routed as :func:`_flash_bwd_call`."""
    return _bwd_block(_flash_bwd_call, q, k, v, do, L, delta, q_off, k_off,
                      causal, window)


def flash_bwd_block_plain(q, k, v, do, L, delta, q_off: int, k_off: int, *,
                          causal: bool = False,
                          window: Optional[int] = None):
    """:func:`flash_bwd_block` through the plain versions on any
    device."""
    return _bwd_block(_flash_bwd_call_plain, q, k, v, do, L, delta, q_off,
                      k_off, causal, window)


# ------------------------------------------------ the trainable op


def logsumexp(m: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """The backward's residual ``L = m + log l`` of a finished carry;
    fully-masked rows (``l == 0``) get ``+1e30``, so the backward's
    ``exp2(s - L)`` underflows to an all-zero P row."""
    live = l > 0.0
    return torch.where(live, m + torch.log(torch.where(live, l, 1.0)), 1e30)


def delta_of(g: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO·O)`` in float32, from the unrounded
    cotangent."""
    return (g.float() * out.float()).sum(dim=-1)


def _flash_fwd(q, k, v, causal: bool, window):
    _check_window(window, causal)
    b, h, t, d = q.shape
    h_kv = k.shape[1]
    bh = b * h
    o, m, l = _flash_call(q.reshape(bh, t, d), k.reshape(b * h_kv, t, d),
                          v.reshape(b * h_kv, t, d),
                          *zero_carry(bh, t, d, q.device), 0, 0,
                          causal=causal, q_heads=h, window=window)
    return finalize(o, m, l, q.dtype).reshape(b, h, t, d), logsumexp(m, l)


def _flash_bwd(causal: bool, window, saved, g):
    q, k, v, out, L = saved
    b, h, t, d = q.shape
    h_kv = k.shape[1]
    bh = b * h
    # delta in torch; everything O(T²) runs in the kernels.
    delta = delta_of(g, out).reshape(bh, t)
    dq, dk, dv = _flash_bwd_call(q.reshape(bh, t, d),
                                 k.reshape(b * h_kv, t, d),
                                 v.reshape(b * h_kv, t, d),
                                 g.to(q.dtype).reshape(bh, t, d), L, delta,
                                 0, 0, causal=causal, q_heads=h,
                                 window=window)
    return (dq.to(q.dtype).reshape(b, h, t, d),
            dk.to(k.dtype).reshape(b, h_kv, t, d),
            dv.to(v.dtype).reshape(b, h_kv, t, d))


class _FlashAttention(torch.autograd.Function):
    """Forward: one zero-carry accumulate, :func:`finalize`, and the
    logsumexp residual. Saves ``(q, k, v, out, L)`` — O(T) beyond the
    inputs, no probability matrix. Backward: ``delta`` in torch, then
    the two gradient kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, L = _flash_fwd(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out, L)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, g):
        grads = _flash_bwd(ctx.causal, ctx.window, ctx.saved_tensors, g)
        return (*grads, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False,
                    window: Optional[int] = None) -> torch.Tensor:
    """Fused single-device attention, ``[B, H, T, D]`` → same,
    differentiable.

    GQA/MQA: ``k``/``v`` may be ``[B, H_kv, T, D]`` with ``H % H_kv ==
    0`` — the kernels read the narrow KV directly and dk/dv come back
    narrow. ``window``: position ``i`` attends to ``[i - window + 1,
    i]``; requires ``causal``. CUDA tensors run the three kernels, CPU
    tensors their plain versions.
    """
    return _FlashAttention.apply(q, k, v, causal, window)

