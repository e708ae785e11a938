"""Ulysses attention — all-to-all sequence parallelism, the port of
``tpu_p2p/ops/ulysses.py``.

With the sequence split over a mesh line, each rank holds ``[B, H,
T/n, D]`` blocks with every head. One tiled all-to-all a tensor
scatters the heads and gathers the sequence (``[B, H/n, T, D]``), the
attention runs over the whole sequence locally (the flash kernels or
dense attention), and one more all-to-all gives the sequence split
back. Needs ``H`` and ``H_kv`` divisible by the line's size.
"""

from __future__ import annotations

from tpu_p2p_torch.ops.attention import _check_window, dense_attention, \
    itemsize
from tpu_p2p_torch.parallel.collectives import axis_all_to_all


def ulysses_attention_local(q, k, v, line, *, causal: bool = False,
                            use_flash: bool = False, window=None):
    """Ulysses attention of this rank's blocks ``q [B, H, T_local, D]``,
    ``k/v [B, H_kv, T_local, D]`` over the sequence split along
    ``line``: three reshards in, one attention over the full sequence,
    one reshard out; differentiable (each reshard's backward is its
    inverse)."""
    _check_window(window, causal)
    n = line.size
    for name, count in (("query heads", q.shape[1]),
                        ("KV heads", k.shape[1])):
        if count % n:
            raise ValueError(
                f"Ulysses needs {name} ({count}) divisible by axis size "
                f"({n}); use ring attention below that")
    qh, kh, vh = (axis_all_to_all(x, line, 1, 2) for x in (q, k, v))
    if use_flash:
        from tpu_p2p_torch.ops.flash_attention import flash_attention

        ah = flash_attention(qh, kh, vh, causal, window)
    else:
        ah = dense_attention(qh, kh, vh, causal=causal, window=window)
    return axis_all_to_all(ah, line, 2, 1)


def ulysses_attention(mesh, axis: str, causal: bool = False,
                      use_flash: bool = False, window=None):
    """Ulysses attention over ``mesh`` as the benchmark calls it, with
    :func:`tpu_p2p_torch.ops.attention.ring_attention`'s convention:
    ``fn(q, k, v)`` of this rank's ``T`` blocks along ``axis`` → this
    rank's block of the output."""
    line = mesh.line(axis)

    def fn(q, k, v):
        return ulysses_attention_local(q, k, v, line, causal=causal,
                                       use_flash=use_flash, window=window)

    return fn


def a2a_bytes_per_reshard(b: int, h: int, t: int, d: int, n: int,
                          dtype) -> int:
    """Bytes each rank exchanges a tensor reshard: all but the ``1/n``
    chunk it keeps of its ``B·H·(T/n)·D`` block."""
    local = b * h * t * d * itemsize(dtype) // n
    return local * (n - 1) // n
