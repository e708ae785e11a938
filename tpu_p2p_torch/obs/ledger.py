"""The collective ledger's pricing convention — the port's copy of
``tpu_p2p/obs/ledger.py::wire_bytes``, which the tick IR's
:func:`~tpu_p2p_torch.models.schedule.price_program` prices hops with.
The rest of the reference module (the recording hooks, the report, the
device-event join) is not ported yet."""

from __future__ import annotations


def wire_bytes(kind: str, axis_size: int, payload_bytes: int) -> int:
    """Bytes crossing links per participant, busbw convention.

    ``payload_bytes`` is the local bytes of the collective's input
    operand (a shard for all-gather, the full local buffer for the
    reductions, the per-link buffer for ppermute).
    """
    n = int(axis_size)
    if kind in ("ppermute", "dma", "kv_migrate"):
        # Per directed link: a peer-push hop ships the same bytes over
        # the same edge as its library twin, so the two transports
        # price identically. kv_migrate is a ppermute-family ship (the
        # serving KV-page migration) and prices the same way.
        return int(payload_bytes)
    if kind == "all_gather":
        return (n - 1) * int(payload_bytes)
    if kind == "reduce_scatter":
        return (n - 1) * int(payload_bytes) // max(n, 1)
    if kind == "all_to_all":
        return (n - 1) * int(payload_bytes) // max(n, 1)
    if kind == "all_reduce":
        return 2 * (n - 1) * int(payload_bytes) // max(n, 1)
    raise ValueError(f"unknown collective kind {kind!r}")
