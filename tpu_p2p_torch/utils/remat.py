"""Rematerialization of a block: the port of the reference's
``jax.checkpoint`` around each transformer block and its
``remat_policy`` names.

``jax.checkpoint`` decides what a policy saves per ``dot_general``: a
product with batch dims (an einsum index in both operands and the
result) or without. In torch an einsum or a matmul reaches the
dispatcher as ``mm`` / ``bmm`` after reshapes, and a projection may
arrive as a ``bmm`` too, so the op cannot tell. The model marks each
product instead, by what it is in the reference's einsum
(:func:`product`): the projections, the router and the dense FFN carry
no batch dim; the expert FFN (``e`` in both operands) and the dense
attention's products do. Inside a marked region the GEMM op computes
the product; the copies that lay its operands out are not products.
The flash kernels are no product, as the reference's Pallas calls are
no ``dot_general``.

:func:`remat_block` wraps a block in ``torch.utils.checkpoint``
(non-reentrant: the recompute runs when the backward first needs a
saved tensor of the block) and, for a policy that saves products,
selective checkpointing whose policy saves the marked GEMMs it names.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Callable, Optional, Tuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    set_checkpoint_early_stop,
)

# The ``jax.checkpoint_policies`` names the reference's validator
# accepts (its policies; the factories that build one are refused),
# → which products the policy saves: every product, only those without
# batch dims, every op, or none.
REMAT_POLICIES = {
    "checkpoint_dots": "products",
    "checkpoint_dots_with_no_batch_dims": "unbatched",
    "dots_saveable": "products",
    "dots_with_no_batch_dims_saveable": "unbatched",
    "everything_saveable": "everything",
    "nothing_saveable": "nothing",
}

# The product being computed on this thread: (name, has batch dims).
_PRODUCT: contextvars.ContextVar[Optional[Tuple[str, bool]]] = \
    contextvars.ContextVar("product", default=None)

_aten = torch.ops.aten
GEMM_OPS = frozenset({_aten.mm.default, _aten.bmm.default,
                      _aten.addmm.default, _aten.baddbmm.default})


@contextlib.contextmanager
def product(name: str, batch_dims: bool):
    """Mark the product computed inside: ``name`` (what it is, for
    counts) and whether the reference's einsum has batch dims."""
    token = _PRODUCT.set((name, batch_dims))
    try:
        yield
    finally:
        _PRODUCT.reset(token)


def current_product() -> Optional[Tuple[str, bool]]:
    """The product marked on this thread, or None."""
    return _PRODUCT.get()


def _saves(saved: str, op) -> bool:
    mark = _PRODUCT.get()
    return (op in GEMM_OPS and mark is not None
            and (saved == "products" or not mark[1]))


def _policy_fn(saved: str):
    def policy(ctx, op, *args, **kwargs):
        del ctx, args, kwargs
        return (CheckpointPolicy.MUST_SAVE if _saves(saved, op)
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return policy


def remat_block(fn: Callable, remat: bool, policy: str = "",
                stop_early: bool = True) -> Callable:
    """``fn`` under rematerialization: with ``remat``, only the block's
    inputs (and what ``policy`` saves) stay for the backward, and the
    rest is recomputed inside it. ``everything_saveable`` saves every
    residual, which is the plain block. The block draws no random
    numbers, so no RNG state is kept for the recompute. The recompute
    stops once it has the tensors the backward needs, unless
    ``stop_early`` is False: a block that issues a hop and waits for it
    later (the overlap knobs' rings) must run whole, or the recompute
    can stop with a hop issued and never waited for, whose receive then
    takes the next hop's bytes."""
    saved = REMAT_POLICIES[policy] if policy else "nothing"
    if not remat or saved == "everything":
        return fn
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if saved != "nothing":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _policy_fn(saved))

    def run(*args):
        with set_checkpoint_early_stop(stop_early):
            return checkpoint(fn, *args, **kw)

    return run
