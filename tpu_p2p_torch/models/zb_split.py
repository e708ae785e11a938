"""The ZB-H1 weight split as a weight-gradient store — the port's design
for ``tpu_p2p/models/zb_split.py``.

The zero-bubble schedule (Qi et al., arXiv:2401.10241) splits a stage's
backward into ``bwd_input`` (the remat forward, the loss gradient and the
dx chain: the critical path between stages) and ``bwd_weight`` (the dW
contractions alone, which nothing downstream waits for, so they fill the
schedule's bubbles). The reference traces the fused backward once as a
jaxpr and partitions its equations by reachability. Torch has no jaxpr,
so the port uses the established PyTorch form of the same split, a
weight-gradient store: every weight product of a stage block goes
through one autograd Function (:class:`_StoredProduct`) whose backward
returns the input gradient only and records the product's ``(input,
grad_output)`` pair in the store (:class:`WeightGradStore`). The
executor then

- at a fused ``bwd`` tick, replays the records at once, right after the
  tick's ``torch.autograd.grad``;
- at a ``bwd_input`` tick, parks them in the boundary slot ``lower()``
  colored, and replays them at the microbatch's ``bwd_weight`` tick.

Both run one dW expression (:func:`weight_grad`) on the same operands,
in the same thread, and the executor accumulates each stage's dW in
microbatch order in both, so ``pp_schedule="zb"`` is bitwise the fused
``"1f1b"`` step by construction (the reference's contract). Without an
active store (the GPipe steps, the forward ticks, serving) a product is
the plain op the port computed before, bit for bit.

What the store covers: the attention projections (``wq``, ``wk``,
``wv``, ``wo``), the dense FFN's ``wf1``/``wf2``, the expert GEMMs
(``we1``/``we2``) and the generic pipeline's ``w1``/``w2``. What stays in
phase 1: the RMSNorm gains (``ln1``, ``ln2``) and the MoE router, whose
gradients autograd computes at the ``bwd_input`` tick. A leaf is either
covered whole or not at all, so its accumulation order is one of the
two, never a mix.

Under remat the split is correct and no cheaper, as in the reference: the
checkpointed block's recompute runs inside the ``bwd_input`` backward,
and the records are made there as without remat.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, List, NamedTuple, Optional

import torch

# The store of the tick being run on this thread (None: no store, the
# plain products), and the row of the stage chunk whose block is
# running (a chunk holds ``chunk_rows`` consecutive blocks).
_STORE: contextvars.ContextVar[Optional["WeightGradStore"]] = \
    contextvars.ContextVar("zb_store", default=None)
_ROW: contextvars.ContextVar[int] = contextvars.ContextVar("zb_row",
                                                          default=0)

PRODUCTS = ("matmul", "proj", "out")
# matmul: ``a @ w`` (w [K, N], or a batch of them [E, K, N] against
# a [E, M, K]); proj: ``btm,hmd->bhtd`` (a q/k/v projection of this
# rank's heads); out: ``bhtd,hdm->btm`` (the attention out-projection).


def _product(kind: str, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if kind == "matmul":
        return torch.matmul(a, w)
    if kind == "proj":
        return torch.einsum("btm,hmd->bhtd", a, w)
    if kind == "out":
        return torch.einsum("bhtd,hdm->btm", a, w)
    raise ValueError(f"unknown product {kind!r}; expected one of "
                     f"{PRODUCTS}")


def _input_grad(kind: str, g: torch.Tensor, w: torch.Tensor
                ) -> torch.Tensor:
    if kind == "matmul":
        return torch.matmul(g, w.transpose(-1, -2))
    if kind == "proj":
        return torch.einsum("bhtd,hmd->btm", g, w)
    return torch.einsum("btm,hdm->bhtd", g, w)


def weight_grad(kind: str, a: torch.Tensor, g: torch.Tensor,
                w_dims: int) -> torch.Tensor:
    """The dW of one product from its input ``a`` and output gradient
    ``g`` — the one expression both the fused and the deferred backward
    run (``w_dims``: the weight's rank, 2 or 3 for ``matmul``)."""
    if kind == "matmul":
        if w_dims == 2:
            k, n = a.shape[-1], g.shape[-1]
            return torch.matmul(a.reshape(-1, k).t(), g.reshape(-1, n))
        return torch.matmul(a.transpose(-1, -2), g)
    if kind == "proj":
        return torch.einsum("btm,bhtd->hmd", a, g)
    return torch.einsum("bhtd,btm->hdm", a, g)


class Record(NamedTuple):
    """One product's owed weight gradient: its input ``a`` and output
    gradient ``g``, replayed by :meth:`Record.grad`."""

    name: str                    # the param leaf
    row: int                     # the block within the stage chunk
    dtype: torch.dtype           # the weight's dtype as the product saw it
    kind: str
    w_dims: int
    widen: bool                  # the product widened the weight to f32
    a: torch.Tensor
    g: torch.Tensor

    def grad(self) -> torch.Tensor:
        """The dW in the weight's dtype (the widening's backward cast)."""
        dw = weight_grad(self.kind, self.a, self.g, self.w_dims)
        return dw.to(self.dtype) if self.widen else dw


class WeightGradStore:
    """Where a tick's stored products leave their weight gradients, in
    the order the backward made them."""

    def __init__(self) -> None:
        self.records: List[Record] = []

    def take(self) -> List[Record]:
        """The records made since the last take, in the order the
        backward made them."""
        out, self.records = self.records, []
        return out


def leaf_grads(records: List[Record], dtypes: Dict[str, torch.dtype]
               ) -> Dict[tuple, torch.Tensor]:
    """``(leaf, row) → dW`` in the leaf's dtype: each product's dW (in
    the weight's dtype), summed over the products of one row in record
    order (a ring's chunks), then cast to the leaf's dtype as the cast at
    block entry does in the backward."""
    out: Dict[tuple, torch.Tensor] = {}
    for r in records:
        key = (r.name, r.row)
        dw = r.grad()
        out[key] = dw if key not in out else out[key] + dw
    return {(k, i): v.to(dtypes[k]) for (k, i), v in out.items()}


def current_store() -> Optional[WeightGradStore]:
    """The store active on this thread, or None."""
    return _STORE.get()


@contextlib.contextmanager
def scope(store: Optional[WeightGradStore], row: int = 0):
    """The products inside go to ``store`` (None: the plain products) as
    row ``row`` of the stage chunk. The executor opens one around a
    backward tick; a block opens its own with both passed explicitly, so
    a remat recompute, which the backward may run on another thread (the
    card's autograd thread), routes its products as the forward did."""
    t_store, t_row = _STORE.set(store), _ROW.set(int(row))
    try:
        yield
    finally:
        _ROW.reset(t_row)
        _STORE.reset(t_store)


class _StoredProduct(torch.autograd.Function):
    """A weight product whose weight gradient goes to the store: the
    forward is the plain product; the backward returns the input's
    gradient and no weight gradient."""

    @staticmethod
    def forward(ctx, a, w, kind, name, widen, store, row):
        wf = w.float() if widen else w
        ctx.save_for_backward(a, wf)
        ctx.kind, ctx.name, ctx.widen = kind, name, widen
        ctx.store, ctx.row, ctx.dtype = store, row, w.dtype
        ctx.w_dims = w.dim()
        return _product(kind, a, wf)

    @staticmethod
    def backward(ctx, g):
        a, wf = ctx.saved_tensors
        ctx.store.records.append(Record(ctx.name, ctx.row, ctx.dtype,
                                        ctx.kind, ctx.w_dims, ctx.widen,
                                        a.detach(), g.detach()))
        da = _input_grad(ctx.kind, g, wf) if ctx.needs_input_grad[0] \
            else None
        return da, None, None, None, None, None, None


def stored_product(kind: str, a: torch.Tensor, w: torch.Tensor, name: str,
                   widen: bool = False) -> torch.Tensor:
    """The product ``kind`` of ``a`` and the weight ``w`` (leaf ``name``;
    ``widen``: ``w`` enters as float32, as the bf16 products widen their
    operands). With a store active on this thread (a backward tick of
    the tick executor) it goes through :class:`_StoredProduct`; else it
    is the plain op, the same one, so the values are bitwise equal."""
    store = _STORE.get()
    if store is None or not torch.is_grad_enabled():
        return _product(kind, a, w.float() if widen else w)
    return _StoredProduct.apply(a, w, kind, name, widen, store, _ROW.get())


def stored_matmul(a: torch.Tensor, w: torch.Tensor, name: str
                  ) -> torch.Tensor:
    """``a @ w.float()``: a float32-accumulated product whose weight is
    widened (``a`` arrives widened by the caller)."""
    return stored_product("matmul", a, w, name, widen=True)
