"""Paged KV cache — pages, tables, free-list, prefix index and the
mixed step. Port of ``tpu_p2p/serve/paged_cache.py``.

- **The pool**: per projection, ``[stages, num_pages, H_kv, page_len,
  Dh]``. Logical position ``p`` of a request lives in its
  ``p // page_len``-th page at row ``p % page_len``.
- **Page tables**: per slot, ``[max_blocks]`` page indices in logical
  order; unallocated blocks point at the reserved **trash page 0**,
  where idle slots' no-op writes land and whose reads are always
  masked.
- **The free-list** (:class:`PagePool`) and **prefix index**
  (:class:`PrefixIndex`): host-side, refcounted, per shard.
- **The mixed step** (:func:`make_paged_lm_step`): every slot
  processes ``n_active ∈ [0, chunk]`` tokens, writes their K/V rows
  into its pages straight from the projections, K and V in one launch
  of the hand-written kernel
  (:func:`tpu_p2p_torch.ops.kvcache.paged_kv_write`, in place), and
  attends over its page-gathered KV through the same
  :func:`~tpu_p2p_torch.models.decode._attend_ffn` the dense step runs.

Masked keys score ``NEG_INF``, whose softmax weight underflows to an
exact 0, so stale rows in recycled pages (and the trash page) never
reach the output.

On a serve mesh (a :class:`~tpu_p2p_torch.parallel.runtime.LocalMesh`
over ``dp``, and ``tp``/``ep`` where the model splits) the pool splits
as the reference's ``paged_pool_spec`` splits it: pages over dp×ep into
:func:`pool_shards` shards, KV heads over tp. Each rank holds its block
as a tensor of its own (:func:`init_pool_shards`): shard ``k``'s
``num_pages / n`` pages with their own trash page 0, indexed by the
shard-local tables of the slots the shard serves, and the rank's
``H_kv / tp`` heads. The mixed step over the mesh
(:func:`make_paged_lm_step` with a mesh) runs every rank's step in a
thread of its own when it meets at a collective (tp or ep joins, ZeRO
gathers), each rank writing its heads of its shard's rows.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from tpu_p2p_torch.models.decode import (
    _attend_ffn,
    _check_decode_mesh,
    _stage_params,
    _unembed,
    batch_shards,
    check_serving_cfg,
    gather_zero,
    mesh_and_cfg,
    rank_shard,
    step_lines,
    step_threads,
)
from tpu_p2p_torch.models.flagship import (
    FlagshipConfig,
    _fsdp_plan,
    _rms_norm,
    torch_dtype,
)
from tpu_p2p_torch.ops.kvcache import paged_kv_write
from tpu_p2p_torch.ops.rope import apply_rope

Pool = Dict[str, torch.Tensor]

# Page 0 is reserved: idle writes are routed there and tables point
# unallocated blocks at it. The free-list never hands it out.
TRASH_PAGE = 0


class OutOfPages(RuntimeError):
    """Free-list exhausted — the scheduler's admission signal."""


class PagePool:
    """Host-side refcounted page free-list, one list per shard.

    Invariants: a page is never handed out twice, the trash page is
    never handed out, freeing a page not currently allocated (or twice
    in one call) raises and changes nothing, and after every request
    finishes the pool is exactly full again. ``alloc`` hands a page out
    with refcount 1, :meth:`retain` adds holders, :meth:`free`
    decrements and returns the page to the free list at 0; a holder
    treats any page with refcount > 1 as read-only (the batcher forks
    it copy-on-write before writing).
    """

    def __init__(self, num_pages: int, page_len: int,
                 n_shards: int = 1, name: str = "kv") -> None:
        if page_len <= 0 or page_len % 8:
            raise ValueError(
                f"page_len must be a positive multiple of 8 (the band "
                f"write granularity), got {page_len}"
            )
        if n_shards <= 0 or num_pages % n_shards:
            raise ValueError(
                f"num_pages ({num_pages}) must divide by the shard "
                f"count ({n_shards})"
            )
        per_shard = num_pages // n_shards
        if per_shard < 2:
            raise ValueError(
                f"need >= 2 pages per shard (trash + 1 usable), got "
                f"{per_shard}"
            )
        self.name = str(name)
        self.page_len = page_len
        self.n_shards = n_shards
        self.pages_per_shard = per_shard
        self._free: List[List[int]] = [
            list(range(per_shard - 1, TRASH_PAGE, -1))
            for _ in range(n_shards)
        ]
        self._allocated = [set() for _ in range(n_shards)]
        self._refs: List[Dict[int, int]] = [{} for _ in range(n_shards)]
        self._usable = per_shard - 1

    @property
    def capacity(self) -> int:
        """Usable pages per shard."""
        return self._usable

    def clamp_capacity(self, usable: int) -> None:
        """Withhold pages so at most ``usable`` per shard are ever
        allocatable (construction time only)."""
        if usable < 1:
            raise ValueError(
                f"pool {self.name!r}: clamp must leave >= 1 usable "
                f"page per shard, got {usable}"
            )
        if any(self._allocated):
            raise RuntimeError(
                f"pool {self.name!r}: clamp_capacity applies at "
                "construction, before any page is handed out"
            )
        usable = min(usable, self.pages_per_shard - 1)
        for shard in range(self.n_shards):
            del self._free[shard][: len(self._free[shard]) - usable]
        self._usable = usable

    def available(self, shard: int = 0) -> int:
        return len(self._free[shard])

    def alloc(self, shard: int = 0) -> int:
        """→ one shard-local page index; raises :class:`OutOfPages`."""
        if not self._free[shard]:
            raise OutOfPages(
                f"pool {self.name!r} shard {shard}: all "
                f"{self.capacity} pages in use"
            )
        pid = self._free[shard].pop()
        self._allocated[shard].add(pid)
        self._refs[shard][pid] = 1
        return pid

    def alloc_n(self, n: int, shard: int = 0) -> List[int]:
        """Allocate ``n`` pages atomically (all or nothing)."""
        if self.available(shard) < n:
            raise OutOfPages(
                f"pool {self.name!r} shard {shard}: need {n} pages, "
                f"{self.available(shard)} free"
            )
        return [self.alloc(shard) for _ in range(n)]

    def ref(self, pid: int, shard: int = 0) -> int:
        """Current refcount of a page (0 for free pages)."""
        return self._refs[shard].get(pid, 0)

    def allocated(self, shard: int = 0) -> frozenset:
        """Snapshot of the shard's live page ids."""
        return frozenset(self._allocated[shard])

    def retain(self, pages: Sequence[int], shard: int = 0) -> None:
        """Add one reference to each of ``pages``, atomically. A
        repeated pid takes two references."""
        pages = list(pages)
        for pid in pages:
            if pid not in self._allocated[shard]:
                raise ValueError(
                    f"pool {self.name!r} shard {shard}: page {pid} "
                    "is not allocated — cannot retain a free or "
                    "trash page; nothing was retained"
                )
        for pid in pages:
            self._refs[shard][pid] += 1

    def free(self, pages: Sequence[int], shard: int = 0) -> None:
        """Release one reference to each of ``pages``, atomically: the
        whole list is validated before any count moves, and a repeated
        pid in one call is an error."""
        pages = list(pages)
        seen: set = set()
        for pid in pages:
            if pid not in self._allocated[shard] or pid in seen:
                raise ValueError(
                    f"pool {self.name!r} shard {shard}: page {pid} "
                    "is not allocated (double free, trash page, out "
                    "of range, or repeated in this call) — nothing "
                    "was freed"
                )
            seen.add(pid)
        for pid in pages:
            self._refs[shard][pid] -= 1
            if self._refs[shard][pid] == 0:
                del self._refs[shard][pid]
                self._allocated[shard].remove(pid)
                self._free[shard].append(pid)


def kv_page_bytes(cfg: FlagshipConfig, page_len: int) -> int:
    """Bytes one KV page holds across both projections and all stages:
    ``2 · stages · H_kv · page_len · Dh · itemsize``."""
    itemsize = torch_dtype(cfg.dtype).itemsize
    return (2 * cfg.stages * cfg.num_kv_heads * page_len
            * cfg.head_dim * itemsize)


def _chain_key(prev: Optional[bytes], page_tokens: np.ndarray) -> bytes:
    """Position-dependent content hash of one full page of prompt
    tokens, ``H(parent_key ‖ tokens)``: two prompts share a key iff
    every token up to the page boundary agrees."""
    h = hashlib.blake2b(prev or b"tpu-p2p/prefix", digest_size=16)
    h.update(np.ascontiguousarray(page_tokens, np.int32).tobytes())
    return h.digest()


class PrefixIndex:
    """Per-shard map ``chain-key → page id`` over registered full pages
    of prompt tokens. Registering retains the page (the index is a
    holder), eviction releases it; most recently registered entries
    evict first, so under pressure matches shorten instead of chains
    losing their heads."""

    def __init__(self, pool: PagePool) -> None:
        self.pool = pool
        self.page_len = pool.page_len
        self._index: List[Dict[bytes, int]] = [
            {} for _ in range(pool.n_shards)]

    def held(self, shard: int = 0) -> int:
        """How many pages the shard's index currently references."""
        return len(self._index[shard])

    def _keys(self, prompt: np.ndarray) -> List[bytes]:
        """Chain keys for every full page of ``prompt``."""
        keys: List[bytes] = []
        prev: Optional[bytes] = None
        L = self.page_len
        for b in range(len(prompt) // L):
            prev = _chain_key(prev, prompt[b * L:(b + 1) * L])
            keys.append(prev)
        return keys

    def lookup(self, prompt: np.ndarray, shard: int = 0) -> List[int]:
        """Longest indexed chain for ``prompt`` (page ids of full prompt
        pages 0..k-1). Takes no references."""
        pages: List[int] = []
        idx = self._index[shard]
        for key in self._keys(prompt):
            pid = idx.get(key)
            if pid is None:
                break
            pages.append(pid)
        return pages

    def register(self, prompt: np.ndarray, pages: Sequence[int],
                 shard: int = 0) -> int:
        """Offer a completed prefill's full prompt pages; → how many new
        pages were indexed (first writer wins). Each retains its page."""
        added = 0
        idx = self._index[shard]
        for b, key in enumerate(self._keys(prompt)):
            if b >= len(pages):
                break
            if key in idx:
                continue
            pid = int(pages[b])
            self.pool.retain([pid], shard)
            idx[key] = pid
            added += 1
        return added

    def evict_one(self, shard: int = 0) -> bool:
        """Release the most recently registered entry; → False when the
        index is empty."""
        idx = self._index[shard]
        if not idx:
            return False
        _, pid = idx.popitem()
        self.pool.free([pid], shard)
        return True

    def release_all(self) -> None:
        """Drop every held reference (drain-time accounting)."""
        for shard in range(self.pool.n_shards):
            while self.evict_one(shard):
                pass


def pool_shards(mesh) -> int:
    """How many ways the page axis splits: the product of the mesh's
    ``dp`` and ``ep`` sizes."""
    return batch_shards(mesh)


def init_pool_shards(cfg: FlagshipConfig, num_pages: int, page_len: int,
                     mesh) -> List[Pool]:
    """Zeroed pool blocks for ``num_pages`` global pages (which must
    divide by the dp×ep shard count), one a rank on its device: rank
    ``i`` holds ``num_pages / n`` pages of its shard
    (:func:`~tpu_p2p_torch.models.decode.rank_shard`) and its
    ``H_kv / tp`` KV heads."""
    _check_decode_mesh(mesh, cfg)
    if page_len <= 0 or page_len % 8:
        raise ValueError(
            f"page_len must be a positive multiple of 8, got {page_len}"
        )
    n_shards = pool_shards(mesh)
    if num_pages % n_shards:
        raise ValueError(
            f"num_pages ({num_pages}) must divide by the dp×ep shard "
            f"count ({n_shards})"
        )
    heads = cfg.num_kv_heads // mesh.shape.get("tp", 1)
    return [_zero_pool(cfg, num_pages // n_shards, page_len, heads, dev)
            for dev in mesh.devices]


def init_paged_pool(cfg: FlagshipConfig, num_pages: int, page_len: int,
                    device="cuda", *, mesh=None):
    """Zeroed page pool, one tensor per projection; with ``mesh``, the
    per-rank blocks of :func:`init_pool_shards`."""
    if page_len <= 0 or page_len % 8:
        raise ValueError(
            f"page_len must be a positive multiple of 8, got {page_len}"
        )
    if mesh is not None:
        return init_pool_shards(cfg, num_pages, page_len, mesh)
    return _zero_pool(cfg, num_pages, page_len, cfg.num_kv_heads, device)


def _zero_pool(cfg: FlagshipConfig, num_pages: int, page_len: int,
               heads: int, device) -> Pool:
    shape = (cfg.stages, num_pages, heads, page_len, cfg.head_dim)
    dtype = torch_dtype(cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _gather_pages(pool_s, table):
    """``pool_s [P, H, L, Dh]`` × ``table [B, max_blocks]`` → the
    per-slot logical KV view ``[B, H, max_blocks·L, Dh]``."""
    g = pool_s[table]                       # [B, mb, H, L, Dh]
    b, mb, h, l, dh = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(b, h, mb * l, dh)


def _ints(a, dev) -> torch.Tensor:
    """A step's integer input as int64 on ``dev``: a tensor moved, or a
    host array copied in."""
    if isinstance(a, torch.Tensor):
        return a.to(dev, torch.int64)
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev, torch.int64)


def _check_paged(cfg: FlagshipConfig, page_len: int, chunk: int) -> None:
    check_serving_cfg(cfg)
    if chunk not in (1, 2, 4, 8):
        raise ValueError(
            f"chunk must be one of 1/2/4/8 (band-aligned prefill), "
            f"got {chunk}"
        )
    if page_len % 8:
        raise ValueError(
            f"page_len must be a multiple of 8, got {page_len}"
        )
    if cfg.attn_window:
        raise ValueError(
            "the paged step masks by position; attn_window is not "
            "supported (size the page window instead)"
        )


def _paged_body(cfg: FlagshipConfig, page_len: int, t_win: int, params,
                pool: Pool, tokens, pos, n_active, table, tp=None, ep=None):
    """One rank's mixed step over its rows (one device: every row): the
    K/V rows written into the slots' pages, then attention over the
    page-gathered view and the FFN through the shared
    :func:`~tpu_p2p_torch.models.decode._attend_ffn`, its joins on the
    rank's ``tp``/``ep`` lines. → ``(pool, logits)``."""
    compute = torch_dtype(cfg.dtype)
    x = params["emb"][tokens].to(compute)
    k_pool, v_pool = pool["k"], pool["v"]
    dev = tokens.device
    c = tokens.shape[1]
    offs = torch.arange(c, device=dev)
    qpos = pos[:, None] + offs[None, :]                 # [B, C]
    # Write coordinates: one band per slot per step; idle slots park on
    # the trash page with n = 0.
    blk = pos // page_len
    page = torch.where(n_active > 0,
                       table.gather(1, blk[:, None])[:, 0],
                       TRASH_PAGE).to(torch.int32)
    band = ((pos % page_len) // 8).to(torch.int32)
    r0 = (pos % 8).to(torch.int32)
    n32 = n_active.to(torch.int32)
    kp = torch.arange(t_win, device=dev)
    live = (kp[None, None, :] <= qpos[:, :, None]) \
        & (offs[None, :] < n_active[:, None])[:, :, None]
    live = live[:, None, None]                          # [B,1,1,C,T]
    for s in range(cfg.stages):
        sub = _stage_params(params, s, compute)
        h = _rms_norm(x, sub["ln1"]) if cfg.norm else x
        k_t = torch.einsum("btm,hmd->bhtd", h, sub["wk"])
        v_t = torch.einsum("btm,hmd->bhtd", h, sub["wv"])
        if cfg.rope:
            k_t = apply_rope(k_t, qpos)
        paged_kv_write(k_pool, v_pool, k_t, v_t, page, band, r0, n32, s)
        kb = _gather_pages(k_pool[s], table)
        vb = _gather_pages(v_pool[s], table)
        q = torch.einsum("btm,hmd->bhtd", h, sub["wq"])
        if cfg.rope:
            q = apply_rope(q, qpos)
        x = _attend_ffn(sub, x, q, kb, vb, live, cfg, tp, ep)
    if cfg.norm:
        x = _rms_norm(x, params["lnf"])
    return pool, _unembed(x, params["emb"], compute)


class MeshPagedStep:
    """The mixed step over a serve mesh: ``(params, pools, tokens, pos,
    n_active, table, ranks=None) → (pools, logits)``, every argument
    and result a per-rank list (the rank's params shard, pool block and
    its shard's rows, :func:`~tpu_p2p_torch.models.decode.split_rows`);
    a rank left out of ``ranks`` runs nothing and gets ``None`` logits.
    ``sync=False``: the caller orders the inputs for the ranks' streams
    and reads the logits on them (``LocalMesh.run``). The ranks that meet at a collective run at once, a thread each
    (``threads``); :meth:`ranks_for` says which must run together."""

    def __init__(self, mesh, cfg: FlagshipConfig, page_len: int,
                 max_blocks: int) -> None:
        self.mesh, self.cfg = mesh, cfg
        self.page_len, self.t_win = page_len, max_blocks * page_len
        self.plan = _fsdp_plan(mesh, cfg)
        self.threads = step_threads(mesh, cfg)

    def ranks_for(self, shards) -> List[int]:
        """The ranks that run a step in which the batch shards
        ``shards`` have active rows: every rank of a dp coordinate one
        of them sits on (its tp and ep lines meet), every rank at all
        when the params are ZeRO-stored (the dp line meets too), none
        when no shard is active."""
        shards = set(shards)
        if not shards:
            return []
        mesh = self.mesh
        if self.plan is not None:
            return list(range(mesh.size))
        ep = mesh.shape.get("ep", 1)
        dps = {s // ep for s in shards}
        return [i for i in range(mesh.size)
                if rank_shard(mesh, i) // ep in dps]

    @torch.no_grad()
    def __call__(self, params, pools, tokens, pos, n_active, table,
                 ranks=None, sync: bool = True):
        cfg, plan = self.cfg, self.plan

        def body(rank, p, pool, tk, ps, na, tb):
            tp, ep, dp = step_lines(rank)
            dev = rank.device
            return _paged_body(cfg, self.page_len, self.t_win,
                               gather_zero(p, dp, plan), pool,
                               _ints(tk, dev), _ints(ps, dev),
                               _ints(na, dev), _ints(tb, dev), tp, ep)

        ranks = list(range(self.mesh.size)) if ranks is None else ranks
        out = self.mesh.run(body, params, pools, tokens, pos, n_active,
                            table, ranks=ranks, threads=self.threads,
                            sync=sync)
        pools, logits = list(pools), [None] * self.mesh.size
        for i, (pool, lg) in zip(ranks, out):
            pools[i], logits[i] = pool, lg
        return pools, logits


def make_paged_lm_step(mesh, cfg: Optional[FlagshipConfig] = None, *,
                       page_len: int, max_blocks: int, chunk: int):
    """The mixed prefill/decode step over a fixed-width slot batch:

    ``(params, pool, tokens [B, C], pos [B], n_active [B],
    table [B, max_blocks]) → (pool, logits [B, C, vocab] float32)``

    Integer inputs are int64 tensors on the pool's device. Slot ``b``'s
    tokens ``tokens[b, :n_active[b]]`` sit at positions ``pos[b] ..
    pos[b] + n_active[b] - 1``: a prefill chunk, one decode token (or a
    speculative window), or nothing (``n_active = 0``: the write parks on
    the trash page and every key is masked). Each slot's K/V rows are
    written into its pages first, in place, then attention runs over
    the page-gathered view with the causal mask ``key_pos ≤
    query_pos``. Rows ``c ≥ n_active[b]`` give logits the caller
    ignores. Multi-token chunks start at ``pos ≡ 0 (mod chunk)``, so a
    step's rows never leave one 8-row band.

    ``make_paged_lm_step(cfg, ...)``: one device. ``make_paged_lm_step(
    mesh, cfg, ...)``: the same step over a serve mesh, a
    :class:`MeshPagedStep` over per-rank lists (slots and tables over
    dp×ep with shard-local page ids, KV heads over tp, ZeRO-stored
    params gathered at entry), as the reference's ``shard_map``.
    """
    mesh, cfg = mesh_and_cfg(mesh, cfg)
    _check_paged(cfg, page_len, chunk)
    if mesh is not None:
        _check_decode_mesh(mesh, cfg)
        return MeshPagedStep(mesh, cfg, page_len, max_blocks)
    t_win = max_blocks * page_len

    @torch.no_grad()
    def step(params, pool: Pool, tokens, pos, n_active, table):
        return _paged_body(cfg, page_len, t_win, params, pool, tokens, pos,
                           n_active, table)

    return step


def page_copy(pool: Pool, src: int, dst: int) -> Pool:
    """The copy-on-write fork's device copy: page ``src`` → ``dst`` in
    both projections and every stage, in place (plain indexing; the
    reference's is a plain dynamic slice too)."""
    for buf in pool.values():
        buf[:, dst] = buf[:, src]
    return pool


def make_page_copy(mesh, cfg: Optional[FlagshipConfig] = None):
    """The per-shard page copy of the copy-on-write fork:

    ``(pools, src [n_shards], dst [n_shards]) → pools``

    Every rank of shard ``k`` copies its block of local page ``src[k] →
    dst[k]`` (its KV heads) on its own stream, in place; a shard with
    nothing to fork passes ``TRASH_PAGE → TRASH_PAGE`` (the reference's
    idle no-op) and issues nothing. ``pools`` is the per-rank list."""
    if cfg is not None:
        _check_decode_mesh(mesh, cfg)

    def copy(pools: List[Pool], src, dst) -> List[Pool]:
        for i in range(mesh.size):
            k = rank_shard(mesh, i)
            s, d = int(src[k]), int(dst[k])
            if (s, d) != (TRASH_PAGE, TRASH_PAGE):
                with mesh.on(i):
                    page_copy(pools[i], s, d)
        return pools

    return copy
