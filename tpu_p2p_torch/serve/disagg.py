"""Disaggregated prefill/decode serving — ``serve --disagg``. Port of
``tpu_p2p/serve/disagg.py``.

The colocated batcher runs every slot's chunked prefill and its decode
in one mixed step, so a burst of long prompts steals step time from
every decode in flight. Here the ranks split (:func:`build_disagg_meshes`):

- **prefill** runs on ranks ``0..p-1``, a ``1 × tp`` mesh with
  ``p = prefill_tp``: chunked prefill only, tensor-parallel (KV heads,
  attention heads and the FFN split over tp, the joins in the ranks'
  threads), its own page pool tagged ``"prefill"`` with each rank
  holding its heads;
- **decode** runs on ranks ``p..n-1``, one replica each: single-token
  decode (or a speculative window) only, one pool shard per replica,
  tagged ``"decode"``, the decode slots split evenly over the replicas;
- **migration**: when a request's prefill completes (its first token
  comes off the last chunk's logits), its KV pages move prefill →
  decode as explicit transfers over the ``mig`` mesh
  (:class:`KvMigrator`): one edge ``(src, p + shard)`` per prefill rank
  ``src`` per projection, each carrying the rank's head slice, through
  :func:`tpu_p2p_torch.parallel.collectives.chunked_ppermute_compute`,
  over ``transport="xla"`` (a library copy) or ``"pallas_dma"`` (the
  peer-push and fused-ship kernels); the arrivals join on the head axis
  at the destination.

One controller drives every rank, as in the reference: the ``mig`` mesh
is a :class:`~tpu_p2p_torch.parallel.runtime.LocalMesh` of this
process's devices, prefill first, where a card may repeat (one H100
holds a prefill and a decode rank); each rank issues its work on its own
CUDA stream.

Completed prefills wait in a FIFO migration queue until a decode shard
has a free slot and pages (``migrate_wait_steps``). A decode-side
preemption re-enqueues the victim at the head of the prefill queue with
its generated ids riding as prompt extension: no completed token is
lost. Scheduling is length-driven, so :func:`simulate_disagg_schedule`
is the device-free, event-exact twin.

The prefix cache lives prefill-side (shared pages in the prefill pool,
copy-on-write forks, full prompt pages registered before the resident
set enters the migration queue); speculative decoding lives decode-side.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_p2p_torch.config import SERVE_STOPS, TRANSPORTS
from tpu_p2p_torch.models.decode import ngram_propose, spec_verify
from tpu_p2p_torch.models.flagship import place_local_params
from tpu_p2p_torch.obs import ledger as _obs
from tpu_p2p_torch.parallel import collectives as C
from tpu_p2p_torch.parallel.runtime import LocalMesh
from tpu_p2p_torch.serve.batcher import (
    Request,
    _Slot,
    build_slot_inputs,
    percentile,
)
from tpu_p2p_torch.serve.paged_cache import (
    OutOfPages,
    PagePool,
    PrefixIndex,
    TRASH_PAGE,
    init_pool_shards,
    kv_page_bytes,
    make_paged_lm_step,
    page_copy,
)
from tpu_p2p_torch.serve.resilience import (
    OUTCOME_COMPLETED,
    OUTCOME_SHED_ADMISSION,
    OUTCOME_SHED_DEADLINE,
    choose_victim,
    eos_stop,
    preempt_recover_steps,
)

__all__ = [
    "build_disagg_meshes",
    "KvMigrator",
    "DisaggBatcher",
    "simulate_disagg_schedule",
    "run_disagg_engine",
]

MIG_AXIS = "mig"


def build_disagg_meshes(prefill_tp: int = 0, devices: Sequence = ()
                        ) -> Tuple[LocalMesh, LocalMesh, LocalMesh]:
    """Partition ``devices`` into the disagg ranks, validated as the
    reference validates its submeshes: → ``(prefill mesh (1×tp over
    ("dp", "tp")), decode mesh (dp replicas), mig mesh)``, the mig mesh
    a ``LocalMesh`` over all of them, prefill ranks first (the migration
    edges' numbering), the other two its submeshes (the same ranks and
    streams).

    ``prefill_tp`` is the prefill side's tp size and rank count; 0 =
    auto, half the devices."""
    devices = list(devices)
    n = len(devices)
    if n < 2:
        raise ValueError(
            f"disagg needs >= 2 devices (a prefill submesh AND a "
            f"decode submesh), got {n}"
        )
    p = int(prefill_tp) if prefill_tp else max(1, n // 2)
    if not 1 <= p <= n - 1:
        raise ValueError(
            f"prefill_tp ({p}) must partition {n} devices into a "
            f"1×tp prefill submesh and >= 1 decode replica "
            f"(1 <= prefill_tp <= {n - 1})"
        )
    mig = LocalMesh(devices, (MIG_AXIS,))
    return _split_mig(mig, p) + (mig,)


def _split_mig(mig: LocalMesh, p: int) -> Tuple[LocalMesh, LocalMesh]:
    """The prefill (``1 × p`` over dp, tp) and decode (dp) submeshes of
    the ``mig`` mesh, its first ``p`` ranks and the rest."""
    return (mig.submesh(range(p), ("dp", "tp"), (1, p)),
            mig.submesh(range(p, mig.size), ("dp",)))


class KvMigrator:
    """KV-page migration from the prefill pool to a decode shard's pool
    over the ``mig`` mesh, whose first ``n_prefill`` ranks are the
    prefill side's tp ranks: **extract** (the request's pages out of
    each prefill rank's pool block, ``[stages, blocks, H_kv / tp,
    page_len, Dh]`` per projection, on the rank's stream), **ship** (one
    directed edge ``(src, n_prefill + shard)`` per prefill rank ``src``
    per projection through
    :func:`~tpu_p2p_torch.parallel.collectives.chunked_ppermute_compute`
    over ``page_len`` in ``chunks`` hops; the decode ranks' inputs are
    cached zero rows, the no-arrival rows of the reference's
    ``_to_mig_rows``), the arrivals joined on the head axis in prefill
    rank order, and **deposit** (the full-head block into the
    destination shard's fresh pages, the other shards' zero arrivals
    into their trash page). A migration ends when every rank's stream
    has drained, as the reference's ends in ``block_until_ready``."""

    def __init__(self, mig: LocalMesh, cfg, *, page_len: int,
                 transport: str = "xla", chunks: int = 1,
                 n_prefill: int = 1) -> None:
        if transport not in TRANSPORTS:
            raise ValueError(
                f"unknown transport {transport!r}; expected one of "
                f"{TRANSPORTS}"
            )
        if not 1 <= n_prefill < mig.size:
            raise ValueError(
                f"{n_prefill} prefill ranks on a mig mesh of {mig.size}")
        self.mig = mig
        self.cfg = cfg
        self.page_len = int(page_len)
        self.transport = transport
        self.chunks = max(1, int(chunks))
        self.n_prefill = int(n_prefill)
        self._zero_rows: Dict[tuple, torch.Tensor] = {}
        self._programs: Dict[tuple, Callable] = {}  # ledger programs

    def block_bytes(self, blocks: int) -> int:
        """Bytes one migration of ``blocks`` pages ships: K and V, full
        heads (the sum over the prefill ranks' head slices)."""
        return kv_page_bytes(self.cfg, self.page_len) * int(blocks)

    def _extract(self, pre_pools, pages: Sequence[int]) -> list:
        """Per projection, each prefill rank's head slice of the pages,
        made on its stream; the caller's stream then waits for them."""
        out = {"k": [], "v": []}
        for i, pool in enumerate(pre_pools):
            dev = self.mig.devices[i]
            with self.mig.on(i):
                idx = torch.tensor(list(pages), dtype=torch.int64,
                                   device=dev)
                for proj in out:
                    out[proj].append(pool[proj].index_select(1, idx))
            if self.mig.streams[i] is not None:
                torch.cuda.current_stream(dev).wait_stream(
                    self.mig.streams[i])
        return [out["k"], out["v"]]

    def _rows(self, blocks: list) -> list:
        """The ship's per-rank input: each prefill rank's head slice, and
        cached zeros of that shape on every decode rank."""
        rows = list(blocks)
        for r in range(self.n_prefill, self.mig.size):
            key = (tuple(blocks[0].shape), blocks[0].dtype, r)
            z = self._zero_rows.get(key)
            if z is None:
                z = torch.zeros(blocks[0].shape, dtype=blocks[0].dtype,
                                device=self.mig.devices[r])
                self._zero_rows[key] = z
            rows.append(z)
        return rows

    def _ship(self, blocks: list, dst_rank: int) -> list:
        """Every prefill rank's slice to ``dst_rank``, one edge a prefill
        rank; → per mig rank, the arrivals joined on the head axis."""
        rows = self._rows(blocks)
        parts = [C.chunked_ppermute_compute(
            lambda c, _i: c, rows, self.mig, ((src, int(dst_rank)),),
            chunk_dim=3, chunks=self.chunks, transport=self.transport,
            label=f"kv_migrate:{self.transport}", kind="kv_migrate")
            for src in range(self.n_prefill)]
        if self.n_prefill == 1:
            return parts[0]
        return [None if r < self.n_prefill
                else torch.cat([p[r] for p in parts], dim=2)
                for r in range(self.mig.size)]

    def _deposit(self, dec_pools, arrived, dec_pages: Sequence[int],
                 dst_shard: int) -> None:
        blocks = len(dec_pages)
        for shard, pool in enumerate(dec_pools):
            r = self.n_prefill + shard
            dev = self.mig.devices[r]
            pages = (list(dec_pages) if shard == dst_shard
                     else [TRASH_PAGE] * blocks)
            own = self.mig.streams[r]
            if own is not None:
                # The arrivals were assembled on the caller's stream:
                # this rank's stream waits for them (an event).
                own.wait_stream(torch.cuda.current_stream(dev))
            with self.mig.on(r):
                idx = torch.tensor(pages, dtype=torch.int64, device=dev)
                for proj, rows in zip(("k", "v"), arrived):
                    if own is not None:
                        rows[r].record_stream(own)
                    pool[proj][:, idx] = rows[r].to(pool[proj].dtype)

    def migrate(self, pre_pools, prefill_pages: List[int], dec_pools,
                dec_pages: List[int], dst_shard: int) -> None:
        """Move one request's resident KV pages across, into
        ``dec_pools[dst_shard]`` in place. ``pre_pools``: each prefill
        rank's pool block (one pool alone for one prefill rank);
        ``prefill_pages`` / ``dec_pages`` are the shard-local page
        indices on each side (same length)."""
        if isinstance(pre_pools, dict):
            pre_pools = [pre_pools]
        if len(pre_pools) != self.n_prefill:
            raise ValueError(f"{len(pre_pools)} prefill pool blocks for "
                             f"{self.n_prefill} prefill ranks")
        if len(dec_pages) != len(prefill_pages):
            raise ValueError(
                f"migration of {len(prefill_pages)} prefill pages into "
                f"{len(dec_pages)} decode pages")
        blocks = self._extract(pre_pools, prefill_pages)
        # One ledger program a (pages, destination), as the reference
        # compiles one ship a key: its first call records.
        key = (len(prefill_pages), int(dst_shard))
        ship = self._programs.get(key)
        if ship is None:
            ship = self._programs[key] = _obs.program(
                lambda bl, dst: [self._ship(b, dst) for b in bl])
        arrived = ship(blocks, self.n_prefill + int(dst_shard))
        self._deposit(dec_pools, arrived, dec_pages, int(dst_shard))
        self.mig.synchronize()


class DisaggBatcher:
    """Two slot banks, two page pools, one scheduler step.

    Per engine step: shed expired, admit the queue into PREFILL slots
    (the prefill's resident pages reserved up front — prefill never
    grows), grow/preempt DECODE tables (a victim re-enqueues to the
    prefill queue head with zero token loss), run both sides' mixed
    steps, advance both banks (a completing prefill emits its first
    token and enters the migration queue; a decode slot emits its
    tokens), then drain the migration queue FIFO into decode shards with
    a free slot and pages (head-of-line strict).

    ``dry=True`` builds no device state (``mig``/``cfg``/``params`` may
    be None) and records the same events — scheduling is length-driven,
    so dry == real is event-exact (:func:`simulate_disagg_schedule`).
    """

    def __init__(self, mig: Optional[LocalMesh], cfg, params, *,
                 slots: int, prefill_slots: int, page_len: int,
                 num_pages: int, prefill_pages: int, max_blocks: int,
                 chunk: int, dry: bool = False,
                 n_decode_shards: Optional[int] = None,
                 queue_depth: int = 0, deadline_steps: int = 0,
                 stop: str = "length", stop_seed: int = 0,
                 eos_prob: float = 0.0, prefix_cache: bool = False,
                 spec_k: int = 0, transport: str = "xla",
                 migrate_chunks: int = 1, prefill_tp: int = 1,
                 placement: Optional[Callable] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if stop not in SERVE_STOPS:
            raise ValueError(
                f"unknown stop rule {stop!r}; expected one of "
                f"{SERVE_STOPS}"
            )
        if not 0 <= spec_k <= 7:
            raise ValueError(
                f"spec_k must be in 0..7, got {spec_k} (the decode "
                "window of 1 + spec_k tokens can never exceed the "
                "8-row write band)"
            )
        if spec_k and dry:
            raise ValueError(
                "speculative decoding is VALUE-driven — accepted "
                "window lengths depend on verified token values, so "
                "no dry twin can replay the schedule; refusing"
            )
        if stop == "eos" and not 0.0 < eos_prob < 1.0:
            raise ValueError(
                f"stop='eos' needs eos_prob in (0, 1), got {eos_prob}"
            )
        if n_decode_shards is None:
            if mig is None:
                raise ValueError("dry DisaggBatcher needs n_decode_shards")
            n_decode_shards = mig.size - prefill_tp
        if slots % n_decode_shards:
            raise ValueError(
                f"decode slots ({slots}) must divide by the decode "
                f"replica count ({n_decode_shards})"
            )
        if prefill_slots <= 0:
            raise ValueError("prefill_slots must be positive")
        self.cfg = cfg
        self.mig = mig
        self.slots_n, self.prefill_slots_n = slots, prefill_slots
        self.page_len, self.max_blocks = page_len, max_blocks
        self.chunk, self.dry = chunk, dry
        self.n_dec = n_decode_shards
        self.queue_depth = queue_depth
        self.deadline_steps = deadline_steps
        self.stop, self.stop_seed = stop, stop_seed
        self.eos_prob = eos_prob
        # The migration placement policy, ``placement(blocks,
        # candidates, block_bytes) -> shard`` over the dry-visible
        # candidates; None = free-pages-first (the rule without a
        # topology). Resolved once: it sits on the per-step path.
        if placement is None:
            from tpu_p2p_torch.topo.place import free_pages_first

            placement = free_pages_first
        self.placement = placement
        self.clock = clock
        # Two pools, two identities: a prefill-side exhaustion message
        # must not read like a decode-side one.
        self.pool_p = PagePool(prefill_pages, page_len, 1, name="prefill")
        self.pool_d = PagePool(num_pages, page_len, n_decode_shards,
                               name="decode")
        self.spec_k = int(spec_k)
        self.prefix_index = (PrefixIndex(self.pool_p)
                             if prefix_cache else None)
        self.prefix_hits = 0
        self.prefix_pages_shared = 0
        self.prefix_tokens_saved = 0
        self.cow_forks = 0
        self.decode_steps = 0
        self.decode_tokens = 0
        self.spec_steps = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.reuse_events: List[Dict] = []
        self.queue: deque = deque()
        self.mq: deque = deque()      # migration queue (FIFO)
        self.slots_p: List[Optional[_Slot]] = [None] * prefill_slots
        self.slots_d: List[Optional[_Slot]] = [None] * slots
        self.tables_p = np.zeros((prefill_slots, max_blocks), np.int32)
        self.tables_d = np.zeros((slots, max_blocks), np.int32)
        self.step_idx = 0
        self.idle_steps = 0
        self.finished: List[Request] = []
        self.shed: List[Request] = []
        self.preempt_events: List[Dict] = []
        self.migrate_events: List[Dict] = []
        self.events: List[Dict] = []
        self.kv_migrate_bytes = 0
        self.migrate_wall_s = 0.0
        self.migrator = None
        self.pre_pools = self.dec_pools = None
        self._step_p = self._step_d = None
        self.n_pre = int(prefill_tp)
        if dry:
            self._dry_block_bytes = (kv_page_bytes(cfg, page_len)
                                     if cfg is not None else 0)
            return
        if mig is None or mig.size != self.n_pre + n_decode_shards:
            raise ValueError(
                f"a mig mesh of {self.n_pre} prefill + {n_decode_shards} "
                "decode ranks is needed")
        if num_pages % n_decode_shards:
            raise ValueError(
                f"num_pages ({num_pages}) must divide by the decode "
                f"replica count ({n_decode_shards})")
        pre_mesh, dec_mesh = _split_mig(mig, self.n_pre)
        geo = dict(page_len=page_len, max_blocks=max_blocks, chunk=chunk)
        self._step_p = make_paged_lm_step(pre_mesh, cfg, **geo)
        self._step_d = make_paged_lm_step(dec_mesh, cfg, **geo)
        self._params_p = place_local_params(params, pre_mesh, cfg)
        self._params_d = place_local_params(params, dec_mesh, cfg)
        self.pre_pools = init_pool_shards(cfg, prefill_pages, page_len,
                                          pre_mesh)
        self.dec_pools = init_pool_shards(cfg, num_pages, page_len,
                                          dec_mesh)
        if mig.streams[0] is not None:
            # Pools and params were made on the caller's stream.
            for i, s in enumerate(mig.streams):
                s.wait_stream(torch.cuda.current_stream(mig.devices[i]))
        self.migrator = KvMigrator(mig, cfg, page_len=page_len,
                                   transport=transport,
                                   chunks=migrate_chunks,
                                   n_prefill=self.n_pre)

    # ------------------------------------------------------ scheduling

    def _block_bytes(self, blocks: int) -> int:
        if self.migrator is not None:
            return self.migrator.block_bytes(blocks)
        return self._dry_block_bytes * int(blocks)

    def _shard_of_d(self, slot: int) -> int:
        return slot // (self.slots_n // self.n_dec)

    def _shed(self, req: Request, outcome: str) -> None:
        req.outcome = outcome
        req.shed_step = self.step_idx
        self.shed.append(req)

    def submit(self, req: Request) -> bool:
        """The colocated admission contract: a bounded queue sheds the
        newcomer, deadlines count from enqueue."""
        req.enqueue_step = self.step_idx
        req.t_enqueue = self.clock()
        if self.deadline_steps and req.deadline_step is None:
            req.deadline_step = self.step_idx + self.deadline_steps
        if self.queue_depth and len(self.queue) >= self.queue_depth:
            self._shed(req, OUTCOME_SHED_ADMISSION)
            return False
        self.queue.append(req)
        return True

    def idle(self) -> bool:
        return (not self.queue and not self.mq
                and all(s is None for s in self.slots_p)
                and all(s is None for s in self.slots_d))

    def _shed_expired(self) -> None:
        """Deadline pass over the admission queue only: requests in the
        migration queue or either bank are in flight (zero-loss)."""
        if not self.deadline_steps:
            return
        kept: deque = deque()
        for r in self.queue:
            if (r.deadline_step is not None
                    and r.prefill_start_step is None
                    and self.step_idx > r.deadline_step):
                self._shed(r, OUTCOME_SHED_DEADLINE)
            else:
                kept.append(r)
        self.queue = kept

    def _admit(self) -> None:
        self._shed_expired()
        for i in range(self.prefill_slots_n):
            if not self.queue:
                return
            if self.slots_p[i] is not None:
                continue
            req = self.queue[0]
            blocks = req.blocks_needed(self.page_len)
            if blocks > self.max_blocks:
                raise ValueError(
                    f"request {req.rid}: {blocks} blocks exceed the "
                    f"step's max_blocks={self.max_blocks} window"
                )
            if blocks > self.pool_d.capacity:
                raise ValueError(
                    f"request {req.rid}: needs {blocks} pages but a "
                    f"decode shard owns only {self.pool_d.capacity} "
                    "— it could never finish decoding"
                )
            prefill_len = req.n_prompt + len(req.generated)
            blocks0 = max(1, -(-prefill_len // self.page_len))
            if blocks0 > self.pool_p.capacity:
                raise ValueError(
                    f"request {req.rid}: prefill needs {blocks0} "
                    f"pages but the prefill pool owns only "
                    f"{self.pool_p.capacity} — it could never prefill"
                )
            L = self.page_len
            shared: List[int] = []
            resume = 0
            if self.prefix_index is not None:
                # The colocated resume rule: the cached chain's end,
                # rounded down to the chunk grid, capped so the last
                # chunk replays (its logits emit the first token).
                matched = self.prefix_index.lookup(req.prompt, 0)
                resume = min(len(matched) * L,
                             (prefill_len - 1) // self.chunk * self.chunk)
                shared = matched[:-(-resume // L)] if resume else []
            try:
                fresh = self._alloc_evict_p(blocks0 - len(shared))
            except OutOfPages:
                # Prefill pool full (active prefills + migration-queue
                # holds): admission stalls until a migration drains.
                return
            if shared:
                self.pool_p.retain(shared, 0)
            pages = shared + fresh
            self.queue.popleft()
            req.pool = self.pool_p.name
            slot = _Slot(req, pages, prefill_len)
            slot.pos = resume
            self.slots_p[i] = slot
            row = np.full(self.max_blocks, TRASH_PAGE, np.int32)
            row[:blocks0] = pages
            self.tables_p[i] = row
            if resume:
                self.prefix_hits += 1
                self.prefix_pages_shared += len(shared)
                self.prefix_tokens_saved += resume
                req.prefix_pages += len(shared)
                req.prefix_tokens += resume
                self.reuse_events.append({
                    "kind": "prefix_hit", "rid": req.rid,
                    "step": self.step_idx, "pages": len(shared),
                    "tokens": resume,
                })

    def _alloc_evict_p(self, n: int) -> List[int]:
        """Prefill-pool ``alloc_n`` with prefix-index relief: evict index
        references newest-first until the allocation fits or the index
        drains."""
        while True:
            try:
                return self.pool_p.alloc_n(n, 0)
            except OutOfPages:
                if (self.prefix_index is None
                        or not self.prefix_index.evict_one(0)):
                    raise

    def _next_tokens_p(self, s: _Slot) -> int:
        return min(self.chunk, s.prefill_len - s.pos)

    def _next_tokens_d(self, s: _Slot) -> int:
        if not self.spec_k:
            return 1
        # The colocated speculative window: committed token plus up to
        # spec_k drafts, clipped to the chunk, the 8-row band and the
        # remaining token budget.
        remaining = s.req.max_new - len(s.req.generated)
        return 1 + max(0, min(self.spec_k, self.chunk - 1,
                              8 - s.pos % 8 - 1, remaining - 1))

    def _draft(self, s: _Slot, k: int) -> List[int]:
        return ngram_propose(s.req.full_tokens(), k)

    def _fork_page_p(self, i: int, s: _Slot, blk: int) -> None:
        """COW fork on the prefill bank: a private page, the device copy,
        the table swap, the reference on the shared original dropped.
        Prefill slots never grow, so exhaustion here is a sizing error
        worth the loud OutOfPages."""
        new = self._alloc_evict_p(1)[0]
        old = s.pages[blk]
        for i, pool in enumerate(self.pre_pools or ()):
            with self.mig.on(i):
                page_copy(pool, old, new)
        s.pages[blk] = new
        self.tables_p[i, blk] = new
        self.pool_p.free([old], 0)
        self.cow_forks += 1

    def _cow_writes_p(self) -> None:
        """Fork-before-write over the prefill bank: a prefix-hit slot's
        first recomputed chunk may land in a shared partial-tail page."""
        if self.prefix_index is None:
            return
        for i in range(self.prefill_slots_n):
            s = self.slots_p[i]
            if s is None or self._next_tokens_p(s) <= 0:
                continue
            blk = s.pos // self.page_len
            if (blk < len(s.pages)
                    and self.pool_p.ref(s.pages[blk], 0) > 1):
                self._fork_page_p(i, s, blk)

    def _register_prefix_p(self, s: _Slot) -> None:
        """Offer a completed prefill's full prompt pages to the index,
        before the resident set enters the migration queue, so the
        index's reference outlives the post-migration free."""
        full = s.req.n_prompt // self.page_len
        if full:
            self.prefix_index.register(s.req.prompt, s.pages[:full], 0)

    def _preempt_decode(self, i: int) -> None:
        """Evict decode slot ``i`` and re-enqueue its request at the
        PREFILL queue head: its generated ids ride as prompt extension,
        so it recomputes on the prefill side and loses no token."""
        s = self.slots_d[i]
        req = s.req
        self.pool_d.free(s.pages, self._shard_of_d(i))
        self.tables_d[i] = TRASH_PAGE
        self.slots_d[i] = None
        req.preemptions += 1
        req.preempt_steps.append(self.step_idx)
        if req.pending_preempt_step is None:
            req.pending_preempt_step = self.step_idx
        self.preempt_events.append({
            "rid": req.rid, "step": self.step_idx,
            "generated": len(req.generated), "side": "decode",
        })
        req.pool = self.pool_p.name
        self.queue.appendleft(req)

    def _grow_decode(self) -> None:
        """Lazy decode-side page growth, preempting on exhaustion (the
        victim re-enters prefill)."""
        for i in range(self.slots_n):
            s = self.slots_d[i]
            if s is None:
                continue
            need = s.pos // self.page_len + 1
            shard = self._shard_of_d(i)
            while self.slots_d[i] is s and len(s.pages) < need:
                try:
                    pid = self.pool_d.alloc(shard)
                except OutOfPages:
                    victim = choose_victim(self.slots_d, shard,
                                           self._shard_of_d)
                    if victim is None:  # unreachable: slot i occupies
                        raise
                    self._preempt_decode(victim)
                    continue
                s.pages.append(pid)
                self.tables_d[i, len(s.pages) - 1] = pid

    def _stop_after(self, req: Request) -> bool:
        k = len(req.generated)
        if k >= req.max_new:
            return True
        return (self.stop == "eos"
                and eos_stop(self.stop_seed, req.rid, k, self.eos_prob))

    def _choose_decode_shard(self, blocks: int) -> Optional[int]:
        """The eligible shards (a free slot AND ``blocks`` free pages),
        placed by the placement policy: free-pages-first (most free
        pages, ties to the lowest shard) when none was injected, the
        predicted-ship-time policy
        (:func:`tpu_p2p_torch.topo.place.topo_migration_placement`) when
        one was. Policies see only ``(shard, free_pages)`` pairs and the
        migration's bytes, so dry == real holds under any policy."""
        per = self.slots_n // self.n_dec
        cands = []
        for shard in range(self.n_dec):
            if all(self.slots_d[i] is not None
                   for i in range(shard * per, (shard + 1) * per)):
                continue
            free = self.pool_d.available(shard)
            if free < blocks:
                continue
            cands.append((shard, free))
        if not cands:
            return None
        return int(self.placement(blocks, cands,
                                  self._block_bytes(blocks)))

    def _finish(self, req: Request, now: float) -> None:
        req.t_finish = now
        req.finish_step = self.step_idx
        req.outcome = OUTCOME_COMPLETED
        self.finished.append(req)

    def _drain_migrations(self) -> List[Dict]:
        """FIFO drain of completed prefills into decode slots; → this
        step's migration events. The first entry that cannot place
        blocks the rest."""
        performed = []
        while self.mq:
            entry = self.mq[0]
            req, pages = entry["req"], entry["pages"]
            blocks = len(pages)
            shard = self._choose_decode_shard(blocks)
            if shard is None:
                break
            self.mq.popleft()
            slot_i = next(i for i in range(self.slots_n)
                          if self.slots_d[i] is None
                          and self._shard_of_d(i) == shard)
            dec_pages = self.pool_d.alloc_n(blocks, shard)
            if not self.dry:
                t0 = self.clock()
                self.migrator.migrate(self.pre_pools, pages,
                                      self.dec_pools, dec_pages, shard)
                self.migrate_wall_s += self.clock() - t0
            self.pool_p.free(pages, 0)
            s = _Slot(req, dec_pages, entry["prefill_len"])
            s.pos = entry["prefill_len"]
            s.phase = "decode"
            self.slots_d[slot_i] = s
            row = np.full(self.max_blocks, TRASH_PAGE, np.int32)
            row[:blocks] = dec_pages
            self.tables_d[slot_i] = row
            wait = self.step_idx - entry["done_step"]
            req.pool = self.pool_d.name
            req.migrate_step = self.step_idx
            req.migrate_wait_steps = max(req.migrate_wait_steps or 0, wait)
            req.decode_shard = shard
            req.migrated_blocks += blocks
            req.migrations += 1
            self.kv_migrate_bytes += self._block_bytes(blocks)
            ev = {"rid": req.rid, "step": self.step_idx,
                  "blocks": blocks, "dst_shard": shard,
                  "wait_steps": wait}
            self.migrate_events.append(ev)
            performed.append(ev)
        return performed

    # ------------------------------------------------------- stepping

    def _host(self, rank: int, logits) -> np.ndarray:
        with self.mig.on(rank):
            return logits.cpu().numpy()

    def _run_steps(self, tok_p, pos_p, act_p, tok_d, pos_d, act_d):
        """Both sides' mixed steps, every rank's issued before any
        result is read back; → host logits of each bank (None where the
        bank was idle). The prefill side's tp ranks run at once (a
        thread each); a decode shard with no active row runs nothing."""
        logits_p = None
        pre = []
        if int(act_p.sum()):
            n = self.n_pre
            _, pre = self._step_p(self._params_p, self.pre_pools,
                                  [tok_p] * n, [pos_p] * n, [act_p] * n,
                                  [self.tables_p] * n, sync=False)
        per = self.slots_n // self.n_dec
        rows = [slice(d * per, (d + 1) * per) for d in range(self.n_dec)]
        active = [d for d in range(self.n_dec) if int(act_d[rows[d]].sum())]
        _, dec = self._step_d(
            self._params_d, self.dec_pools, [tok_d[r] for r in rows],
            [pos_d[r] for r in rows], [act_d[r] for r in rows],
            [self.tables_d[r] for r in rows],
            ranks=self._step_d.ranks_for(active), sync=False)
        if pre:
            logits_p = self._host(0, pre[0])
        logits_d = None
        if active:
            logits_d = np.zeros((self.slots_n, self.chunk, self.cfg.vocab),
                                np.float32)
            for d in active:
                logits_d[rows[d]] = self._host(self.n_pre + d, dec[d])
        return logits_p, logits_d

    def step(self) -> List[Request]:
        """One engine step over both sides; → requests finished this
        step."""
        self._admit()
        self._grow_decode()
        self._cow_writes_p()
        tok_p, pos_p, act_p = build_slot_inputs(
            self.slots_p, self.chunk, self._next_tokens_p)
        tok_d, pos_d, act_d = build_slot_inputs(
            self.slots_d, self.chunk, self._next_tokens_d, self._draft)
        busy_p, busy_d = int(act_p.sum()), int(act_d.sum())
        if not busy_p and not busy_d and not self.mq:
            self.idle_steps += 1
            self.step_idx += 1
            return []
        now = self.clock()
        for s in self.slots_p:
            if s is not None and s.req.t_prefill_start is None:
                s.req.t_prefill_start = now
                s.req.prefill_start_step = self.step_idx
        logits_p = logits_d = None
        if not self.dry:
            logits_p, logits_d = self._run_steps(tok_p, pos_p, act_p,
                                                 tok_d, pos_d, act_d)
        done: List[Request] = []
        now = self.clock()
        # Prefill bank: a completing slot emits its FIRST token off the
        # last chunk's logits, then queues for migration (its pages stay
        # in the prefill pool until the move).
        for i, s in enumerate(self.slots_p):
            if s is None:
                continue
            req, n = s.req, int(act_p[i])
            s.pos += n
            if s.pos < s.prefill_len:
                continue
            tok = (int(np.argmax(logits_p[i, n - 1]))
                   if logits_p is not None else 0)
            if not req.generated:
                req.t_first_token = now
                req.first_token_step = self.step_idx
            req.generated.append(tok)
            if req.pending_preempt_step is not None:
                req.preempt_recover_steps.append(
                    self.step_idx - req.pending_preempt_step)
                req.pending_preempt_step = None
            req.prefill_done_step = self.step_idx
            self.slots_p[i] = None
            self.tables_p[i] = TRASH_PAGE
            if self.prefix_index is not None:
                self._register_prefix_p(s)
            if self._stop_after(req):
                # Finished at its first token: nothing to migrate.
                self.pool_p.free(s.pages, 0)
                self._finish(req, now)
                done.append(req)
            else:
                self.mq.append({"req": req, "pages": s.pages,
                                "prefill_len": s.prefill_len,
                                "done_step": self.step_idx})
        # Decode bank: the committed token plus any accepted drafts.
        for i, s in enumerate(self.slots_d):
            if s is None or not int(act_d[i]):
                continue
            req, n = s.req, int(act_d[i])
            drafts = tok_d[i, 1:n].tolist()
            if logits_d is None:
                toks: List[int] = [0]
            else:
                greedy = np.argmax(logits_d[i, :n], axis=-1)
                toks = spec_verify(greedy, drafts)
            req.decode_steps += 1
            self.decode_steps += 1
            if drafts:
                acc = len(toks) - 1
                self.spec_steps += 1
                self.spec_drafted += len(drafts)
                self.spec_accepted += acc
                req.spec_drafted += len(drafts)
                req.spec_accepted += acc
                self.reuse_events.append({
                    "kind": ("spec_accept" if acc else "spec_reject"),
                    "rid": req.rid, "step": self.step_idx,
                    "drafted": len(drafts), "accepted": acc,
                })
            s.pos += len(toks)
            for tok in toks:
                req.generated.append(tok)
                self.decode_tokens += 1
                if req.pending_preempt_step is not None:
                    req.preempt_recover_steps.append(
                        self.step_idx - req.pending_preempt_step)
                    req.pending_preempt_step = None
                if self._stop_after(req):
                    self.pool_d.free(s.pages, self._shard_of_d(i))
                    self.tables_d[i] = TRASH_PAGE
                    self.slots_d[i] = None
                    self._finish(req, now)
                    done.append(req)
                    break
        migrations = self._drain_migrations()
        self.events.append({
            "step": self.step_idx,
            "p_pos": pos_p, "p_n": act_p, "p_tables": self.tables_p.copy(),
            "d_pos": pos_d, "d_n": act_d, "d_tables": self.tables_d.copy(),
            "migrations": migrations,
        })
        self.step_idx += 1
        return done

    def run(self, trace: List[Request]) -> List[Request]:
        """Drive a step-indexed trace to completion; → finished requests
        in finish order (shed requests land in ``.shed``)."""
        pending = deque(sorted(trace, key=lambda r: (r.arrival_step,
                                                     r.rid)))
        while pending or not self.idle():
            while pending and pending[0].arrival_step <= self.step_idx:
                self.submit(pending.popleft())
            self.step()
        return self.finished


def simulate_disagg_schedule(trace: List[Request], *, slots: int,
                             prefill_slots: int, page_len: int,
                             num_pages: int, prefill_pages: int,
                             max_blocks: int, chunk: int,
                             n_decode_shards: int, queue_depth: int = 0,
                             deadline_steps: int = 0, stop: str = "length",
                             stop_seed: int = 0, eos_prob: float = 0.0,
                             prefix_cache: bool = False, cfg=None,
                             placement: Optional[Callable] = None) -> Dict:
    """Run the disagg scheduler without a device: → the exact two-sided
    event trace the engine executes — per-step inputs of both banks,
    every migration (rid / blocks / destination shard / wait),
    preemptions, sheds. No ``spec_k``: speculative acceptance depends on
    token values. ``kv_migrate_bytes`` needs ``cfg`` (None without).
    ``placement`` injects a migration placement policy (None =
    free-pages-first)."""
    trace = [r.fresh() for r in trace]
    b = DisaggBatcher(
        None, cfg, None, slots=slots, prefill_slots=prefill_slots,
        page_len=page_len, num_pages=num_pages,
        prefill_pages=prefill_pages, max_blocks=max_blocks, chunk=chunk,
        dry=True, n_decode_shards=n_decode_shards,
        queue_depth=queue_depth, deadline_steps=deadline_steps, stop=stop,
        stop_seed=stop_seed, eos_prob=eos_prob, prefix_cache=prefix_cache,
        placement=placement)
    finished = b.run(trace)
    return {
        "steps": b.step_idx,
        "prefix_hits": b.prefix_hits,
        "prefix_tokens_saved": b.prefix_tokens_saved,
        "busy_steps": len(b.events),
        "idle_steps": b.idle_steps,
        "events": b.events,
        "requests": finished,
        "shed": b.shed,
        "preempt_events": b.preempt_events,
        "migrate_events": b.migrate_events,
        "migrations": len(b.migrate_events),
        "kv_migrate_bytes": (b.kv_migrate_bytes
                             if cfg is not None else None),
    }


def run_disagg_engine(mig: LocalMesh, cfg, params, trace: List[Request], *,
                      sc, emit=None, ledger=None, placement=None,
                      clock=time.monotonic) -> dict:
    """Serve ``trace`` to completion on the disaggregated ranks of
    ``mig`` (the first ``sc.prefill_tp`` ranks, or 1 where it is 0, the
    tensor-parallel prefill; the rest decode replicas); ``params`` on
    any device are placed on each rank (its shard). → the
    colocated engine's summary schema plus ``kv_migrated`` /
    ``kv_migrate_blocks`` / ``kv_migrate_bytes`` /
    ``serve_kv_migrate_gbps`` (shipped bits over migration wall) /
    ``migrate_wait_steps_{p50,max}``, and the ``batcher``.
    ``placement`` as :func:`simulate_disagg_schedule` takes it."""
    from tpu_p2p_torch.serve.engine import _r3, _request_record

    trace = [r.fresh() for r in trace]
    batcher = DisaggBatcher(
        mig, cfg, params, slots=sc.slots, prefill_slots=sc.prefill_slots,
        page_len=sc.page_len, num_pages=sc.num_pages,
        prefill_pages=sc.prefill_pages, max_blocks=sc.max_blocks,
        chunk=sc.chunk, queue_depth=sc.queue_depth,
        deadline_steps=sc.deadline_steps, stop=sc.stop, stop_seed=sc.seed,
        eos_prob=sc.eos_prob, prefix_cache=sc.prefix_cache,
        spec_k=sc.spec_k, transport=sc.transport,
        migrate_chunks=sc.migrate_chunks, prefill_tp=sc.prefill_tp or 1,
        placement=placement, clock=clock)
    t0 = clock()
    from tpu_p2p_torch.serve.engine import _recording

    with _recording(ledger):  # the steps and the migration ships
        finished = batcher.run(trace)
    mig.synchronize()
    wall = max(clock() - t0, 1e-9)
    prompt_toks = sum(r.n_prompt for r in finished)
    gen_toks = sum(len(r.generated) for r in finished)
    ttft = [(r.t_first_token - r.t_enqueue) * 1e3 for r in finished
            if r.t_first_token is not None]
    tok_ms = [(r.t_finish - r.t_first_token) * 1e3 / (len(r.generated) - 1)
              for r in finished
              if len(r.generated) > 1 and r.t_finish is not None]
    shed = batcher.shed
    waits = [r.migrate_wait_steps for r in finished
             if r.migrate_wait_steps is not None]
    mig_gbps = (batcher.kv_migrate_bytes * 8 / batcher.migrate_wall_s / 1e9
                if batcher.migrate_wall_s > 0 else None)
    summary = {
        "mode": "disagg",
        "requests": len(finished),
        "steps": batcher.step_idx,
        "idle_steps": batcher.idle_steps,
        "prompt_tokens": prompt_toks,
        "gen_tokens": gen_toks,
        "wall_s": round(wall, 6),
        "serve_tokens_per_s": round((prompt_toks + gen_toks) / wall, 3),
        "gen_tokens_per_s": round(gen_toks / wall, 3),
        "serve_ttft_ms_p50": _r3(percentile(ttft, 0.50)),
        "serve_ttft_ms_p99": _r3(percentile(ttft, 0.99)),
        "serve_tok_ms_p50": _r3(percentile(tok_ms, 0.50)),
        "serve_tok_ms_p99": _r3(percentile(tok_ms, 0.99)),
        "shed": len(shed),
        "shed_frac": round(len(shed) / max(len(trace), 1), 4),
        "preemptions": len(batcher.preempt_events),
        "preempt_recover_steps": preempt_recover_steps(finished),
        "kv_migrated": len(batcher.migrate_events),
        "kv_migrate_blocks": sum(e["blocks"]
                                 for e in batcher.migrate_events),
        "kv_migrate_bytes": batcher.kv_migrate_bytes,
        "serve_kv_migrate_gbps": (round(mig_gbps, 6)
                                  if mig_gbps is not None else None),
        "migrate_wait_steps_p50": percentile(waits, 0.50),
        "migrate_wait_steps_max": (max(waits) if waits else None),
    }
    if sc.prefix_cache or sc.spec_k:
        tok_bytes = kv_page_bytes(cfg, sc.page_len) // sc.page_len
        ttft_steps = [r.first_token_step - r.enqueue_step for r in finished
                      if r.first_token_step is not None]
        summary.update({
            "prefix_hits": batcher.prefix_hits,
            "prefix_pages_shared": batcher.prefix_pages_shared,
            "prefix_tokens_saved": batcher.prefix_tokens_saved,
            "prefix_saved_bytes": batcher.prefix_tokens_saved * tok_bytes,
            "cow_forks": batcher.cow_forks,
            "spec_decode_steps": batcher.decode_steps,
            "spec_decode_tokens": batcher.decode_tokens,
            "serve_spec_accept_rate": _r3(
                batcher.decode_tokens / batcher.decode_steps
                if batcher.decode_steps else None),
            "spec_draft_accept_frac": _r3(
                batcher.spec_accepted / batcher.spec_drafted
                if batcher.spec_drafted else None),
            "serve_ttft_steps_mean": _r3(
                float(np.mean(ttft_steps)) if ttft_steps else None),
        })
    if emit is not None:
        for r in finished:
            emit(_request_record(r))
        for r in shed:
            emit(_request_record(r))
        for ev in batcher.reuse_events:
            emit({"obs": "serve_reuse", **ev})
        emit({"obs": "serve_summary", **summary})
        if ledger is not None:
            emit(_obs.totals_record(ledger))
    return {**summary, "finished": finished, "shed_requests": shed,
            "events": batcher.events,
            "migrate_events": batcher.migrate_events, "batcher": batcher}
