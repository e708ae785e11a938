"""Continuous batcher — slot lifecycle over the mixed step. Port of
``tpu_p2p/serve/batcher.py``.

One fixed-width slot batch and one mixed step
(:func:`tpu_p2p_torch.serve.paged_cache.make_paged_lm_step`): every
step each slot is mid-prefill (its prompt in ``chunk``-token slices),
mid-decode (one token, or a speculative window) or idle. Under
``mode="continuous"`` a finishing slot is refilled the same step;
``mode="static"`` refills only when every slot has drained.

The batcher serves over a serve mesh (:func:`tpu_p2p_torch.serve.
engine.serve_mesh`, a :class:`~tpu_p2p_torch.parallel.runtime.LocalMesh`
over ``dp``, or over ``dp``/``tp``/``ep``), one controller driving
every rank as the disagg engine does. With ``n = pool_shards(mesh)``
(dp×ep) batch shards, shard ``k`` owns pool pages ``num_pages / n``
(its own trash page 0, shard-local tables) and the slot rows
``[k·S/n, (k+1)·S/n)``; the ranks of its tp line run the same rows,
each holding its KV heads of the shard's pages and its shard of the
params (a leaf the mesh does not split: one copy for each distinct
device). Each step splits the host input arrays by rows, one slice a
rank (the reference's ``place_step_inputs``), issues every rank's mixed
step on its own stream (a thread a rank where the step meets at tp or
ep joins) before reading any back, and joins the logits of each
shard's lead rank in shard order; the argmax stays on the host (numpy,
first maximum wins), as in the reference.

**A shard with no active row runs nothing that step** (the reference's
SPMD step runs it and parks its writes on the trash page), unless it
shares a dp coordinate with an active shard: the ep line's all-to-alls
need every member (and ZeRO-stored params need every rank). Such rows'
logits are never read — an occupied slot always has an active row — so
the streams are the same, and the KV-write kernel launches ``stages``
times per running rank, per busy step.

Pages are allocated lazily (admission reserves the prefill's pages,
decode grows the table on demand) and a dry free list preempts the
slot with the least completed work, re-enqueued for
recompute-from-prompt with its generated tokens riding along, so no
completed token is lost. Admission is bounded (``queue_depth``) and
deadlined (``deadline_steps``). Prefix caching maps content-matched
full prompt pages copy-on-write; speculative decoding verifies ngram
drafts in one multi-token step.

Scheduling is length-driven (token values never alter occupancy, page
movement, preemption, shedding or stopping), which is what keeps
:func:`simulate_schedule` exact without a device. Speculation is the
exception — acceptance depends on logits — so a dry batcher refuses
``spec_k > 0``.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from tpu_p2p_torch.config import SERVE_STOPS
from tpu_p2p_torch.models.decode import (
    lead_ranks,
    ngram_propose,
    rank_shard,
    spec_verify,
)
from tpu_p2p_torch.models.flagship import place_local_params
from tpu_p2p_torch.serve.paged_cache import (
    OutOfPages,
    PagePool,
    PrefixIndex,
    TRASH_PAGE,
    init_pool_shards,
    make_page_copy,
    make_paged_lm_step,
    pool_shards,
)
from tpu_p2p_torch.serve.resilience import (
    OUTCOME_COMPLETED,
    OUTCOME_SHED_ADMISSION,
    OUTCOME_SHED_DEADLINE,
    choose_victim,
    eos_stop,
)

BATCHING_MODES = ("continuous", "static")


@dataclasses.dataclass
class Request:
    """One sequence to serve: prompt ids in, up to ``max_new`` greedy
    ids out. ``arrival_step`` indexes the batcher's step counter, so
    traces schedule deterministically; wall times record when lifecycle
    events actually happen."""

    rid: int
    prompt: np.ndarray          # int32 [P], P >= 1
    max_new: int                # >= 1 generated tokens
    arrival_step: int = 0
    enqueue_step: Optional[int] = None
    prefill_start_step: Optional[int] = None
    first_token_step: Optional[int] = None
    finish_step: Optional[int] = None
    t_enqueue: Optional[float] = None
    t_prefill_start: Optional[float] = None
    t_first_token: Optional[float] = None
    t_finish: Optional[float] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    deadline_step: Optional[int] = None
    outcome: Optional[str] = None
    shed_step: Optional[int] = None
    preemptions: int = 0
    preempt_steps: List[int] = dataclasses.field(default_factory=list)
    preempt_recover_steps: List[int] = dataclasses.field(
        default_factory=list)
    pending_preempt_step: Optional[int] = None
    pool: str = "kv"            # the page pool holding the request's KV:
    # "kv" colocated, "prefill" / "decode" under disaggregation
    prefill_done_step: Optional[int] = None
    migrate_step: Optional[int] = None
    migrate_wait_steps: Optional[int] = None  # worst episode
    decode_shard: Optional[int] = None
    migrated_blocks: int = 0
    migrations: int = 0
    prefix_pages: int = 0
    prefix_tokens: int = 0
    spec_drafted: int = 0
    spec_accepted: int = 0
    decode_steps: int = 0

    @property
    def n_prompt(self) -> int:
        return int(len(self.prompt))

    def blocks_needed(self, page_len: int) -> int:
        return -(-(self.n_prompt + self.max_new) // page_len)

    def full_tokens(self) -> np.ndarray:
        """Prompt + already-generated ids — what a preempted request
        prefills from at re-admission."""
        if not self.generated:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.generated, np.int32)])

    def fresh(self) -> "Request":
        """A pristine copy for a new run."""
        return Request(rid=self.rid, prompt=self.prompt,
                       max_new=self.max_new,
                       arrival_step=self.arrival_step)


class _Slot:
    __slots__ = ("req", "pos", "phase", "pages", "prefill_len")

    def __init__(self, req: Request, pages: List[int],
                 prefill_len: int) -> None:
        self.req = req
        self.pos = 0            # tokens already resident in the cache
        self.phase = "prefill"
        self.pages = pages
        self.prefill_len = prefill_len  # where prefill hands to decode


def build_slot_inputs(slots, chunk: int, next_tokens,
                      draft_tokens=None):
    """The mixed step's host inputs off a slot bank: ``(tokens [B,
    chunk], pos [B], n_active [B])`` int32 — prefill rows carry their
    next prompt slice, decode rows their last generated id (plus
    ``draft_tokens(slot, k)`` proposals in a speculative window), idle
    rows zeros."""
    n_slots = len(slots)
    tokens = np.zeros((n_slots, chunk), np.int32)
    pos = np.zeros(n_slots, np.int32)
    n_active = np.zeros(n_slots, np.int32)
    for i, s in enumerate(slots):
        if s is None:
            continue
        pos[i] = s.pos
        n = next_tokens(s)
        if s.phase == "prefill":
            src = s.req.full_tokens()
            tokens[i, :n] = src[s.pos:s.pos + n]
        else:
            tokens[i, 0] = s.req.generated[-1]
            if n > 1:
                tokens[i, 1:n] = draft_tokens(s, n - 1)
        n_active[i] = n
    return tokens, pos, n_active


class Batcher:
    """Slot state + queue over the mixed step. ``dry=True`` builds no
    device state and records the schedule instead (tokens for
    not-yet-generated positions are 0 — scheduling never reads them).

    The device batcher serves over ``mesh`` (module docstring);
    ``n_shards`` defaults to :func:`pool_shards` of it, and a dry
    batcher (``mesh=None``) takes it as given to simulate sharded
    pools. ``pool_clamp`` clamps the usable pages per shard (the
    page-pressure fault) and ``step_hook`` is called once per non-idle
    step with the step index (the slow-step fault rides it); only
    :mod:`tpu_p2p_torch.serve.resilience` should pass either."""

    def __init__(self, mesh, cfg, params, *, slots: int, page_len: int,
                 num_pages: int, max_blocks: int, chunk: int,
                 mode: str = "continuous", dry: bool = False,
                 n_shards: Optional[int] = None, queue_depth: int = 0,
                 deadline_steps: int = 0, stop: str = "length",
                 stop_seed: int = 0, eos_prob: float = 0.0,
                 pool_clamp: Optional[int] = None,
                 step_hook: Optional[Callable[[int], None]] = None,
                 prefix_cache: bool = False, spec_k: int = 0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if mode not in BATCHING_MODES:
            raise ValueError(
                f"unknown batching mode {mode!r}; expected one of "
                f"{BATCHING_MODES}"
            )
        if stop not in SERVE_STOPS:
            raise ValueError(
                f"unknown stop rule {stop!r}; expected one of "
                f"{SERVE_STOPS}"
            )
        if stop == "eos" and not 0.0 < eos_prob < 1.0:
            raise ValueError(
                f"stop='eos' needs eos_prob in (0, 1), got {eos_prob}"
            )
        if queue_depth < 0 or deadline_steps < 0:
            raise ValueError(
                "queue_depth and deadline_steps must be >= 0 "
                "(0 disables)"
            )
        if not 0 <= spec_k <= 7:
            raise ValueError(
                f"spec_k must be in 0..7 (window 1 + spec_k tokens "
                f"fits the 8-row write band), got {spec_k}"
            )
        if spec_k and dry:
            raise ValueError(
                "speculative decoding is VALUE-driven — acceptance "
                "depends on verify-step logits, which a dry batcher "
                "never computes — so dry=True with spec_k > 0 would "
                "record a schedule the device engine does not follow; "
                "refusing"
            )
        if not dry and mesh is None:
            raise ValueError(
                "the device batcher serves over a mesh (serve_mesh); "
                "mesh=None is dry-only"
            )
        if n_shards is None:
            n_shards = pool_shards(mesh) if mesh is not None else 1
        elif not dry and n_shards != pool_shards(mesh):
            raise ValueError(
                f"n_shards={n_shards} on a mesh of {pool_shards(mesh)} "
                "pool shards: the device batcher has one shard a rank"
            )
        if slots % n_shards:
            raise ValueError(
                f"slots ({slots}) must divide by the dp×ep shard "
                f"count ({n_shards})"
            )
        self.mesh, self.cfg, self.params = mesh, cfg, params
        self.slots_n = slots
        self.page_len, self.max_blocks = page_len, max_blocks
        self.chunk, self.mode, self.dry = chunk, mode, dry
        self.n_shards = n_shards
        self.queue_depth = queue_depth
        self.deadline_steps = deadline_steps
        self.stop, self.stop_seed = stop, stop_seed
        self.eos_prob = eos_prob
        self.step_hook = step_hook
        self.clock = clock
        self.pool_alloc = PagePool(num_pages, page_len, n_shards)
        if pool_clamp is not None:
            self.pool_alloc.clamp_capacity(pool_clamp)
        self.spec_k = spec_k
        self.prefix_index = (PrefixIndex(self.pool_alloc)
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
        self.slots: List[Optional[_Slot]] = [None] * slots
        self.tables = np.zeros((slots, max_blocks), np.int32)
        self.step_idx = 0
        self.idle_steps = 0
        self.finished: List[Request] = []
        self.shed: List[Request] = []
        self.preempt_events: List[Dict] = []
        self.schedule: List[Dict[str, np.ndarray]] = [] if dry else None
        self._step, self.pools, self._copy = None, None, None
        self._params: Dict[torch.device, dict] = {}
        self._shards: List[dict] = []
        if dry:
            return
        self._step = make_paged_lm_step(
            mesh, cfg, page_len=page_len, max_blocks=max_blocks,
            chunk=chunk)
        self._shards = place_local_params(params, mesh, cfg)
        for dev, shard in zip(mesh.devices, self._shards):
            # A dp-only mesh's shard is the whole params: one copy a
            # distinct device, shared by its ranks.
            self._params.setdefault(dev, shard)
        self.pools = init_pool_shards(cfg, num_pages, page_len, mesh)
        self._copy = make_page_copy(mesh)
        if mesh.streams[0] is not None:
            # Pools and params were made on the caller's stream.
            for s, dev in zip(mesh.streams, mesh.devices):
                s.wait_stream(torch.cuda.current_stream(dev))

    # ------------------------------------------------------ scheduling

    def _shard_of(self, slot: int) -> int:
        return slot // (self.slots_n // self.n_shards)

    def _shed(self, req: Request, outcome: str) -> None:
        req.outcome = outcome
        req.shed_step = self.step_idx
        self.shed.append(req)

    def submit(self, req: Request) -> bool:
        """Enqueue (→ True) or shed on admission (→ False) when the
        bounded queue is full."""
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
        return not self.queue and all(s is None for s in self.slots)

    def _shed_expired(self) -> None:
        """Shed queued requests whose service never started by their
        deadline (in-flight requests re-enqueued by preemption are
        exempt — shedding them would lose completed tokens)."""
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
        if self.mode == "static" and any(s is not None
                                         for s in self.slots):
            return  # run-to-completion barrier: drain first
        for i in range(self.slots_n):
            if not self.queue:
                return
            if self.slots[i] is not None:
                continue
            req = self.queue[0]
            blocks = req.blocks_needed(self.page_len)
            if blocks > self.max_blocks:
                raise ValueError(
                    f"request {req.rid}: {blocks} blocks exceed the "
                    f"step's max_blocks={self.max_blocks} window"
                )
            if blocks > self.pool_alloc.capacity:
                raise ValueError(
                    f"request {req.rid}: needs {blocks} pages but a "
                    f"shard owns only {self.pool_alloc.capacity} — "
                    "it could never be admitted"
                )
            # Lazy admission: reserve what the prefill writes.
            prefill_len = req.n_prompt + len(req.generated)
            blocks0 = max(1, -(-prefill_len // self.page_len))
            shard = self._shard_of(i)
            L = self.page_len
            shared: List[int] = []
            resume = 0
            if self.prefix_index is not None:
                matched = self.prefix_index.lookup(req.prompt, shard)
                # Resume where the cached chain ends, rounded down to
                # the chunk grid and capped at prefill_len - 1 (the
                # first token comes off the last prefilled row).
                resume = min(len(matched) * L,
                             (prefill_len - 1) // self.chunk
                             * self.chunk)
                shared = matched[:-(-resume // L)] if resume else []
            try:
                fresh = self._alloc_evict(blocks0 - len(shared), shard)
            except OutOfPages:
                continue  # another free slot may sit on a shard with pages
            if shared:
                self.pool_alloc.retain(shared, shard)
            pages = shared + fresh
            self.queue.popleft()
            req.pool = self.pool_alloc.name
            slot = _Slot(req, pages, prefill_len)
            slot.pos = resume
            self.slots[i] = slot
            row = np.full(self.max_blocks, TRASH_PAGE, np.int32)
            row[:blocks0] = pages
            self.tables[i] = row
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

    def _alloc_evict(self, n: int, shard: int) -> List[int]:
        """``alloc_n`` with prefix-index relief: evict index references
        (most recent first) until the allocation fits."""
        while True:
            try:
                return self.pool_alloc.alloc_n(n, shard)
            except OutOfPages:
                if (self.prefix_index is None
                        or not self.prefix_index.evict_one(shard)):
                    raise

    def _next_tokens(self, s: _Slot) -> int:
        if s.phase == "prefill":
            return min(self.chunk, s.prefill_len - s.pos)
        if not self.spec_k:
            return 1
        # Speculative window: the committed token plus up to spec_k
        # drafts, clipped to the chunk, the 8-row band and the tokens
        # the request may still emit.
        remaining = s.req.max_new - len(s.req.generated)
        return 1 + max(0, min(self.spec_k, self.chunk - 1,
                              8 - s.pos % 8 - 1, remaining - 1))

    def _preempt(self, i: int) -> None:
        """Evict slot ``i``: free its pages, clear its table row, and
        re-enqueue its request at the queue head."""
        s = self.slots[i]
        req = s.req
        self.pool_alloc.free(s.pages, self._shard_of(i))
        self.tables[i] = TRASH_PAGE
        self.slots[i] = None
        req.preemptions += 1
        req.preempt_steps.append(self.step_idx)
        if req.pending_preempt_step is None:
            req.pending_preempt_step = self.step_idx
        self.preempt_events.append({
            "rid": req.rid, "step": self.step_idx,
            "generated": len(req.generated),
        })
        self.queue.appendleft(req)

    def _alloc_or_preempt(self, i: int, s: _Slot) -> Optional[int]:
        """One page for slot ``i``'s shard, preempting victims until it
        fits; None when slot ``i`` itself was the victim."""
        shard = self._shard_of(i)
        while self.slots[i] is s:
            try:
                return self._alloc_evict(1, shard)[0]
            except OutOfPages:
                victim = choose_victim(self.slots, shard, self._shard_of)
                if victim is None:  # unreachable: slot i occupies it
                    raise
                self._preempt(victim)
        return None

    def _grow_tables(self) -> None:
        """Before the step, every slot whose next tokens cross into an
        unallocated block allocates it (preempting on exhaustion)."""
        for i in range(self.slots_n):
            s = self.slots[i]
            if s is None:
                continue
            n = self._next_tokens(s)
            if n <= 0:
                continue
            need = (s.pos + n - 1) // self.page_len + 1
            while self.slots[i] is s and len(s.pages) < need:
                pid = self._alloc_or_preempt(i, s)
                if pid is None:
                    break
                s.pages.append(pid)
                self.tables[i, len(s.pages) - 1] = pid

    def _fork_page(self, i: int, s: _Slot, blk: int) -> None:
        """Copy-on-write fork of slot ``i``'s block ``blk``: a private
        page, a device copy of the shared page's bytes, the table entry
        swapped, the slot's reference on the original released."""
        new = self._alloc_or_preempt(i, s)
        if new is None:
            return
        shard = self._shard_of(i)
        old = s.pages[blk]
        if self._copy is not None:
            src = np.full(self.n_shards, TRASH_PAGE, np.int32)
            dst = np.full(self.n_shards, TRASH_PAGE, np.int32)
            src[shard], dst[shard] = old, new
            self.pools = self._copy(self.pools, src, dst)
        s.pages[blk] = new
        self.tables[i, blk] = new
        self.pool_alloc.free([old], shard)
        self.cow_forks += 1

    def _cow_writes(self) -> None:
        """Fork-before-write: a slot whose next write lands in a page
        with other holders gets a private copy first, so no two writers
        ever share a page. A step writes one 8-row band, which never
        crosses a page, so one check per slot suffices."""
        if self.prefix_index is None:
            return
        for i in range(self.slots_n):
            s = self.slots[i]
            if s is None:
                continue
            n = self._next_tokens(s)
            if n <= 0:
                continue
            blk = s.pos // self.page_len
            if (blk < len(s.pages)
                    and self.pool_alloc.ref(
                        s.pages[blk], self._shard_of(i)) > 1):
                self._fork_page(i, s, blk)

    def _register_prefix(self, i: int, s: _Slot) -> None:
        """Offer a completed prefill's full prompt pages to the index,
        at the prefill→decode flip."""
        full = s.req.n_prompt // self.page_len
        if full:
            self.prefix_index.register(
                s.req.prompt, s.pages[:full], self._shard_of(i))

    def _draft(self, s: _Slot, k: int) -> List[int]:
        return ngram_propose(s.req.full_tokens(), k)

    def _stop_after(self, req: Request) -> bool:
        """Finished after the token just appended?"""
        k = len(req.generated)
        if k >= req.max_new:
            return True
        return (self.stop == "eos"
                and eos_stop(self.stop_seed, req.rid, k,
                             self.eos_prob))

    # ------------------------------------------------------- stepping

    def _host(self, i: int, logits) -> np.ndarray:
        """Rank ``i``'s logits on the host (waits for its stream)."""
        with self.mesh.on(i):
            return logits.cpu().numpy()

    def _run_step(self, tokens, pos, n_active) -> np.ndarray:
        """One mixed step over the mesh: the host arrays split by rows,
        one slice a rank (its shard's), every running rank's step issued
        before any result is read back; → the ``[B, C, vocab]`` float32
        logits on the host, joined in shard order from each shard's
        lead rank (an inactive shard's rows zero)."""
        mesh, per = self.mesh, self.slots_n // self.n_shards
        rows = [slice(rank_shard(mesh, i) * per,
                      (rank_shard(mesh, i) + 1) * per)
                for i in range(mesh.size)]
        active = [k for k in range(self.n_shards)
                  if n_active[k * per:(k + 1) * per].any()]
        self.pools, logits = self._step(
            self._shards, self.pools, [tokens[r] for r in rows],
            [pos[r] for r in rows], [n_active[r] for r in rows],
            [self.tables[r] for r in rows],
            ranks=self._step.ranks_for(active), sync=False)
        lead = lead_ranks(mesh)
        if self.n_shards == 1:
            return self._host(lead[0], logits[lead[0]])
        out = np.zeros((self.slots_n, self.chunk, self.cfg.vocab),
                       np.float32)
        for k in active:
            out[k * per:(k + 1) * per] = self._host(lead[k],
                                                    logits[lead[k]])
        return out

    def step(self) -> List[Request]:
        """Admit, grow/preempt, fork, run one mixed step, advance every
        slot; → requests that finished this step."""
        self._admit()
        self._grow_tables()
        self._cow_writes()
        tokens, pos, n_active = build_slot_inputs(
            self.slots, self.chunk, self._next_tokens, self._draft)
        if not int(n_active.sum()):
            # Nothing resident: an idle tick while waiting on arrivals.
            self.idle_steps += 1
            self.step_idx += 1
            return []
        if self.step_hook is not None:
            self.step_hook(self.step_idx)
        now = self.clock()
        for s in self.slots:
            if s is not None and s.phase == "prefill" \
                    and s.req.t_prefill_start is None:
                s.req.t_prefill_start = now
                s.req.prefill_start_step = self.step_idx
        if self.dry:
            self.schedule.append({
                "tokens": tokens, "pos": pos, "n_active": n_active,
                "table": self.tables.copy(),
            })
            logits = None
        else:
            logits = self._run_step(tokens, pos, n_active)
        done: List[Request] = []
        now = self.clock()
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            req, n = s.req, int(n_active[i])
            decoding = s.phase == "decode"
            toks: List[int] = []
            if s.phase == "prefill":
                s.pos += n
                if s.pos >= s.prefill_len:
                    s.phase = "decode"
                    # Last prefilled row's logits emit the first token.
                    toks = [int(np.argmax(logits[i, n - 1]))
                            if logits is not None else 0]
                    if self.prefix_index is not None:
                        self._register_prefix(i, s)
            else:
                # Row 0 scores the committed token; rows 1..n-1 verify
                # the drafts that rode in the token row.
                drafts = tokens[i, 1:n].tolist()
                if logits is None:
                    toks = [0]
                else:
                    greedy = np.argmax(logits[i, :n], axis=-1)
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
                        "kind": ("spec_accept" if acc
                                 else "spec_reject"),
                        "rid": req.rid, "step": self.step_idx,
                        "drafted": len(drafts), "accepted": acc,
                    })
                s.pos += len(toks)
            for tok in toks:
                if not req.generated:
                    req.t_first_token = now
                    req.first_token_step = self.step_idx
                req.generated.append(tok)
                if decoding:
                    self.decode_tokens += 1
                if req.pending_preempt_step is not None:
                    req.preempt_recover_steps.append(
                        self.step_idx - req.pending_preempt_step)
                    req.pending_preempt_step = None
                if self._stop_after(req):
                    req.t_finish = now
                    req.finish_step = self.step_idx
                    req.outcome = OUTCOME_COMPLETED
                    self.pool_alloc.free(s.pages, self._shard_of(i))
                    self.tables[i] = TRASH_PAGE
                    self.slots[i] = None
                    self.finished.append(req)
                    done.append(req)
                    break
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


def simulate_schedule(trace: List[Request], *, slots: int,
                      page_len: int, num_pages: int, max_blocks: int,
                      chunk: int, mode: str = "continuous",
                      n_shards: int = 1, queue_depth: int = 0,
                      deadline_steps: int = 0, stop: str = "length",
                      stop_seed: int = 0, eos_prob: float = 0.0,
                      pool_clamp: Optional[int] = None,
                      prefix_cache: bool = False) -> Dict:
    """Run the scheduler without a device: → the exact per-step input
    sequence the mixed step would see, stacked (``{"steps",
    "idle_steps", "tokens", "stacked": {tokens/pos/n_active/table},
    "requests", "shed", "preempt_events", "preemptions",
    "prefix_hits", "prefix_tokens_saved"}``)."""
    trace = [r.fresh() for r in trace]
    b = Batcher(None, None, None,
                slots=slots, page_len=page_len, num_pages=num_pages,
                max_blocks=max_blocks, chunk=chunk, mode=mode,
                dry=True, n_shards=n_shards, queue_depth=queue_depth,
                deadline_steps=deadline_steps, stop=stop,
                stop_seed=stop_seed, eos_prob=eos_prob,
                pool_clamp=pool_clamp, prefix_cache=prefix_cache)
    finished = b.run(trace)
    sched = b.schedule
    stacked = {
        k: np.stack([st[k] for st in sched])
        for k in ("tokens", "pos", "n_active", "table")
    } if sched else {}
    tokens = sum(r.n_prompt + len(r.generated) for r in finished)
    return {
        "steps": len(sched),
        "idle_steps": b.idle_steps,
        "tokens": tokens,
        "stacked": stacked,
        "requests": finished,
        "shed": b.shed,
        "preempt_events": b.preempt_events,
        "preemptions": len(b.preempt_events),
        "prefix_hits": b.prefix_hits,
        "prefix_tokens_saved": b.prefix_tokens_saved,
    }


def percentile(values, q: float) -> Optional[float]:
    """Nearest-rank percentile (the worst observed sample for small
    n). ``q`` in [0, 1]."""
    vals = sorted(v for v in values if v is not None)
    if not vals:
        return None
    idx = max(0, math.ceil(q * len(vals)) - 1)
    return float(vals[idx])
