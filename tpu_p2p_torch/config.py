"""Configuration — the port's copy of ``tpu_p2p/config.py``.

Two halves. The benchmark half: the size, sweep and range parsers, the
pattern/mode/isolation/direction/transport names and
:class:`BenchConfig`, whose defaults are the reference program's
constants (32 MiB, 128 iterations, int8; ``p2p_matrix.cc:124,132,158``).
The serve half: the batching modes, the stop rules and
:class:`ServeConfig`; the disaggregated prefill/decode fields of the
reference config are not ported yet and are left out (the CLI rejects
``--disagg``).

Transports keep the reference's names, so scripts and goldens carry
over. In the port ``xla`` means "the library collective":
``torch.distributed`` send/recv, over NCCL on ranks that each have a
card of their own and over gloo on the CPU. ``pallas_dma`` is the
hand-written CUDA peer-push kernel over CUDA IPC windows
(:mod:`tpu_p2p_torch.parallel.pallas_dma`), whose plain version runs
over gloo on the CPU.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, fields
from typing import Optional, Tuple

# Reference constants (the defaults contract):
REF_MSG_SIZE = 32 * 1024 * 1024  # p2p_matrix.cc:124
REF_ITERS = 128  # p2p_matrix.cc:132
REF_DTYPE = "int8"  # p2p_matrix.cc:158 (ncclInt8)

_SIZE_RE = re.compile(r"^\s*([0-9]*\.?[0-9]+)\s*([KMGT]i?)?B?\s*$",
                      re.IGNORECASE)
_UNIT = {
    None: 1,
    "K": 10**3, "M": 10**6, "G": 10**9, "T": 10**12,
    "KI": 2**10, "MI": 2**20, "GI": 2**30, "TI": 2**40,
}


def parse_size(text) -> int:
    """Parse ``'32MiB'``, ``'4KB'``, ``'1G'``, ``'8'`` → bytes."""
    if isinstance(text, int):
        return text
    m = _SIZE_RE.match(str(text))
    if not m:
        raise ValueError(f"unparseable size {text!r}")
    num, unit = m.groups()
    mult = _UNIT[unit.upper() if unit else None]
    return int(float(num) * mult)


def format_size(nbytes: int) -> str:
    for unit, mult in (("GiB", 2**30), ("MiB", 2**20), ("KiB", 2**10)):
        if nbytes % mult == 0 and nbytes >= mult:
            return f"{nbytes // mult}{unit}"
    return f"{nbytes}B"


def parse_edge(text: str) -> Tuple[int, int]:
    """Parse ``'0:1'`` → the directed edge ``(0, 1)``."""
    parts = str(text).split(":")
    try:
        src, dst = (int(p) for p in parts)
        if src < 0 or dst < 0:
            raise ValueError("negative device index")
    except ValueError:
        raise ValueError(
            f"unparseable edge {text!r}; expected SRC:DST with "
            "non-negative device indices, e.g. 0:1"
        ) from None
    return src, dst


def parse_sweep(text: str) -> Tuple[int, ...]:
    """``'1KiB:1GiB'`` → powers-of-two sweep; ``'4KB,32MiB'`` → list."""
    if ":" in text:
        lo_s, hi_s = text.split(":", 1)
        lo, hi = parse_size(lo_s), parse_size(hi_s)
        sizes = []
        s = lo
        while s <= hi:
            sizes.append(s)
            s *= 2
        return tuple(sizes)
    return tuple(parse_size(p) for p in text.split(","))


PATTERNS = (
    "pairwise",      # all-pairs matrix — the reference program itself
    "loopback",      # self-edge / same-host copy (BASELINE configs[0])
    "ring",          # shift-by-1 ppermute (configs[2])
    "all_to_all",    # configs[3]
    "torus2d",       # both mesh axes (configs[4])
    "latency",       # 8B p50 send/recv latency (BASELINE metric)
    "allreduce",     # psum busbw — the DP gradient transport
    "reduce_scatter",  # psum_scatter busbw — the ZeRO gradient transport
    "all_gather",    # tiled all_gather busbw — the ZeRO parameter transport
    "ring_attention",  # flagship SP workload over the same transport
    "ulysses_attention",  # all_to_all SP counterpart (configs[3] transport)
    "flagship_step",  # the composite 5-axis train-step benchmark
)
# The reference's whole pattern list; the port's workload registry
# runs every one.

MODES = ("serialized", "fused", "differential", "device")
# serialized = one message in flight, drained each time (the reference's
# loop); fused = ``iters`` dependent hops launched back to back, drained
# once; differential = the slope between two chain lengths, which
# cancels every constant per-call cost; device = that slope read off the
# card's own clock (the kernel spans of a ``torch.profiler`` trace), with
# the host slope beside it as the diagnostic; on the CPU, where no device
# track exists, the host slope, labelled as such.
ISOLATIONS = ("full", "submesh")
# full = every rank of the world takes part in each pair's transfer
# (non-participants with no edge); submesh = only the pair, over a
# process group of its own.
DIRECTIONS = ("uni", "bi", "both")
TRANSPORTS = ("xla", "pallas_dma")
PP_SCHEDULES = ("1f1b", "zb")
TICK_LOWERINGS = ("masked", "switch")
# The programs ``obs trace`` (the tick flight recorder) can record.
TRACE_SCHEDULES = ("zb", "1f1b", "gpipe")


@dataclass
class BenchConfig:
    """Everything a benchmark run needs; defaults = the reference's
    constants."""

    pattern: str = "pairwise"
    # None = unset; bandwidth patterns then use the reference's 32 MiB
    # (via sizes()), while latency/loopback substitute their own metric
    # sizes. An explicit value is always honored verbatim.
    msg_size: Optional[int] = None
    iters: int = REF_ITERS
    warmup: int = 1  # deviation from the reference (0 there)
    dtype: str = REF_DTYPE
    direction: str = "both"  # reference runs uni then bi (p2p_matrix.cc:141,196)
    mode: str = "serialized"  # reference semantics: one message in flight
    isolation: str = "full"
    num_devices: Optional[int] = None
    mesh_shape: Optional[Tuple[int, ...]] = None  # e.g. (4, 2): a 2-D
    # rank mesh over axes ("x", "y") in row-major rank order
    sweep: Optional[Tuple[int, ...]] = None  # message-size sweep
    fused_repeats: int = 3
    timeout_s: Optional[float] = None
    check: bool = False  # verify payload contents after transfer
    jsonl: Optional[str] = None  # structured twin of the stdout matrix
    resume: bool = False  # skip cells already present in jsonl
    seed: int = 0  # the SP patterns' QKV draws
    profile_dir: Optional[str] = None  # torch.profiler trace output
    use_flash: bool = False  # the flash kernels on the SP attention
    # patterns (the ring's folds, Ulysses' full-sequence call)
    attn_window: int = 0  # > 0: sliding-window attention on the SP
    # patterns; windowed contiguous rings also drop their dead hops
    # (tpu_p2p_torch.ops.attention.live_ring_hops)
    overlap: str = "none"  # flagship_step: the ZeRO gather schedule
    # ("prefetch" = each block's gather issued one block ahead), as
    # FlagshipConfig.overlap; other patterns ignore it
    zero_dp: bool = False  # flagship_step: ZeRO-3 parameter sharding
    # over the dp axis (FlagshipConfig.zero_dp)
    tp_overlap: str = "none"  # flagship_step: the tp joins ("ring" =
    # ring collective-matmuls over token chunks, each hop in flight
    # beside a chunk's product), as FlagshipConfig.tp_overlap; no-op at
    # tp 1, other patterns ignore it
    ep_overlap: str = "none"  # flagship_step: the MoE reshards ("ring" =
    # shift hops beside the expert products), as
    # FlagshipConfig.ep_overlap; no-op at ep 1
    pp_overlap: str = "none"  # flagship_step: the pipeline's stage hop
    # ("wave" = token-chunk hops, every chunk's in flight before the
    # first wait), as FlagshipConfig.pp_overlap; no-op at pp 1
    pp_schedule: str = "1f1b"  # flagship_step: the pipeline tick
    # schedule ("zb" = the zero-bubble dB/dW split), as
    # FlagshipConfig.pp_schedule; a non-default value routes the step
    # through the tick-IR executor
    tick_lowering: str = "masked"  # flagship_step: the tick lowering
    # ("switch" = per-rank dispatch), as FlagshipConfig.tick_lowering;
    # a non-default value routes the step through the tick-IR executor
    transport: str = "xla"

    def __post_init__(self) -> None:
        if self.pattern not in PATTERNS:
            raise ValueError(f"pattern {self.pattern!r} not in {PATTERNS}")
        if self.mode not in MODES:
            raise ValueError(f"mode {self.mode!r} not in {MODES}")
        if self.isolation not in ISOLATIONS:
            raise ValueError(
                f"isolation {self.isolation!r} not in {ISOLATIONS}")
        if self.direction not in DIRECTIONS:
            raise ValueError(
                f"direction {self.direction!r} not in {DIRECTIONS}")
        if self.iters <= 0:
            raise ValueError("iters must be positive")
        if self.attn_window < 0:
            raise ValueError(
                f"attn_window must be >= 0, got {self.attn_window}"
            )
        if self.overlap not in ("none", "prefetch"):
            raise ValueError(
                f"unknown overlap {self.overlap!r}; expected 'none' "
                "or 'prefetch'"
            )
        if self.tp_overlap not in ("none", "ring"):
            raise ValueError(
                f"unknown tp_overlap {self.tp_overlap!r}; expected "
                "'none' or 'ring'"
            )
        if self.ep_overlap not in ("none", "ring"):
            raise ValueError(
                f"unknown ep_overlap {self.ep_overlap!r}; expected "
                "'none' or 'ring'"
            )
        if self.pp_overlap not in ("none", "wave"):
            raise ValueError(
                f"unknown pp_overlap {self.pp_overlap!r}; expected "
                "'none' or 'wave'"
            )
        if self.pp_schedule not in PP_SCHEDULES:
            raise ValueError(
                f"unknown pp_schedule {self.pp_schedule!r}; expected "
                f"one of {PP_SCHEDULES}"
            )
        if self.tick_lowering not in TICK_LOWERINGS:
            raise ValueError(
                f"unknown tick_lowering {self.tick_lowering!r}; "
                f"expected one of {TICK_LOWERINGS}"
            )
        if self.transport not in TRANSPORTS:
            raise ValueError(
                f"unknown transport {self.transport!r}; expected one "
                f"of {TRANSPORTS}"
            )

    @property
    def window(self) -> Optional[int]:
        """``attn_window`` in the ops' convention (0 → None)."""
        return self.attn_window or None

    def sizes(self) -> Tuple[int, ...]:
        if self.sweep:
            return self.sweep
        return (self.msg_size if self.msg_size is not None
                else REF_MSG_SIZE,)

    def replace(self, **kw) -> "BenchConfig":
        d = {f.name: getattr(self, f.name) for f in fields(self)}
        d.update(kw)
        return BenchConfig(**d)


def parse_range(text: str) -> Tuple[int, int]:
    """Parse ``'4:12'`` → the inclusive integer range ``(4, 12)``."""
    parts = str(text).split(":")
    try:
        lo, hi = (int(p) for p in parts)
        if lo < 1 or hi < lo:
            raise ValueError("empty or non-positive range")
    except ValueError:
        raise ValueError(
            f"unparseable range {text!r}; expected LO:HI with "
            "1 <= LO <= HI, e.g. 4:12"
        ) from None
    return lo, hi


BATCHING = ("continuous", "static", "both")
# continuous = slots refilled from the queue the step a sequence
# finishes; static = the run-to-completion baseline (the batch refills
# only when every slot drained); both = the A/B on one trace.

SERVE_STOPS = ("length", "eos")
# length = generate exactly max_new tokens; eos = a seeded per-token
# stop draw keyed on (seed, request_id, generation index) — value-free,
# so the dry schedule simulator and the device batcher agree exactly.


@dataclass(frozen=True)
class ServeConfig:
    """Everything one serving run needs: the paged-cache geometry, the
    slot batch, and the synthetic trace."""

    slots: int = 8            # fixed-width slot batch
    page_len: int = 8         # tokens per KV page (multiple of 8)
    num_pages: int = 64       # page-pool size, incl. the trash page
    max_blocks: int = 8       # page-table width (attention window in
    # pages: max_blocks * page_len positions)
    chunk: int = 4            # prefill chunk width per step (1/2/4/8)
    batching: str = "continuous"
    requests: int = 8         # synthetic trace length
    seed: int = 0
    rate: float = 1.0         # mean Poisson arrivals per scheduler step
    prompt_len: Tuple[int, int] = (4, 12)   # inclusive
    gen_len: Tuple[int, int] = (4, 8)       # inclusive
    vocab: int = 128
    dtype: str = "float32"
    queue_depth: int = 0      # bounded admission queue (0 = unbounded)
    deadline_steps: int = 0   # admission deadline in steps (0 = none)
    stop: str = "length"      # one of SERVE_STOPS
    eos_prob: float = 0.1     # stop="eos": per-token stop probability
    disagg: bool = False      # disaggregated prefill/decode: prefill on
    # one rank, decode on dp replicas, KV pages migrated between them
    prefill_tp: int = 0       # prefill submesh tp size == its device
    # count; 0 = auto, half the devices (only 1 is ported)
    prefill_slots: int = 4    # prefill-side slot batch
    prefill_pages: int = 0    # prefill-side page pool (one shard); 0 =
    # auto, sized by the CLI to the worst-case resident set
    migrate_chunks: int = 1   # KV-migration ship split into this many
    # chunk hops (chunked_ppermute_compute's wave; 1 = one-shot)
    transport: str = "xla"    # migration ship transport, one of
    # TRANSPORTS (xla = a library copy, pallas_dma = the kernels)
    prefix_cache: bool = False  # copy-on-write prefix page sharing
    spec_k: int = 0           # speculative decoding window (0 = off)

    def __post_init__(self) -> None:
        if self.page_len <= 0 or self.page_len % 8:
            raise ValueError(
                f"page_len must be a positive multiple of 8, got "
                f"{self.page_len}"
            )
        if self.chunk not in (1, 2, 4, 8):
            raise ValueError(
                f"chunk must be one of 1/2/4/8, got {self.chunk}"
            )
        if self.batching not in BATCHING:
            raise ValueError(
                f"unknown batching {self.batching!r}; expected one of "
                f"{BATCHING}"
            )
        for name in ("slots", "num_pages", "max_blocks", "requests",
                     "vocab"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be positive")
        if self.rate <= 0:
            raise ValueError(f"rate must be positive, got {self.rate}")
        if self.stop not in SERVE_STOPS:
            raise ValueError(
                f"unknown stop {self.stop!r}; expected one of "
                f"{SERVE_STOPS}"
            )
        if self.stop == "eos" and not 0.0 < self.eos_prob < 1.0:
            raise ValueError(
                f"stop='eos' needs eos_prob in (0, 1), got "
                f"{self.eos_prob}"
            )
        if self.queue_depth < 0 or self.deadline_steps < 0:
            raise ValueError(
                "queue_depth and deadline_steps must be >= 0 "
                "(0 disables)"
            )
        for name in ("prompt_len", "gen_len"):
            lo, hi = getattr(self, name)
            if lo < 1 or hi < lo:
                raise ValueError(
                    f"{name} must be an inclusive 1 <= LO <= HI "
                    f"range, got {(lo, hi)}"
                )
        window = self.max_blocks * self.page_len
        need = self.prompt_len[1] + self.gen_len[1]
        if need > window:
            raise ValueError(
                f"worst-case request ({need} tokens) overruns the "
                f"max_blocks*page_len window ({window})"
            )
        if self.transport not in TRANSPORTS:
            raise ValueError(
                f"unknown transport {self.transport!r}; expected one "
                f"of {TRANSPORTS}"
            )
        if self.migrate_chunks < 1:
            raise ValueError(
                f"migrate_chunks must be >= 1, got {self.migrate_chunks}"
            )
        if not 0 <= self.spec_k <= 7:
            raise ValueError(
                f"spec_k must be in 0..7 (a decode window of 1 + "
                f"spec_k tokens can never exceed the 8-row write "
                f"band), got {self.spec_k}"
            )
        if self.prefill_tp < 0 or self.prefill_pages < 0:
            raise ValueError(
                "prefill_tp and prefill_pages must be >= 0 (0 = auto)"
            )
        if self.prefill_slots <= 0:
            raise ValueError(
                f"prefill_slots must be positive, got "
                f"{self.prefill_slots}"
            )
