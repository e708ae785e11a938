"""Serving configuration — the port's copy of the serve half of
``tpu_p2p/config.py``.

Only what the serving engine reads: the inclusive range parser behind
``--prompt-len``/``--gen-len``, the batching modes, the stop rules and
:class:`ServeConfig`. The disaggregated prefill/decode fields of the
reference config are not ported yet and are left out (the CLI rejects
``--disagg``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


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
        if not 0 <= self.spec_k <= 7:
            raise ValueError(
                f"spec_k must be in 0..7 (a decode window of 1 + "
                f"spec_k tokens can never exceed the 8-row write "
                f"band), got {self.spec_k}"
            )
