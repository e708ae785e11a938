"""Serving resilience — request outcomes, the preemption victim policy,
the seeded EOS stop and the recovery metric. Port of the host-side
policy half of ``tpu_p2p/serve/resilience.py``; fault injection and the
chaos smoke come with the observability slice.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

OUTCOME_COMPLETED = "completed"
OUTCOME_SHED_ADMISSION = "shed_admission"
OUTCOME_SHED_DEADLINE = "shed_deadline"
SHED_OUTCOMES = (OUTCOME_SHED_ADMISSION, OUTCOME_SHED_DEADLINE)


def choose_victim(slots, shard: int,
                  shard_of: Callable[[int], int]) -> Optional[int]:
    """The preemption victim among ``shard``'s occupied slots: least
    tokens generated, ties toward the larger rid (the younger request
    yields). → slot index, or None when the shard has no occupant."""
    best_key, best_i = None, None
    for i, s in enumerate(slots):
        if s is None or shard_of(i) != shard:
            continue
        key = (len(s.req.generated), -s.req.rid)
        if best_key is None or key < best_key:
            best_key, best_i = key, i
    return best_i


def eos_stop(seed: int, rid: int, k: int, prob: float) -> bool:
    """Does request ``rid`` stop after its ``k``-th generated token?
    Keyed on ``(seed, rid, k)`` only — never on token values — with the
    reference's numpy draw, so the decision is bit-exact with it."""
    return bool(
        np.random.default_rng((int(seed), int(rid), int(k))).random()
        < prob)


def preempt_recover_steps(requests) -> Optional[int]:
    """The worst preemption episode across ``requests``: steps from a
    preemption to the request's next emitted token. None when nothing
    was preempted."""
    spans = [s for r in requests for s in r.preempt_recover_steps]
    return max(spans) if spans else None
