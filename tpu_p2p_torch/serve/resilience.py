"""Serving resilience — request outcomes, the preemption victim policy,
the seeded EOS stop, the recovery metric, serve-scoped fault
application and the chaos smoke. Port of ``tpu_p2p/serve/resilience.py``.

- **Serve fault application** (:func:`apply_serve_faults`): the only
  place serve code reads :func:`tpu_p2p_torch.obs.faults.active_plan`.
  It turns an active plan into a page-pool clamp, a request-storm burst
  (:func:`storm_burst`) and a slow-step hook the engine threads into
  the batcher.
- **Chaos smoke** (:func:`run_chaos`, ``python -m tpu_p2p_torch serve
  --chaos``): three injected scenarios on the serve mesh, graded as the
  reference grades them — zero completed-token loss under preemption
  (with sampled non-preempted requests bitwise a dense-cache rollout),
  shed verdicts within a step bound of a storm's onset, and a slow host
  changing the wall time and nothing else.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from tpu_p2p_torch.obs import faults

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


# ------------------------------------------------- fault application


def storm_burst(sc, plan, base_rid: int) -> List:
    """The request-storm fault's burst: ``plan.storm_requests`` requests
    all arriving at ``plan.storm_step``, drawn by the trace's own
    sampler (:func:`tpu_p2p_torch.serve.engine.sample_request`) under a
    burst-scoped seed, rids continuing after the base trace."""
    from tpu_p2p_torch.serve.engine import sample_request

    rng = np.random.default_rng((int(sc.seed), 0x570A))
    return [sample_request(rng, sc, base_rid + i, int(plan.storm_step))
            for i in range(plan.storm_requests)]


def apply_serve_faults(trace: List, sc) -> Tuple[
        List, Optional[int], Optional[Callable[[int], None]]]:
    """The active fault plan (if any) as the engine's three serve-side
    injections: → ``(trace, pool_clamp, step_hook)``. With no plan this
    is one comparison against None."""
    plan = faults.active_plan()
    if plan is None:
        return trace, None, None
    out = list(trace)
    if plan.storm_step is not None and plan.storm_requests:
        base = max((r.rid for r in out), default=-1) + 1
        out = out + storm_burst(sc, plan, base)
    hook = None
    if plan.slow_rank is not None:
        def hook(step: int, _plan=plan) -> None:
            faults.maybe_slow_host(_plan, step)
    return out, plan.page_pool_clamp, hook


# ------------------------------------------------------- chaos smoke

# The graded chaos shape, scaled off the mesh's shard count: two slots a
# shard (so the victim can be a neighbour), a window of 3 blocks a
# worst-case request, and a clamp of 4 usable pages a shard (two
# worst-case slots need 6, one still fits).
CHAOS_SLOTS_PER_SHARD = 2
CHAOS_PAGE_LEN = 8
CHAOS_MAX_BLOCKS = 3
CHAOS_CHUNK = 4
CHAOS_CLAMP_PAGES = 4
CHAOS_REQUESTS_PER_SHARD = 3
CHAOS_RATE = 2.0
CHAOS_PROMPT = (4, 12)
CHAOS_GEN = (4, 8)
CHAOS_VOCAB = 128
CHAOS_STORM_STEP = 4
CHAOS_STORM_PER_SLOT = 3
CHAOS_QUEUE_DEPTH_PER_SHARD = 2
CHAOS_DEADLINE_STEPS = 24
CHAOS_SLOW_MS = 60.0
CHAOS_SLOW_START = 3
CHAOS_PARITY_SAMPLES = 3


def _fmt_ms(v) -> str:
    return f"{v:.1f}ms" if v is not None else "-"


def _chaos_sc(n_shards: int, **kw):
    from tpu_p2p_torch.config import ServeConfig

    slots = CHAOS_SLOTS_PER_SHARD * n_shards
    base = dict(
        slots=slots, page_len=CHAOS_PAGE_LEN,
        num_pages=n_shards * (CHAOS_SLOTS_PER_SHARD * CHAOS_MAX_BLOCKS
                              + 1),
        max_blocks=CHAOS_MAX_BLOCKS, chunk=CHAOS_CHUNK,
        requests=CHAOS_REQUESTS_PER_SHARD * n_shards, seed=0,
        rate=CHAOS_RATE, prompt_len=CHAOS_PROMPT, gen_len=CHAOS_GEN,
        vocab=CHAOS_VOCAB,
    )
    base.update(kw)
    return ServeConfig(**base)


def _dense_rollout(cfg, params, req, device) -> List[int]:
    """The dense-cache greedy continuation of one request on ``device``
    at batch 1: the bitwise parity oracle of a non-preempted stream."""
    from tpu_p2p_torch.models import decode as D

    cfg1 = dataclasses.replace(cfg, batch=1)
    step = D.make_flagship_lm_decode_step(cfg1)
    max_len = req.n_prompt + req.max_new
    max_len += (-max_len) % 8
    cache = D.init_kv_cache(cfg1, max_len=max_len, device=device)
    _, toks = D.generate_tokens(step, params, cache, req.prompt[None],
                                num_tokens=len(req.generated))
    return toks[0, req.n_prompt:].tolist()


def run_chaos(mesh, *, detect_within: int = 6, out=None) -> dict:
    """The injected-fault serve smoke on ``mesh`` (a serve mesh): three
    scenarios, each under one :class:`~tpu_p2p_torch.obs.faults.
    FaultPlan`, graded deterministically:

    1. **preempt_clamp** — the pool clamped to :data:`CHAOS_CLAMP_PAGES`
       a shard forces preemption; graded on preemptions firing, zero
       completed-token loss, nothing shed, and sampled non-preempted
       streams bitwise their dense rollouts. Publishes
       ``serve_preempt_recover_steps``.
    2. **storm_shed** — a request storm against a bounded queue and
       deadlines; graded on the first shed verdict within
       ``detect_within`` steps of the storm and every completion in
       full. Publishes ``serve_shed_frac_overload``.
    3. **slow_step** — :func:`~tpu_p2p_torch.obs.faults.maybe_slow_host`
       through the batcher's step hook; graded on the steps and every
       stream bitwise a fault-free twin's, with the delay visible in
       the per-token p99.

    → the per-scenario details (``preempt_clamp`` with its streams
    and the dense rollouts they were held to), the two gate numbers and
    ``ok``."""
    from tpu_p2p_torch.models.flagship import init_flagship_params
    from tpu_p2p_torch.serve.engine import (
        _engine_model, run_engine, synthetic_trace,
    )
    from tpu_p2p_torch.serve.paged_cache import pool_shards

    log = out if out is not None else sys.stderr
    n = pool_shards(mesh)
    results: dict = {"devices": n, "detect_within": detect_within}
    oks: List[bool] = []

    def streams(s):
        return {r.rid: list(r.generated) for r in s["finished"]}

    # ---- 1) page-pool clamp → preemption, zero token loss, parity.
    sc = _chaos_sc(n)
    cfg = _engine_model(sc)
    params = init_flagship_params(cfg, device=mesh.devices[0])
    trace = synthetic_trace(sc)
    plan = faults.FaultPlan(page_pool_clamp=CHAOS_CLAMP_PAGES)
    with faults.injecting(plan):
        s1 = run_engine(mesh, cfg, params, trace, sc=sc,
                        mode="continuous")
    fin = sorted(s1["finished"], key=lambda r: r.rid)
    token_loss = sum(max(0, r.max_new - len(r.generated)) for r in fin)
    recover = preempt_recover_steps(fin)
    preempted = {r.rid for r in fin if r.preemptions}
    clean = [r for r in fin if not r.preemptions]
    parity_ok, checked, dense = True, 0, {}
    for r in clean[:CHAOS_PARITY_SAMPLES]:
        dense[r.rid] = _dense_rollout(cfg, params, r, mesh.devices[0])
        parity_ok = parity_ok and r.generated == dense[r.rid]
        checked += 1
    ok1 = (s1["preemptions"] > 0 and token_loss == 0
           and len(fin) == len(trace) and s1["shed"] == 0
           and parity_ok and checked > 0)
    results["preempt_clamp"] = {
        "plan": plan.describe(), "preemptions": s1["preemptions"],
        "completed": len(fin), "requests": len(trace),
        "token_loss": token_loss, "preempted_rids": sorted(preempted),
        "recover_steps": recover, "parity_checked": checked,
        "parity_ok": parity_ok, "ok": ok1, "steps": s1["steps"],
        "streams": streams(s1), "dense": dense,
    }
    oks.append(ok1)
    print(f"# chaos preempt_clamp: preemptions={s1['preemptions']} "
          f"completed={len(fin)}/{len(trace)} token_loss={token_loss} "
          f"recover_steps={recover} "
          f"parity={'OK' if parity_ok else 'FAIL'}({checked} checked)",
          file=log, flush=True)

    # ---- 2) request storm → admission/deadline shedding verdicts.
    sc2 = _chaos_sc(n, queue_depth=CHAOS_QUEUE_DEPTH_PER_SHARD * n,
                    deadline_steps=CHAOS_DEADLINE_STEPS)
    trace2 = synthetic_trace(sc2)
    plan = faults.FaultPlan(
        storm_step=CHAOS_STORM_STEP,
        storm_requests=CHAOS_STORM_PER_SLOT * sc2.slots)
    with faults.injecting(plan):
        s2 = run_engine(mesh, cfg, params, trace2, sc=sc2,
                        mode="continuous")
    shed = s2["shed_requests"]
    total2 = len(trace2) + plan.storm_requests
    first_shed = min((r.shed_step for r in shed), default=None)
    lag = (first_shed - CHAOS_STORM_STEP
           if first_shed is not None else None)
    short = [r for r in s2["finished"] if len(r.generated) < r.max_new]
    shed_frac = round(len(shed) / total2, 4)
    ok2 = (len(shed) > 0 and lag is not None
           and 0 <= lag <= detect_within and not short
           and len(s2["finished"]) + len(shed) == total2)
    results["storm_shed"] = {
        "plan": plan.describe(), "shed": len(shed), "total": total2,
        "completed": len(s2["finished"]),
        "first_shed_step": first_shed, "onset_step": CHAOS_STORM_STEP,
        "detect_lag_steps": lag, "shed_frac": shed_frac,
        "short_completions": len(short), "ok": ok2, "steps": s2["steps"],
    }
    oks.append(ok2)
    print(f"# chaos storm_shed: shed={len(shed)}/{total2} "
          f"first_shed_step={first_shed} (onset {CHAOS_STORM_STEP}, "
          f"lag {lag} <= {detect_within}) "
          f"completed={len(s2['finished'])}", file=log, flush=True)

    # ---- 3) slow host → schedule/token invariance, delay visible.
    sc3 = _chaos_sc(n)
    trace3 = synthetic_trace(sc3)
    ref = run_engine(mesh, cfg, params, trace3, sc=sc3, mode="continuous")
    plan = faults.FaultPlan(slow_rank=0, slow_ms=CHAOS_SLOW_MS,
                            start_step=CHAOS_SLOW_START)
    with faults.injecting(plan):
        s3 = run_engine(mesh, cfg, params, trace3, sc=sc3,
                        mode="continuous")
    ref_toks, got_toks = streams(ref), streams(s3)
    bitwise = ref_toks == got_toks
    # Graded on the per-token cadence, which samples only decode steps,
    # each carrying the full delay.
    tok_ref = ref["serve_tok_ms_p99"]
    tok_slow = s3["serve_tok_ms_p99"]
    visible = (tok_ref is not None and tok_slow is not None
               and tok_slow - tok_ref >= 0.5 * CHAOS_SLOW_MS)
    ok3 = bitwise and s3["steps"] == ref["steps"] and visible
    results["slow_step"] = {
        "plan": plan.describe(), "steps": s3["steps"],
        "ref_steps": ref["steps"], "tokens_bitwise": bitwise,
        "tok_ms_p99_ref": tok_ref, "tok_ms_p99_slow": tok_slow,
        "delay_visible": visible, "ok": ok3,
    }
    oks.append(ok3)
    print(f"# chaos slow_step: steps {s3['steps']}=="
          f"{ref['steps']} tokens_bitwise={bitwise} "
          f"tok_ms_p99 {_fmt_ms(tok_ref)}->{_fmt_ms(tok_slow)} "
          f"(injected {CHAOS_SLOW_MS:g} ms/step)",
          file=log, flush=True)

    results["serve_preempt_recover_steps"] = recover if ok1 else None
    results["serve_shed_frac_overload"] = shed_frac if ok2 else None
    results["ok"] = all(oks)
    return results


def _build_chaos_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_p2p_torch serve --chaos",
        description="Injected-fault serving smoke: page-pool clamp → "
                    "preemption with zero completed-token loss, request "
                    "storm → shed verdicts within the step bound, slow "
                    "host → bitwise schedule invariance; nonzero exit "
                    "unless all three scenarios grade.",
    )
    p.add_argument("--detect-steps", type=int, default=6,
                   help="max allowed steps from overload onset to the "
                        "first shed verdict")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="device to serve on (default cuda: every visible "
                        "card, one dp rank each; raises without one)")
    p.add_argument("--cpu-mesh", type=int, default=None, metavar="N",
                   help="testing: serve on N CPU ranks (with --device "
                        "cpu)")
    return p


def chaos_main(argv: Optional[Sequence[str]] = None) -> int:
    args = _build_chaos_parser().parse_args(argv)
    from tpu_p2p_torch.serve.engine import _serve_devices, serve_mesh

    try:
        devices = _serve_devices(args)
        t0 = time.monotonic()
        res = run_chaos(serve_mesh(len(devices), devices),
                        detect_within=args.detect_steps, out=sys.stdout)
        wall = time.monotonic() - t0
        print(f"# chaos verdict: {'OK' if res['ok'] else 'FAIL'} "
              f"({wall:.1f}s)")
        print(json.dumps({
            "serve_preempt_recover_steps":
                res["serve_preempt_recover_steps"],
            "serve_shed_frac_overload": res["serve_shed_frac_overload"],
            "ok": res["ok"],
        }))
        return 0 if res["ok"] else 1
    except KeyboardInterrupt:
        print("interrupted", file=sys.stderr)
        return 130
    except Exception as e:  # noqa: BLE001 — the CLI's one fail-fast exit
        print(f"Failed: {type(e).__name__} '{e}'", file=sys.stderr)
        traceback.print_exception(e, file=sys.stderr)
        return 1
