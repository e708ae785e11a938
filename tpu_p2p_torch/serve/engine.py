"""Request scheduler + serving engine — ``python -m tpu_p2p_torch
serve``. Port of ``tpu_p2p/serve/engine.py``.

Admits a seeded synthetic trace (Poisson arrivals in scheduler steps,
mixed prompt/output lengths), drives the continuous batcher's mixed
step in a host loop on one device, and reports aggregate tokens/s
(prompt + generated), time-to-first-token p50/p99 and per-token latency
p50/p99. ``--obs-jsonl`` appends one ``{"obs": "request"}`` span record
per request plus one ``{"obs": "serve_summary"}`` record.
``--batching both`` runs continuous and static batching on the same
trace.

Runs on ``--device cuda`` (the default; raises when no card is
present) or ``--device cpu``. Not ported yet, and rejected:
``--disagg``, ``--chaos``, ``--trace``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from typing import List, Optional, Sequence

import numpy as np
import torch

from tpu_p2p_torch.config import (
    BATCHING,
    SERVE_STOPS,
    ServeConfig,
    parse_range,
)
from tpu_p2p_torch.models.flagship import FlagshipConfig, init_flagship_params
from tpu_p2p_torch.serve.batcher import Batcher, Request, percentile
from tpu_p2p_torch.serve.paged_cache import kv_page_bytes
from tpu_p2p_torch.serve.resilience import preempt_recover_steps
from tpu_p2p_torch.utils.device import resolve_device

__all__ = ["run_engine", "synthetic_trace", "shared_prefix_trace",
           "resolve_device", "main"]


def sample_request(rng, sc: ServeConfig, rid: int,
                   arrival_step: int) -> Request:
    """One synthetic request off ``rng``: lengths uniform over the
    configured ranges, prompt ids uniform over the vocab."""
    p = int(rng.integers(sc.prompt_len[0], sc.prompt_len[1] + 1))
    g = int(rng.integers(sc.gen_len[0], sc.gen_len[1] + 1))
    prompt = rng.integers(0, sc.vocab, p).astype(np.int32)
    return Request(rid=rid, prompt=prompt, max_new=g,
                   arrival_step=arrival_step)


def synthetic_trace(sc: ServeConfig) -> List[Request]:
    """Seeded trace: exponential inter-arrival gaps measured in
    scheduler steps, shapes via :func:`sample_request`."""
    rng = np.random.default_rng(sc.seed)
    t = 0.0
    reqs = []
    for i in range(sc.requests):
        t += rng.exponential(1.0 / sc.rate)
        reqs.append(sample_request(rng, sc, i, int(t)))
    return reqs


def shared_prefix_trace(sc: ServeConfig, prefix_len: int
                        ) -> List[Request]:
    """Seeded burst trace whose prompts all open with one shared
    ``prefix_len``-token prefix, every request arriving at step 0."""
    if sc.prompt_len[0] < prefix_len:
        raise ValueError(
            f"shared prefix ({prefix_len} tokens) exceeds the "
            f"minimum prompt length {sc.prompt_len[0]}"
        )
    rng = np.random.default_rng(sc.seed)
    prefix = rng.integers(0, sc.vocab, prefix_len).astype(np.int32)
    reqs = []
    for i in range(sc.requests):
        p = int(rng.integers(sc.prompt_len[0], sc.prompt_len[1] + 1))
        g = int(rng.integers(sc.gen_len[0], sc.gen_len[1] + 1))
        sfx = rng.integers(0, sc.vocab, p - prefix_len).astype(np.int32)
        prompt = (np.concatenate([prefix, sfx]) if p > prefix_len
                  else prefix.copy())
        reqs.append(Request(rid=i, prompt=prompt, max_new=g,
                            arrival_step=0))
    return reqs


def _request_record(r: Request) -> dict:
    def ms(a, b):
        return (round((b - a) * 1e3, 3)
                if a is not None and b is not None else None)

    rec = {
        "obs": "request",
        "id": r.rid,
        "prompt_tokens": r.n_prompt,
        "output_tokens": len(r.generated),
        "enqueue_step": r.enqueue_step,
        "prefill_start_step": r.prefill_start_step,
        "first_token_step": r.first_token_step,
        "finish_step": r.finish_step,
        "queue_ms": ms(r.t_enqueue, r.t_prefill_start),
        "prefill_ms": ms(r.t_prefill_start, r.t_first_token),
        "ttft_ms": ms(r.t_enqueue, r.t_first_token),
        "decode_ms": ms(r.t_first_token, r.t_finish),
        "total_ms": ms(r.t_enqueue, r.t_finish),
        "outcome": r.outcome,
        "shed_step": r.shed_step,
        "deadline_step": r.deadline_step,
        "preemptions": r.preemptions,
        "pool": r.pool,
    }
    if r.prefix_pages or r.spec_drafted:
        rec.update({
            "prefix_pages": r.prefix_pages,
            "prefix_tokens": r.prefix_tokens,
            "spec_drafted": r.spec_drafted,
            "spec_accepted": r.spec_accepted,
            "decode_steps": r.decode_steps,
        })
    return rec


def run_engine(cfg: FlagshipConfig, params, trace: List[Request], *,
               sc: ServeConfig, mode: str = "continuous",
               emit=None, clock=time.monotonic) -> dict:
    """Serve ``trace`` to completion in one batching mode on the
    params' device; → the summary dict plus the ``finished`` and
    ``shed_requests`` request lists and the ``batcher`` itself (for
    graders: its page pool and counters). ``emit`` receives JSON-ready
    obs records."""
    trace = [r.fresh() for r in trace]
    batcher = Batcher(
        cfg, params, slots=sc.slots, page_len=sc.page_len,
        num_pages=sc.num_pages, max_blocks=sc.max_blocks,
        chunk=sc.chunk, mode=mode, queue_depth=sc.queue_depth,
        deadline_steps=sc.deadline_steps, stop=sc.stop,
        stop_seed=sc.seed, eos_prob=sc.eos_prob,
        prefix_cache=sc.prefix_cache, spec_k=sc.spec_k, clock=clock)
    t0 = clock()
    finished = batcher.run(trace)
    wall = max(clock() - t0, 1e-9)
    prompt_toks = sum(r.n_prompt for r in finished)
    gen_toks = sum(len(r.generated) for r in finished)
    ttft = [(r.t_first_token - r.t_enqueue) * 1e3 for r in finished
            if r.t_first_token is not None]
    tok_ms = [(r.t_finish - r.t_first_token) * 1e3
              / (len(r.generated) - 1)
              for r in finished
              if len(r.generated) > 1 and r.t_finish is not None]
    shed = batcher.shed
    summary = {
        "mode": mode,
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
    }
    if sc.prefix_cache or sc.spec_k:
        tok_bytes = kv_page_bytes(cfg, sc.page_len) // sc.page_len
        ttft_steps = [r.first_token_step - r.enqueue_step
                      for r in finished
                      if r.first_token_step is not None]
        summary.update({
            "prefix_hits": batcher.prefix_hits,
            "prefix_pages_shared": batcher.prefix_pages_shared,
            "prefix_tokens_saved": batcher.prefix_tokens_saved,
            "prefix_saved_bytes":
                batcher.prefix_tokens_saved * tok_bytes,
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
    return {**summary, "finished": finished, "shed_requests": shed,
            "batcher": batcher}


def _r3(v):
    return round(v, 3) if v is not None else None


def _engine_model(sc: ServeConfig) -> FlagshipConfig:
    """The CLI's serving model: a small dense-FFN LM (RoPE + RMSNorm,
    GQA 2:1) — the reference CLI's model, so the two engines serve the
    same weights."""
    return FlagshipConfig(
        batch=sc.slots, seq=16, heads=4, kv_heads=2, head_dim=16,
        stages=2, microbatches=1, dense_ffn=True, moe_mult=2,
        vocab=sc.vocab, norm=True, rope=True, dtype=sc.dtype,
    )


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_p2p_torch serve",
        description="Serving engine smoke: paged KV cache + continuous "
                    "batching over a synthetic Poisson request trace.",
    )
    p.add_argument("--requests", type=int, default=8,
                   help="trace length (synthetic requests)")
    p.add_argument("--seed", type=int, default=0,
                   help="trace seed (arrivals, lengths, prompt ids)")
    p.add_argument("--rate", type=float, default=1.0,
                   help="mean arrivals per scheduler step (Poisson)")
    p.add_argument("--prompt-len", default="4:12", metavar="LO:HI",
                   help="prompt length range, inclusive")
    p.add_argument("--gen-len", default="4:8", metavar="LO:HI",
                   help="generated length range, inclusive")
    p.add_argument("--slots", type=int, default=8,
                   help="fixed-width slot batch")
    p.add_argument("--page-len", type=int, default=8,
                   help="tokens per KV page (multiple of 8)")
    p.add_argument("--pages", type=int, default=None,
                   help="page-pool size (default: sized to the trace's "
                        "worst request on every slot)")
    p.add_argument("--chunk", type=int, default=4,
                   help="prefill chunk width (1/2/4/8 tokens per step)")
    p.add_argument("--vocab", type=int, default=128,
                   help="synthetic vocabulary size")
    p.add_argument("--dtype", default="float32",
                   help="model/cache dtype")
    p.add_argument("--batching", default="both", choices=BATCHING,
                   help="batching mode(s) to run — 'both' prints the "
                        "A/B on the same trace")
    p.add_argument("--queue-depth", type=int, default=0,
                   help="bounded admission queue (0 = unbounded)")
    p.add_argument("--deadline-steps", type=int, default=0,
                   help="admission deadline in scheduler steps (0 = "
                        "none)")
    p.add_argument("--stop", default="length", choices=SERVE_STOPS,
                   help="stop rule: exact lengths, or seeded per-token "
                        "EOS draws")
    p.add_argument("--eos-prob", type=float, default=0.1,
                   help="--stop eos: per-token stop probability")
    p.add_argument("--prefix-cache", action="store_true",
                   help="map matching full prompt pages copy-on-write "
                        "out of a refcounted prefix index")
    p.add_argument("--spec-k", type=int, default=0, metavar="K",
                   help="speculative decoding: verify up to K ngram "
                        "draft tokens per decode step (0 = off)")
    p.add_argument("--reuse", action="store_true",
                   help="the graded KV-reuse smoke (needs >= 2 pool "
                        "shards: reports NULL on one device)")
    p.add_argument("--obs-jsonl", default=None, metavar="PATH",
                   help="append per-request span records + the serve "
                        "summary to this JSONL timeline")
    for flag in ("--disagg", "--chaos"):
        p.add_argument(flag, action="store_true",
                       help="not ported yet (rejected)")
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="not ported yet (rejected)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="device to serve on (default cuda; raises "
                        "without a card)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _build_parser().parse_args(
        list(sys.argv[1:] if argv is None else argv))
    for flag in ("disagg", "chaos", "trace"):
        if getattr(args, flag):
            print(f"serve --{flag}: not ported yet", file=sys.stderr)
            return 2
    try:
        device = resolve_device(args.device)
        if args.reuse:
            # The reference grades prefix sharing per pool shard and
            # prints NULL below two shards; one device is one shard.
            print("serve reuse NULL: 1 device(s) — prefix sharing is "
                  "per-shard, a single-shard TTFT ratio grades nothing; "
                  "need >= 2 devices (no fake numbers)")
            return 0
        prompt_rng = parse_range(args.prompt_len)
        gen_rng = parse_range(args.gen_len)
        max_blocks = -(-(prompt_rng[1] + gen_rng[1]) // args.page_len)
        pages = args.pages
        if pages is None:
            # Every slot serving a max-length request, plus the trash
            # page.
            pages = args.slots * max_blocks + 1
        sc = ServeConfig(
            slots=args.slots, page_len=args.page_len, num_pages=pages,
            max_blocks=max_blocks, chunk=args.chunk,
            batching=args.batching, requests=args.requests,
            seed=args.seed, rate=args.rate, prompt_len=prompt_rng,
            gen_len=gen_rng, vocab=args.vocab, dtype=args.dtype,
            queue_depth=args.queue_depth,
            deadline_steps=args.deadline_steps, stop=args.stop,
            eos_prob=args.eos_prob, prefix_cache=args.prefix_cache,
            spec_k=args.spec_k,
        )
        cfg = _engine_model(sc)
        params = init_flagship_params(cfg, device=device)
        trace = synthetic_trace(sc)
        reuse_tag = ((" prefix_cache=on" if sc.prefix_cache else "")
                     + (f" spec_k={sc.spec_k}" if sc.spec_k else ""))
        print(f"serve device {device.type}: slots={sc.slots} "
              f"page_len={sc.page_len} pages={sc.num_pages} "
              f"window={sc.max_blocks * sc.page_len} "
              f"chunk={sc.chunk} "
              f"vocab={sc.vocab} {sc.dtype}{reuse_tag}")
        print(f"trace: {sc.requests} requests seed={sc.seed} "
              f"rate={sc.rate}/step prompt {prompt_rng[0]}-"
              f"{prompt_rng[1]} gen {gen_rng[0]}-{gen_rng[1]}")
        modes = (("continuous", "static") if args.batching == "both"
                 else (args.batching,))
        fh = open(args.obs_jsonl, "a") if args.obs_jsonl else None
        try:
            emit = None
            if fh is not None:
                def emit(rec):
                    fh.write(json.dumps(rec) + "\n")
                    fh.flush()
            summaries = {}
            for mode in modes:
                s = run_engine(cfg, params, trace, sc=sc, mode=mode,
                               emit=emit)
                summaries[mode] = s
                _print_summary(s, sc)
        finally:
            if fh is not None:
                fh.close()
        if len(modes) == 2:
            busy = {m: s["steps"] - s["idle_steps"]
                    for m, s in summaries.items()}
            print(f"A/B schedule: continuous "
                  f"{busy['continuous']} steps vs static "
                  f"{busy['static']} steps "
                  f"({busy['static'] / max(busy['continuous'], 1):.2f}x)")
        return 0
    except KeyboardInterrupt:
        print("interrupted", file=sys.stderr)
        return 130
    except Exception as e:  # noqa: BLE001 — the CLI's one fail-fast exit
        print(f"Failed: {type(e).__name__} '{e}'", file=sys.stderr)
        traceback.print_exception(e, file=sys.stderr)
        return 1


def _print_summary(s: dict, sc: ServeConfig) -> None:
    print(f"{s['mode']}: {s['requests']} requests, "
          f"{s['prompt_tokens']} prompt + "
          f"{s['gen_tokens']} generated tokens in "
          f"{s['steps']} steps ({s['idle_steps']} idle)")
    print(f"  {s['serve_tokens_per_s']:,.0f} tokens/s  "
          f"ttft p50 {_f(s['serve_ttft_ms_p50'])}ms "
          f"p99 {_f(s['serve_ttft_ms_p99'])}ms  "
          f"tok p50 {_f(s['serve_tok_ms_p50'])}ms "
          f"p99 {_f(s['serve_tok_ms_p99'])}ms")
    if s["shed"] or s["preemptions"]:
        print(f"  shed={s['shed']} "
              f"(frac {s['shed_frac']:.2f})  "
              f"preemptions={s['preemptions']} "
              f"recover_steps="
              f"{s['preempt_recover_steps']}")
    if sc.prefix_cache or sc.spec_k:
        print(f"  reuse: prefix_hits={s['prefix_hits']} "
              f"pages_shared={s['prefix_pages_shared']} "
              f"tokens_saved={s['prefix_tokens_saved']} "
              f"({s['prefix_saved_bytes']} B) "
              f"forks={s['cow_forks']}  spec "
              f"{s['spec_decode_tokens']}/"
              f"{s['spec_decode_steps']} tok/step="
              f"{_f(s['serve_spec_accept_rate'])}")


def _f(v):
    return f"{v:.1f}" if v is not None else "-"
