"""Request scheduler + serving engine — ``python -m tpu_p2p_torch
serve``. Port of ``tpu_p2p/serve/engine.py``.

Admits a seeded synthetic trace (Poisson arrivals in scheduler steps,
mixed prompt/output lengths), drives the continuous batcher's mixed
step in a host loop over the serve mesh (:func:`serve_mesh`: every
rank on the ``dp`` axis, one pool shard and slot slice a rank, one
controller), and reports aggregate tokens/s
(prompt + generated), time-to-first-token p50/p99 and per-token latency
p50/p99. ``--obs-jsonl`` appends one ``{"obs": "request"}`` span record
per request plus one ``{"obs": "serve_summary"}`` record; ``--trace
PATH`` writes the same records as a Chrome trace
(:mod:`tpu_p2p_torch.obs.trace`). ``--batching both`` runs continuous
and static batching on the same trace. ``--disagg`` serves the trace
disaggregated (a tensor-parallel prefill on the first ``--prefill-tp``
ranks, half of them by default, decode replicas on the others, KV pages
migrated between them, :mod:`tpu_p2p_torch.serve.disagg`), then runs
the colocated continuous twin on the full mesh and exits nonzero unless
every token stream is bitwise the twin's. ``--reuse`` runs the graded
KV-reuse smoke (from 2 ranks up) and ``--chaos`` the injected-fault
smoke (:func:`tpu_p2p_torch.serve.resilience.chaos_main`).

Runs on ``--device cuda`` (the default: every visible card, one rank
each, and raises when there is none) or ``--device cpu`` (``--cpu-mesh
N``: N CPU ranks).
"""

from __future__ import annotations

import argparse
import dataclasses
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
    TRANSPORTS,
    ServeConfig,
    parse_range,
)
from tpu_p2p_torch.models.flagship import FlagshipConfig, init_flagship_params
from tpu_p2p_torch.parallel.runtime import LocalMesh
from tpu_p2p_torch.serve.batcher import Batcher, Request, percentile
from tpu_p2p_torch.serve.paged_cache import kv_page_bytes
from tpu_p2p_torch.serve import resilience as R
from tpu_p2p_torch.utils.device import resolve_device

__all__ = ["run_engine", "serve_mesh", "synthetic_trace",
           "shared_prefix_trace", "resolve_device", "main"]


def serve_mesh(n_devices: int, devices: Optional[Sequence] = None
               ) -> LocalMesh:
    """The serve mesh: the first ``n_devices`` of ``devices`` (default:
    every visible card), all on the ``dp`` axis, each a rank of one
    controller with its own stream. Devices may repeat: ranks then
    share a card."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if not 1 <= n_devices <= len(devices):
        raise ValueError(f"serve_mesh({n_devices}) needs 1..{len(devices)} "
                         "devices")
    return LocalMesh(tuple(devices[:n_devices]), ("dp",))


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
    if r.migrate_step is not None or r.migrations:
        rec.update({
            "prefill_done_step": r.prefill_done_step,
            "migrate_step": r.migrate_step,
            "migrate_wait_steps": r.migrate_wait_steps,
            "decode_shard": r.decode_shard,
            "migrations": r.migrations,
            "migrated_blocks": r.migrated_blocks,
        })
    if r.prefix_pages or r.spec_drafted:
        rec.update({
            "prefix_pages": r.prefix_pages,
            "prefix_tokens": r.prefix_tokens,
            "spec_drafted": r.spec_drafted,
            "spec_accepted": r.spec_accepted,
            "decode_steps": r.decode_steps,
        })
    return rec


def run_engine(mesh: LocalMesh, cfg: FlagshipConfig, params,
               trace: List[Request], *, sc: ServeConfig,
               mode: str = "continuous", emit=None,
               clock=time.monotonic) -> dict:
    """Serve ``trace`` to completion in one batching mode over ``mesh``
    (a :func:`serve_mesh`); → the summary dict plus the ``finished`` and
    ``shed_requests`` request lists and the ``batcher`` itself (for
    graders: its page pool and counters). ``emit`` receives JSON-ready
    obs records. An active fault plan applies through
    :func:`tpu_p2p_torch.serve.resilience.apply_serve_faults` (the
    page-pool clamp, a request storm, the slow-step hook)."""
    trace = [r.fresh() for r in trace]
    trace, pool_clamp, step_hook = R.apply_serve_faults(trace, sc)
    batcher = Batcher(
        mesh, cfg, params, slots=sc.slots, page_len=sc.page_len,
        num_pages=sc.num_pages, max_blocks=sc.max_blocks,
        chunk=sc.chunk, mode=mode, queue_depth=sc.queue_depth,
        deadline_steps=sc.deadline_steps, stop=sc.stop,
        stop_seed=sc.seed, eos_prob=sc.eos_prob,
        pool_clamp=pool_clamp, step_hook=step_hook,
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
        "preempt_recover_steps": R.preempt_recover_steps(finished),
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


def _engine_model(sc: ServeConfig, prefill_tp: int = 1) -> FlagshipConfig:
    """The CLI's serving model: a small dense-FFN LM (RoPE + RMSNorm,
    GQA 2:1) — the reference CLI's model, so the two engines serve the
    same weights. ``prefill_tp`` (the disagg prefill side's tp size)
    widens the head counts just enough that the KV heads divide it, as
    the reference does: ``prefill_tp <= 2`` keeps the 4:2 model."""
    kv = 2 if prefill_tp <= 2 else int(prefill_tp)
    return FlagshipConfig(
        batch=sc.slots, seq=16, heads=2 * kv, kv_heads=kv, head_dim=16,
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
                   help="fixed-width slot batch (must divide by the dp "
                        "ranks)")
    p.add_argument("--page-len", type=int, default=8,
                   help="tokens per KV page (multiple of 8)")
    p.add_argument("--pages", type=int, default=None,
                   help="global page-pool size (default: sized to the "
                        "trace's worst request on every slot)")
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
                   help="run the graded KV-reuse smoke instead of a "
                        "plain trace: one shared-prefix burst trace "
                        "served baseline / prefix-cached / speculative, "
                        "graded on TTFT steps and accepted tokens a "
                        "decode step under bitwise token parity (needs "
                        ">= 2 ranks: reports NULL below)")
    p.add_argument("--obs-jsonl", default=None, metavar="PATH",
                   help="append per-request span records + the serve "
                        "summary to this JSONL timeline")
    p.add_argument("--disagg", action="store_true",
                   help="disaggregated prefill/decode: a tensor-parallel "
                        "prefill on the first ranks, decode replicas on "
                        "the others, each request's KV pages migrated "
                        "across; also runs the colocated continuous twin "
                        "and checks token-stream parity")
    p.add_argument("--prefill-tp", type=int, default=0,
                   help="--disagg: prefill submesh tp size == its "
                        "device count (0 = half the devices)")
    p.add_argument("--prefill-slots", type=int, default=4,
                   help="--disagg: prefill-side slot batch")
    p.add_argument("--migrate-chunks", type=int, default=1,
                   help="--disagg: split each KV-migration ship into "
                        "this many chunk hops (the ppermute wave)")
    p.add_argument("--transport", default="xla", choices=TRANSPORTS,
                   help="--disagg: migration ship transport (xla = a "
                        "library copy; pallas_dma = the peer-push and "
                        "fused-ship kernels)")
    p.add_argument("--chaos", action="store_true",
                   help="run the injected-fault chaos smoke instead of "
                        "a plain trace (its own flags: --detect-steps, "
                        "--device, --cpu-mesh)")
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="export the run's request lifecycles (queue/"
                        "prefill/decode spans, one track per slot lane, "
                        "disagg migration waits) as a Chrome-trace/"
                        "Perfetto JSON timeline; works with or without "
                        "--obs-jsonl")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="device to serve on (default cuda: every visible "
                        "card, one dp rank each; raises without one)")
    p.add_argument("--cpu-mesh", type=int, default=None, metavar="N",
                   help="testing: serve on N CPU ranks (with --device "
                        "cpu)")
    return p


def _serve_devices(args) -> List[torch.device]:
    """The ranks' devices: every visible card for ``--device cuda``
    (raising without one), one CPU rank, or ``--cpu-mesh N`` of them."""
    if args.cpu_mesh is not None:
        if args.device != "cpu":
            raise ValueError("--cpu-mesh N serves on N CPU ranks: pass "
                             "--device cpu with it")
        if args.cpu_mesh < 1:
            raise ValueError(f"--cpu-mesh needs N >= 1, got "
                             f"{args.cpu_mesh}")
        return [torch.device("cpu")] * args.cpu_mesh
    device = resolve_device(args.device)
    if device.type == "cpu":
        return [device]
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--chaos" in argv:
        # The chaos smoke has a parser of its own: the rest of argv goes
        # over whole, so an engine-only flag fails loudly.
        return R.chaos_main([a for a in argv if a != "--chaos"])
    args = _build_parser().parse_args(argv)
    if args.disagg and args.batching != "both":
        # The disagg engine is continuous by construction and runs its
        # own A/B against the colocated twin.
        raise SystemExit("--disagg runs continuous batching against the "
                         "colocated twin; drop --batching")
    try:
        devices = _serve_devices(args)
        if args.reuse:
            return _reuse_cli(args, devices)
        n = len(devices)
        n_dec = n
        prefill_tp = 0
        if args.disagg:
            from tpu_p2p_torch.serve.disagg import build_disagg_meshes

            # Validate the partition before anything is built.
            pre, dec, mig = build_disagg_meshes(args.prefill_tp, devices)
            prefill_tp, n_dec = pre.shape["tp"], dec.size
        mesh = serve_mesh(n, devices)
        prompt_rng = parse_range(args.prompt_len)
        gen_rng = parse_range(args.gen_len)
        max_blocks = -(-(prompt_rng[1] + gen_rng[1]) // args.page_len)
        pages = args.pages
        if pages is None:
            # Every slot serving a max-length request, plus each pool
            # shard's trash page.
            pages = args.slots * max_blocks + n_dec
            pages += (-pages) % n_dec
        sc = ServeConfig(
            slots=args.slots, page_len=args.page_len, num_pages=pages,
            max_blocks=max_blocks, chunk=args.chunk,
            batching=args.batching, requests=args.requests,
            seed=args.seed, rate=args.rate, prompt_len=prompt_rng,
            gen_len=gen_rng, vocab=args.vocab, dtype=args.dtype,
            queue_depth=args.queue_depth,
            deadline_steps=args.deadline_steps, stop=args.stop,
            eos_prob=args.eos_prob, disagg=args.disagg,
            prefill_tp=prefill_tp,
            prefill_slots=args.prefill_slots,
            # The prefill pool holds active prefills plus the
            # migration queue's residents waiting on decode capacity.
            prefill_pages=((args.prefill_slots + args.slots)
                           * max_blocks + 1) if args.disagg else 0,
            migrate_chunks=args.migrate_chunks, transport=args.transport,
            prefix_cache=args.prefix_cache, spec_k=args.spec_k,
        )
        cfg = _engine_model(sc, prefill_tp=max(prefill_tp, 1))
        params = init_flagship_params(cfg, device=devices[0])
        trace = synthetic_trace(sc)
        reuse_tag = ((" prefix_cache=on" if sc.prefix_cache else "")
                     + (f" spec_k={sc.spec_k}" if sc.spec_k else ""))
        kind = devices[0].type
        if sc.disagg:
            print(f"serve device {kind} disagg prefill {pre.shape} + "
                  f"decode {dec.shape}: slots={sc.slots}"
                  f"(+{sc.prefill_slots} prefill) "
                  f"page_len={sc.page_len} "
                  f"pages={sc.num_pages}+{sc.prefill_pages} "
                  f"window={sc.max_blocks * sc.page_len} "
                  f"chunk={sc.chunk} transport={sc.transport} "
                  f"vocab={sc.vocab} {sc.dtype}{reuse_tag}")
        else:
            print(f"serve device {kind}{_mesh_tag(mesh)}: slots={sc.slots} "
                  f"page_len={sc.page_len} pages={sc.num_pages} "
                  f"window={sc.max_blocks * sc.page_len} "
                  f"chunk={sc.chunk} "
                  f"vocab={sc.vocab} {sc.dtype}{reuse_tag}")
        print(f"trace: {sc.requests} requests seed={sc.seed} "
              f"rate={sc.rate}/step prompt {prompt_rng[0]}-"
              f"{prompt_rng[1]} gen {gen_rng[0]}-{gen_rng[1]}")
        fh = open(args.obs_jsonl, "a") if args.obs_jsonl else None
        records = [] if args.trace else None
        try:
            emit = None
            if fh is not None or records is not None:
                def emit(rec):
                    if fh is not None:
                        fh.write(json.dumps(rec) + "\n")
                        fh.flush()
                    if records is not None:
                        records.append(rec)
            if sc.disagg:
                try:
                    rc = _disagg_cli(mig, mesh, cfg, params, trace, sc,
                                     emit)
                finally:
                    mig.close()
                _write_serve_trace(args.trace, records)
                return rc
            modes = (("continuous", "static") if args.batching == "both"
                     else (args.batching,))
            summaries = {}
            for mode in modes:
                s = run_engine(mesh, cfg, params, trace, sc=sc, mode=mode,
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
        _write_serve_trace(args.trace, records)
        return 0
    except KeyboardInterrupt:
        print("interrupted", file=sys.stderr)
        return 130
    except Exception as e:  # noqa: BLE001 — the CLI's one fail-fast exit
        print(f"Failed: {type(e).__name__} '{e}'", file=sys.stderr)
        traceback.print_exception(e, file=sys.stderr)
        return 1


def _write_serve_trace(path, records) -> None:
    """``--trace``: the run's emitted obs records (request lifecycles
    and summaries) as a Chrome-trace timeline."""
    if not path:
        return
    from tpu_p2p_torch.obs.trace import write_chrome_trace

    obj = write_chrome_trace(path, obs_records=records or (),
                             meta={"source": "serve"})
    print(f"# wrote chrome trace {path} "
          f"({len(obj['traceEvents'])} events)")


def _mesh_tag(mesh: LocalMesh) -> str:
    """The header's mesh after the device word: nothing for one rank,
    the reference's ``{'dp': N}`` for more."""
    return f" {mesh.shape}" if mesh.size > 1 else ""


def _disagg_cli(mig, mesh, cfg, params, trace, sc: ServeConfig,
                emit) -> int:
    """The ``serve --disagg`` run: the disaggregated engine on the
    ``mig`` ranks, then the colocated continuous twin on the full serve
    ``mesh`` for the A/B and the bitwise token-stream parity check; → 0
    only when every stream matches."""
    from tpu_p2p_torch.serve.disagg import run_disagg_engine

    s = run_disagg_engine(mig, cfg, params, trace, sc=sc, emit=emit)
    print(f"disagg: {s['requests']} requests, "
          f"{s['prompt_tokens']} prompt + "
          f"{s['gen_tokens']} generated tokens in "
          f"{s['steps']} steps ({s['idle_steps']} idle)")
    print(f"  {s['serve_tokens_per_s']:,.0f} tokens/s  "
          f"ttft p50 {_f(s['serve_ttft_ms_p50'])}ms "
          f"p99 {_f(s['serve_ttft_ms_p99'])}ms  "
          f"tok p50 {_f(s['serve_tok_ms_p50'])}ms "
          f"p99 {_f(s['serve_tok_ms_p99'])}ms")
    mib = s["kv_migrate_bytes"] / 2**20
    print(f"  kv_migrate: {s['kv_migrated']} migrations, "
          f"{s['kv_migrate_blocks']} pages ({mib:.2f} MiB, "
          f"{_f(s['serve_kv_migrate_gbps'])} Gbps)  wait p50 "
          f"{int(s['migrate_wait_steps_p50'] or 0)} max "
          f"{int(s['migrate_wait_steps_max'] or 0)} steps")
    if s["shed"] or s["preemptions"]:
        print(f"  shed={s['shed']} (frac {s['shed_frac']:.2f})  "
              f"preemptions={s['preemptions']} recover_steps="
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
    # The colocated continuous twin on the same trace and params, over
    # the full mesh's shards.
    n = mesh.size
    pages = sc.slots * sc.max_blocks + n
    pages += (-pages) % n
    sc_co = dataclasses.replace(sc, disagg=False, num_pages=pages,
                                prefill_pages=0)
    co = run_engine(mesh, cfg, params, trace, sc=sc_co, mode="continuous")
    want = {r.rid: list(r.generated) for r in co["finished"]}
    got = {r.rid: list(r.generated) for r in s["finished"]}
    matched = sum(1 for rid, toks in got.items() if want.get(rid) == toks)
    parity = "OK" if (matched == len(got) == len(want)
                      and len(got) > 0) else "FAIL"
    print(f"colocated twin: {co['requests']} requests in "
          f"{co['steps']} steps ({co['idle_steps']} idle)  "
          f"token parity {parity} ({matched}/{len(got)} bitwise)")
    return 0 if parity == "OK" else 1


def _ttft_steps_mean(finished: List[Request]) -> float:
    vals = [r.first_token_step - r.enqueue_step for r in finished
            if r.first_token_step is not None]
    return float(np.mean(vals)) if vals else float("nan")


def _reuse_cli(args, devices) -> int:
    """The ``serve --reuse`` graded smoke: one seeded shared-prefix
    burst trace served three ways over the serve mesh — baseline,
    prefix-cached, speculative — and graded:

    - prefix caching must bring the mean TTFT, in scheduler steps,
      below 0.5× the baseline's;
    - speculative decoding must emit more than 1.0 accepted tokens a
      decode step with its ngram draft;

    each under bitwise token-stream parity with the baseline. Below 2
    ranks it prints NULL with the reason and exits 0: prefix sharing is
    per shard, and one shard's TTFT ratio grades nothing."""
    n = len(devices)
    if n < 2:
        print(f"serve reuse NULL: {n} device(s) — prefix sharing is "
              "per-shard, a single-shard TTFT ratio grades nothing; "
              "need >= 2 devices (no fake numbers)")
        return 0
    mesh = serve_mesh(n, devices)
    out = run_reuse(mesh, seed=args.seed, dtype=args.dtype)
    return 0 if out["verdict"] == "PASS" else 1


def run_reuse(mesh: LocalMesh, *, seed: int = 0,
              dtype: str = "float32") -> dict:
    """The three graded runs of ``serve --reuse`` over ``mesh``, printed
    as the reference prints them; → each run's summary and streams
    (``base``, ``prefix``, ``spec``), both grades and the ``verdict``."""
    n = mesh.size
    prefix_len = 48
    sc = ServeConfig(
        slots=n, page_len=8, num_pages=16 * n, max_blocks=8, chunk=4,
        requests=6 * n, seed=seed, prompt_len=(48, 54),
        gen_len=(3, 6), vocab=64, dtype=dtype,
    )
    cfg = _engine_model(sc)
    params = init_flagship_params(cfg, device=mesh.devices[0])
    trace = shared_prefix_trace(sc, prefix_len)
    print(f"serve reuse device {mesh.devices[0].type} {mesh.shape}: "
          f"slots={sc.slots} page_len={sc.page_len} pages={sc.num_pages} "
          f"window={sc.max_blocks * sc.page_len} chunk={sc.chunk} "
          f"vocab={sc.vocab} {sc.dtype}")
    print(f"reuse trace: {sc.requests} requests seed={sc.seed} "
          f"shared prefix {prefix_len} prompt {sc.prompt_len[0]}-"
          f"{sc.prompt_len[1]} gen {sc.gen_len[0]}-{sc.gen_len[1]} "
          f"burst@0")
    base = run_engine(mesh, cfg, params, trace, sc=sc)
    want = {r.rid: list(r.generated) for r in base["finished"]}
    base_ttft = _ttft_steps_mean(base["finished"])
    print(f"baseline: {base['requests']} requests, "
          f"{base['steps']} steps, ttft mean {base_ttft:.2f} steps")

    def parity(out) -> str:
        got = {r.rid: list(r.generated) for r in out["finished"]}
        return "OK" if got == want and len(got) > 0 else "FAIL"

    spec_k = 3
    pre = run_engine(mesh, cfg, params, trace,
                     sc=dataclasses.replace(sc, prefix_cache=True))
    pre_ttft = _ttft_steps_mean(pre["finished"])
    ratio = pre_ttft / base_ttft
    pre_parity = parity(pre)
    pre_grade = "PASS" if ratio < 0.5 and pre_parity == "OK" else "FAIL"
    print(f"prefix-cache: {pre['requests']} requests, "
          f"{pre['steps']} steps, prefix_hits={pre['prefix_hits']} "
          f"pages_shared={pre['prefix_pages_shared']} "
          f"tokens_saved={pre['prefix_tokens_saved']} "
          f"({pre['prefix_saved_bytes']} B) forks={pre['cow_forks']}")
    print(f"  ttft mean {pre_ttft:.2f} steps  ratio {ratio:.3f}  "
          f"parity {pre_parity}  grade(<0.5) {pre_grade}")
    spec = run_engine(mesh, cfg, params, trace,
                      sc=dataclasses.replace(sc, spec_k=spec_k))
    rate = spec["spec_decode_tokens"] / max(spec["spec_decode_steps"], 1)
    spec_parity = parity(spec)
    spec_grade = "PASS" if rate > 1.0 and spec_parity == "OK" else "FAIL"
    print(f"spec k={spec_k}: {spec['requests']} requests, "
          f"{spec['steps']} steps, drafts "
          f"{spec['spec_draft_accept_frac'] or 0:.3f} accepted frac "
          f"({spec['spec_decode_tokens']} tokens / "
          f"{spec['spec_decode_steps']} decode steps)")
    print(f"  tokens/decode-step {rate:.3f}  parity {spec_parity}  "
          f"grade(>1.0) {spec_grade}")
    verdict = "PASS" if pre_grade == spec_grade == "PASS" else "FAIL"
    print(f"reuse grade: {verdict}")
    return {"base": base, "prefix": pre, "spec": spec, "trace": trace,
            "cfg": cfg, "params": params, "prefix_grade": pre_grade,
            "spec_grade": spec_grade, "verdict": verdict}


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
