#!/usr/bin/env python3
"""On-card smoke of the PyTorch port: ``python3 chip_smoke.py``.

Drives the port's serving path on one NVIDIA GPU at the full width of
the repo's production LM (436 M parameters, Dm 2048, 16 heads x 128
with GQA 2:1, 8 blocks, dense 4x FFN, vocab 32768, bfloat16) and fails
on the first phase that goes wrong:

1. device   — card name and count, ``nvidia-smi`` name and power limit;
2. build    — ``nvcc`` builds the KV-cache kernels from ``csrc/``;
3. kernels  — each kernel against its plain PyTorch version at the
   serving shapes, bitwise (they are copies), timed beside its bytes
   bound, the plain version and one ``index_put_`` call;
4. decode   — teacher-forced paged logits (chunk 1) against the dense
   KV-cached decode step, which writes through ``cache_row_write``;
5. serve    — ``run_engine`` on a seeded 16-request trace in continuous
   and static batching: every request finishes, step counts equal the
   dry ``simulate_schedule``, the page pool drains full, both batching
   modes emit the same tokens, and the paged write kernel ran on every
   step of every block.

Then one JSON line with every kernel's numbers, one with the card, and
as the last line ``{"ok": true, "device": {...}}``. Exits non-zero,
printing no result, where no CUDA device is visible.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
BF16_TOL = 5e-2                  # paged vs dense logits, bfloat16
MODEL = dict(heads=16, kv_heads=8, head_dim=128, stages=8,
             dense_ffn=True, moe_mult=4, vocab=32768, rope=True,
             norm=True, dtype="bfloat16", microbatches=1)
SLOTS, PAGE_LEN, MAX_BLOCKS, CHUNK = 32, 32, 8, 8
NUM_PAGES = SLOTS * 5 + 1        # 161 pages of 1 MiB
DECODE_POSITIONS = 16


def say(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_graph(fn, launches: int = 200, reps: int = 5) -> float:
    """Device ms per call: ``launches`` calls captured in one CUDA
    graph, replayed ``reps`` times between two events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        g.replay()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / (reps * launches)


def time_eager(fn, calls: int = 50) -> float:
    """ms per call issued from the host loop (launch cost included)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(calls):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / calls


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(
        a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
        b.view(torch.int16) if b.dtype == torch.bfloat16 else b)


# ------------------------------------------------------------ phase 3


def kernel_paged(TK, dev, gen) -> dict:
    """``paged_rows_write`` on the serving pool: 161 pages, 32 slots,
    n in {0, 1, 8} at every in-band offset."""
    S, H, Dh = MODEL["stages"], MODEL["kv_heads"], MODEL["head_dim"]
    pool = torch.randn((S, NUM_PAGES, H, PAGE_LEN, Dh), generator=gen,
                       device=dev).to(torch.bfloat16)
    slab8 = torch.randn((SLOTS, H, 8, Dh), generator=gen,
                        device=dev).to(torch.bfloat16)
    b = torch.arange(SLOTS, device=dev)
    n = torch.tensor([(0, 1, 8)[i % 3] for i in range(SLOTS)],
                     dtype=torch.int32, device=dev)
    r0 = torch.where(n == 8, 0, b % 8).to(torch.int32)
    page = torch.where(n > 0, 1 + 5 * b, 0).to(torch.int32)
    band = (b % (PAGE_LEN // 8)).to(torch.int32)
    stage = 3
    want = TK.paged_rows_write_plain(pool.clone(), slab8, page, band, r0,
                                     n, stage)
    got = pool.clone()
    TK.paged_rows_write(got, slab8, page, band, r0, n, stage)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if not bits_equal(got, want):
        raise AssertionError(
            f"paged_rows_write differs from its plain version "
            f"(max abs err {err})")
    # One PyTorch call for the same scatter: index_put_ of the live
    # rows, indices and row values gathered beforehand.
    live = [(i, r) for i in range(SLOTS)
            for r in range(int(r0[i]), int(r0[i]) + int(n[i]))]
    bi = torch.tensor([i for i, _ in live], device=dev)
    ri = torch.tensor([r for _, r in live], device=dev)
    pg = page.long()[bi][:, None]
    row = (band.long()[bi] * 8 + ri)[:, None]
    hi = torch.arange(H, device=dev)[None, :]
    vals = slab8[bi, :, ri]                           # [rows, H, Dh]
    dst = pool.clone()
    dst_s = dst[stage]

    def library():
        dst_s.index_put_((pg, hi, row), vals)

    library()
    if not bits_equal(dst, want):
        raise AssertionError("index_put_ yardstick disagrees")
    rows = len(live)
    row_bytes = H * Dh * 2
    nbytes = 2 * rows * row_bytes + 4 * SLOTS * 4    # rows in+out, idx
    args = (slab8, page, band, r0, n, stage)
    return {
        "name": "paged_rows_write", "route": "cuda",
        "source": "tpu_p2p_torch/csrc/kvcache.cu",
        "replaces": "tpu_p2p/ops/kvcache.py:89",
        "max_abs_err": err,
        "ms": time_graph(lambda: TK.paged_rows_write(got, *args)),
        "plain_ms": time_eager(
            lambda: TK.paged_rows_write_plain(got, *args), calls=20),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": time_graph(library),
        "host_loop_ms": time_eager(lambda: TK.paged_rows_write(got, *args)),
    }


def kernel_cache_row(TK, dev, gen) -> dict:
    """``cache_row_write`` on the dense cache ``[8, 32, 8, 256, 128]``."""
    S, H, Dh = MODEL["stages"], MODEL["kv_heads"], MODEL["head_dim"]
    T = MAX_BLOCKS * PAGE_LEN
    cache = torch.randn((S, SLOTS, H, T, Dh), generator=gen,
                        device=dev).to(torch.bfloat16)
    slab = torch.randn((SLOTS, H, 1, Dh), generator=gen,
                       device=dev).to(torch.bfloat16)
    pos, stage = 37, 5
    want = TK.cache_row_write_plain(cache.clone(), slab, pos, stage)
    got = cache.clone()
    TK.cache_row_write(got, slab, pos, stage)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if not bits_equal(got, want):
        raise AssertionError(
            f"cache_row_write differs from its plain version "
            f"(max abs err {err})")
    bi = torch.arange(SLOTS, device=dev)[:, None]
    hi = torch.arange(H, device=dev)[None, :]
    ti = torch.tensor(pos, device=dev)
    vals = slab[:, :, 0]
    dst = cache.clone()
    dst_s = dst[stage]

    def library():
        dst_s.index_put_((bi, hi, ti), vals)

    library()
    if not bits_equal(dst, want):
        raise AssertionError("index_put_ yardstick disagrees")
    nbytes = 2 * SLOTS * H * Dh * 2
    return {
        "name": "cache_row_write", "route": "cuda",
        "source": "tpu_p2p_torch/csrc/kvcache.cu",
        "replaces": "tpu_p2p/ops/kvcache.py:25",
        "max_abs_err": err,
        "ms": time_graph(lambda: TK.cache_row_write(got, slab, pos, stage)),
        "plain_ms": time_eager(
            lambda: TK.cache_row_write_plain(got, slab, pos, stage)),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": time_graph(library),
        "host_loop_ms": time_eager(
            lambda: TK.cache_row_write(got, slab, pos, stage)),
    }


# ------------------------------------------------------------ phase 4


def decode_parity(cfg, params, dev, TK) -> dict:
    """Teacher-forced dense decode vs the paged step at chunk 1 over
    ``DECODE_POSITIONS`` positions; the cache window equals the paged
    window, so both attend over the same shapes."""
    from tpu_p2p_torch.models import decode as D
    from tpu_p2p_torch.serve import paged_cache as P

    toks = np.random.default_rng(7).integers(
        0, cfg.vocab, (SLOTS, DECODE_POSITIONS))
    dstep = D.make_flagship_lm_decode_step(cfg)
    cache = D.init_kv_cache(cfg, MAX_BLOCKS * PAGE_LEN, dev)
    pstep = P.make_paged_lm_step(cfg, page_len=PAGE_LEN,
                                 max_blocks=MAX_BLOCKS, chunk=1)
    pool = P.init_paged_pool(cfg, SLOTS + 1, PAGE_LEN, dev)
    table = torch.zeros((SLOTS, MAX_BLOCKS), dtype=torch.int64, device=dev)
    table[:, 0] = torch.arange(1, SLOTS + 1, device=dev)
    ones = torch.ones(SLOTS, dtype=torch.int64, device=dev)
    TK.reset_launches()
    worst, bitwise = 0.0, True
    for t in range(DECODE_POSITIONS):
        tk = torch.from_numpy(toks[:, t:t + 1]).to(dev)
        cache, dense = dstep(params, cache, tk, t)
        _, paged = pstep(params, pool, tk, t * ones, ones, table)
        if tuple(dense.shape) != (SLOTS, 1, cfg.vocab) \
                or not torch.isfinite(dense).all() \
                or not torch.isfinite(paged).all():
            raise AssertionError(f"position {t}: bad logits "
                                 f"{tuple(dense.shape)}")
        worst = max(worst, (dense - paged).abs().max().item())
        bitwise &= torch.equal(dense, paged)
    torch.cuda.synchronize()
    counts = dict(TK.launches)
    want = 2 * cfg.stages * DECODE_POSITIONS
    if counts["cache_row_write"] != want \
            or counts["paged_rows_write"] != want:
        raise AssertionError(f"decode launches {counts}, expected {want} "
                             "of each kernel")
    if worst > BF16_TOL:
        raise AssertionError(f"paged vs dense max abs diff {worst} > "
                             f"{BF16_TOL}")
    return {"max_abs_diff": worst, "bitwise": bitwise, "launches": counts}


# ------------------------------------------------------------ phase 5


def serve_config(cfg):
    """The graded serving geometry (``bench.py:1649-1658``) on a
    16-request trace at rate 4 from seed 0."""
    from tpu_p2p_torch.config import ServeConfig

    return ServeConfig(slots=SLOTS, page_len=PAGE_LEN, num_pages=NUM_PAGES,
                       max_blocks=MAX_BLOCKS, chunk=CHUNK, requests=16,
                       seed=0, rate=4.0, prompt_len=(16, 96),
                       gen_len=(16, 64), vocab=cfg.vocab, dtype=cfg.dtype)


def serve(cfg, params, TK, card: str) -> dict:
    from tpu_p2p_torch.serve.batcher import simulate_schedule
    from tpu_p2p_torch.serve.engine import run_engine, synthetic_trace

    sc = serve_config(cfg)
    trace = synthetic_trace(sc)
    run_engine(cfg, params, trace[:2], sc=sc)      # warm-up, not counted
    torch.cuda.synchronize()
    streams, busy_total = {}, 0
    TK.reset_launches()
    for mode in ("continuous", "static"):
        sim = simulate_schedule(
            trace, slots=sc.slots, page_len=sc.page_len,
            num_pages=sc.num_pages, max_blocks=sc.max_blocks,
            chunk=sc.chunk, mode=mode)
        torch.cuda.reset_peak_memory_stats()
        out = run_engine(cfg, params, trace, sc=sc, mode=mode)
        torch.cuda.synchronize()
        b = out["batcher"]
        busy = b.step_idx - b.idle_steps
        busy_total += busy
        fin = out["finished"]
        if len(fin) != len(trace) or any(len(r.generated) != r.max_new
                                          for r in fin):
            raise AssertionError(f"{mode}: {len(fin)}/{len(trace)} "
                                 "requests finished in full")
        if (busy, b.idle_steps) != (sim["steps"], sim["idle_steps"]):
            raise AssertionError(
                f"{mode}: {busy} busy + {b.idle_steps} idle steps, the "
                f"dry schedule says {sim['steps']} + {sim['idle_steps']}")
        if b.pool_alloc.available(0) != b.pool_alloc.capacity:
            raise AssertionError(f"{mode}: page leak")
        streams[mode] = {r.rid: list(r.generated) for r in fin}
        say(f"serve {mode}: {out['requests']} requests, "
            f"{out['prompt_tokens']} prompt + {out['gen_tokens']} "
            f"generated tokens, {busy} steps (= simulate_schedule) + "
            f"{b.idle_steps} idle | {out['serve_tokens_per_s']} tokens/s "
            f"ttft p50 {out['serve_ttft_ms_p50']} ms p99 "
            f"{out['serve_ttft_ms_p99']} ms | per-token p50 "
            f"{out['serve_tok_ms_p50']} ms p99 {out['serve_tok_ms_p99']} "
            f"ms | peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB | "
            f"wall {out['wall_s']} s | {card}")
    counts = dict(TK.launches)
    want = 2 * cfg.stages * busy_total
    if counts["paged_rows_write"] != want:
        raise AssertionError(f"serve launched paged_rows_write "
                             f"{counts['paged_rows_write']} times, "
                             f"expected {want}")
    if streams["continuous"] != streams["static"]:
        diff = [r for r in streams["continuous"]
                if streams["continuous"][r] != streams["static"][r]]
        raise AssertionError(f"continuous vs static streams differ for "
                             f"requests {diff}")
    return {"launches": counts}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this smoke runs on an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    from tpu_p2p_torch.models.flagship import (
        FlagshipConfig, init_flagship_params)
    from tpu_p2p_torch.ops import kvcache as TK
    from tpu_p2p_torch.utils import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False   # float32 stays float32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    card = card_line()
    say(f"device: {name} x{count} | nvidia-smi: {card} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    info = cuda_build.build(["kvcache"])["kvcache"]
    say(f"build: {info['cmd'] or 'up to date: ' + str(info['path'])} "
        f"({time.perf_counter() - t0:.2f} s)")

    gen = torch.Generator(device=dev).manual_seed(0)
    kernels = [kernel_paged(TK, dev, gen), kernel_cache_row(TK, dev, gen)]
    for k in kernels:
        say(f"kernel {k['name']}: bitwise == plain | {k['ms']:.5f} ms "
            f"(graph replay) vs bound {k['bound_ms']:.5f} ms, plain "
            f"{k['plain_ms']:.5f} ms, index_put_ {k['library_ms']:.5f} ms, "
            f"host loop {k['host_loop_ms']:.5f} ms | {card}")

    cfg = FlagshipConfig(batch=SLOTS, **MODEL)
    t0 = time.perf_counter()
    params = init_flagship_params(cfg, seed=0, device=dev)
    n_params = sum(p.numel() for p in params.values())
    say(f"model: {n_params / 1e6:.1f} M parameters, {cfg.dtype}, seeded "
        f"init {time.perf_counter() - t0:.1f} s")

    dec = decode_parity(cfg, params, dev, TK)
    say(f"decode: paged (chunk 1) vs dense over {DECODE_POSITIONS} "
        f"positions x {SLOTS} slots: max abs diff "
        f"{dec['max_abs_diff']} (tol {BF16_TOL}), bitwise "
        f"{dec['bitwise']} | launches {dec['launches']}")

    srv = serve(cfg, params, TK, card)
    launches = {"cache_row_write": dec["launches"]["cache_row_write"],
                "paged_rows_write": srv["launches"]["paged_rows_write"]}
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if not k["launches"]:
            raise AssertionError(f"{k['name']} never launched")
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    say(json.dumps({"kernels": [{key: k[key] for key in keys}
                                for k in kernels]}))
    say(f"card: {card}")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
