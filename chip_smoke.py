#!/usr/bin/env python3
"""On-card smoke of the PyTorch port: ``python3 chip_smoke.py``.

Drives the port's serving and training paths on one NVIDIA GPU at the
full width of the repo's production LM (436 M parameters, Dm 2048, 16
heads x 128 with GQA 2:1, 8 blocks, dense 4x FFN, vocab 32768,
bfloat16), then the reference program (the all-pairs P2P matrix and the
8 B latency line) on worlds of ranks that share the card, and fails on
the first phase that goes wrong:

1. device   — card name and count, ``nvidia-smi`` name and power limit;
2. build    — ``nvcc`` builds the KV-cache, flash-attention and
   peer-push kernels from ``csrc/``, one compiler per source, all
   started together;
3. kernels  — each KV-cache kernel against its plain PyTorch version at
   the serving shapes, bitwise (they are copies), timed beside its bytes
   bound, the plain version and one ``index_put_`` call;
4. flash    — the three flash kernels against their plain versions at
   the training shape (B 4, 16 heads over 8 KV heads, T 4096, D 128,
   bf16, causal; normalised L-inf <= 2e-2), there with a window of 1024
   (the banded sweep), and at T 512 in float32 with
   a window of 96, q_off != k_off and a random carry (atol = rtol =
   1e-4), each timed beside its bound, its plain version and SDPA;
5. train    — ``run_training`` at the full width and depth (B 4 x T
   4096, SGD lr 1e-2, 4 steps, seed 0): finite losses, the first near
   ln(vocab), every flash kernel launched once per block per step; then
   one step's gradients through the kernels against dense attention (at
   batch 1), 2 windowed steps (window 1024, 2 blocks), and one step
   under ``torch.profiler`` (kernel time by family, device idle share);
6. decode   — teacher-forced paged logits (chunk 1) against the dense
   KV-cached decode step, which writes through ``cache_row_write``;
7. serve    — ``run_engine`` on a seeded 16-request trace in continuous
   and static batching: every request finishes, step counts equal the
   dry ``simulate_schedule``, the page pool drains full, both batching
   modes emit the same tokens, and the paged write kernel ran on every
   step of every block;
8. p2p      — ``python -m tpu_p2p_torch`` through ``cli.main`` on a world
   of 1 (defaults: the 1x1 uni/bi matrices at 32 MiB; then the latency
   line, the self-edge floor); a world of 2 ranks sharing cuda:0
   (``make_runtime(device="cuda:0")`` each, then what ``cli.main`` runs)
   with ``pairwise --transport pallas_dma --check`` at the reference's
   32 MiB x 128 iterations and ``latency --transport pallas_dma``; a
   world of 4 at 4 MiB x 16 in full and submesh isolation. The
   peer-push kernel's launches on those runs must equal the count the
   workloads make; its arrivals must equal the plain version's (gloo, on
   ``.cpu()`` copies) and ``expected_permute`` bitwise over six edge
   sets at 136 B and the run's size in int8, a float32 [5, 3] row and
   one backward pass; then its per-hop time at 32 MiB beside its bound,
   the plain version and one ``copy_``. Ranks sharing a card run as
   time-sliced CUDA contexts, so these are not link numbers.

Then one JSON line with every kernel's numbers, one with the card, and
as the last line ``{"ok": true, "device": {...}}``. Exits non-zero,
printing no result, where no CUDA device is visible.
"""

from __future__ import annotations

import dataclasses
import io
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16 tensor cores
F32_FLOPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
BF16_TOL = 5e-2                  # paged vs dense logits, bfloat16
FLASH_BF16_TOL = 2e-2            # kernel vs plain, normalised L-inf, bf16
FLASH_F32_TOL = 1e-4             # kernel vs plain, atol = rtol, float32
GRAD_TOL = 2e-2                  # flash vs dense step grads, relative L2
TRAIN = dict(batch=4, seq=4096, heads=16, kv_heads=8, head_dim=128,
             stages=8, microbatches=1, dense_ffn=True, moe_mult=4,
             vocab=32768, rope=True, norm=True, use_flash=True,
             dtype="bfloat16")     # flagship_large, bench.py:545-550
TRAIN_STEPS = 4
TILE = 64                        # the flash kernels' q and k tile rows
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


def time_eager(fn, calls: int = 50, warm: int = 3) -> float:
    """ms per call issued from the host loop (launch cost included)."""
    for _ in range(warm):
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


def live_tile_pairs(tq: int, tk: int, q_off: int, k_off: int, causal: bool,
                    window) -> int:
    """(q tile, k tile) pairs the flash kernels compute for one row,
    from the kernels' own loop bounds (csrc/flash_attention.cu)."""
    n_q, n_k = -(-tq // TILE), -(-tk // TILE)
    pairs = 0
    for qt in range(n_q):
        lo, hi = 0, n_k - 1
        if causal:
            q_first = q_off + qt * TILE
            hi = min(hi, (q_first + TILE - 1 - k_off) // TILE)
            if window:
                lo = max(0, (q_first - (window - 1) - k_off) // TILE)
        pairs += max(0, hi - lo + 1)
    return pairs


def visible_pairs(tq: int, tk: int, q_off: int, k_off: int, causal: bool,
                  window) -> int:
    """(query, key) pairs of one row the function needs: every pair
    without ``causal``, else each query's keys at global positions
    ``(q_pos - window, q_pos]`` (``window`` None: all of ``<= q_pos``)
    that lie in ``[k_off, k_off + tk)``. Masked cells of the kernels'
    live tiles are not counted."""
    if not causal:
        return tq * tk
    rel = np.arange(tq, dtype=np.int64) + (q_off - k_off)  # q_pos - k_off
    hi = np.minimum(tk - 1, rel)
    lo = np.maximum(0, rel - window + 1) if window else 0
    return int(np.maximum(0, hi - lo + 1).sum())


def flash_bounds(q3, k3, q_off, k_off, causal, window, peak) -> dict:
    """Per kernel: (operations, bytes) the work needs and the bound in
    ms, the larger of operations over ``peak`` and bytes over the HBM
    rate. Operations: 2 per multiply-add over the visible (query, key)
    pairs of each product the function needs (forward S and PV; dk/dv
    S, dP, dV and dK; dq S, dP and dQ). Bytes: every input read once,
    every output written once."""
    bh, tq, d = q3.shape
    bhkv, tk, _ = k3.shape
    e = q3.element_size()
    mac = bh * visible_pairs(tq, tk, q_off, k_off, causal, window) * d
    qd, kd = bh * tq * d, bhkv * tk * d
    work = {
        "flash_fwd": (2 * 2 * mac,
                      e * (qd + 2 * kd) + 4 * 2 * qd + 4 * 4 * bh * tq),
        "flash_bwd_dkdv": (2 * 4 * mac,
                           e * (2 * qd + 2 * kd) + 4 * 2 * bh * tq
                           + 4 * 2 * kd),
        "flash_bwd_dq": (2 * 3 * mac,
                         e * (2 * qd + 2 * kd) + 4 * 2 * bh * tq + 4 * qd),
    }
    out = {}
    for name, (ops, nbytes) in work.items():
        t_ops, t_bytes = ops / peak, nbytes / HBM_BYTES_PER_S
        out[name] = {"ops": ops, "bytes": nbytes,
                     "bound_ms": max(t_ops, t_bytes) * 1e3,
                     "bound_by": "operations" if t_ops >= t_bytes
                     else "bytes"}
    return out


def by_batch(fn, batch: int, *args, **kw):
    """``fn`` over each batch element's rows, results concatenated: the
    plain versions at the full shape, one [16, 4096, 4096] float32 score
    block at a time instead of four."""
    outs = [fn(*(a.chunk(batch)[i] if isinstance(a, torch.Tensor) else a
                 for a in args), **kw) for i in range(batch)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def norm_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|."""
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


def flash_bf16_check(TFA, dev, gen, window) -> dict:
    """The three kernels at the training shape (bf16, causal, zero
    carry, offsets 0, ``window``) against their plain versions by batch
    element; raises past ``FLASH_BF16_TOL``. → the inputs, the
    normalised and absolute errors, and per kernel its kernel and plain
    calls."""
    b, hq, hkv, t, d = (TRAIN["batch"], TRAIN["heads"], TRAIN["kv_heads"],
                        TRAIN["seq"], TRAIN["head_dim"])
    bf = torch.bfloat16
    q3, do3 = (torch.randn((b * hq, t, d), generator=gen, device=dev).to(bf)
               for _ in range(2))
    k3, v3 = (torch.randn((b * hkv, t, d), generator=gen, device=dev).to(bf)
              for _ in range(2))
    carry = TFA.zero_carry(b * hq, t, d, dev)
    kw = dict(causal=True, q_heads=hq, window=window)
    got = TFA._flash_call(q3, k3, v3, *carry, **kw)
    want = by_batch(TFA._flash_call_plain, b, q3, k3, v3, *carry, 0, 0,
                    **kw)
    o, m, l = got
    L = m + torch.log(l)
    delta = (do3.float() * (o / l[..., None])).sum(-1)
    bargs = (q3, k3, v3, do3, L, delta, 0, 0)
    got += TFA._flash_bwd_dkdv(*bargs, **kw) + (TFA._flash_bwd_dq(*bargs,
                                                                 **kw),)
    want += by_batch(TFA._flash_bwd_dkdv_plain, b, *bargs, **kw) + (
        by_batch(TFA._flash_bwd_dq_plain, b, *bargs, **kw),)
    torch.cuda.synchronize()
    names = ("o", "m", "l", "dk", "dv", "dq")
    errs = {n: norm_err(g, w) for n, g, w in zip(names, got, want)}
    bad = {n: e for n, e in errs.items() if not e <= FLASH_BF16_TOL}
    if bad:
        raise AssertionError(f"flash kernels vs plain (window {window}): "
                             f"normalised L-inf {bad} > {FLASH_BF16_TOL}")
    abs_err = {n: (g - w).abs().max().item()
               for n, g, w in zip(names, got, want)}
    calls = {
        "flash_fwd": (lambda: TFA._flash_call(q3, k3, v3, *carry, **kw),
                      lambda: by_batch(TFA._flash_call_plain, b, q3, k3, v3,
                                       *carry, 0, 0, **kw)),
        "flash_bwd_dkdv": (lambda: TFA._flash_bwd_dkdv(*bargs, **kw),
                           lambda: by_batch(TFA._flash_bwd_dkdv_plain, b,
                                            *bargs, **kw)),
        "flash_bwd_dq": (lambda: TFA._flash_bwd_dq(*bargs, **kw),
                         lambda: by_batch(TFA._flash_bwd_dq_plain, b,
                                          *bargs, **kw)),
    }
    return {"q3": q3, "k3": k3, "v3": v3, "do3": do3, "errs": errs,
            "calls": calls,
            "abs_err": {"flash_fwd": abs_err["o"],
                        "flash_bwd_dkdv": max(abs_err["dk"], abs_err["dv"]),
                        "flash_bwd_dq": abs_err["dq"]},
            "bounds": flash_bounds(q3, k3, 0, 0, True, window,
                                   BF16_FLOPS_PER_S)}


def flash_train_shape(TFA, dev, gen, card) -> list:
    """The causal training-shape check, each kernel timed beside its
    bound, its plain version and SDPA; → one result dict per kernel."""
    b, hq, hkv, t, d = (TRAIN["batch"], TRAIN["heads"], TRAIN["kv_heads"],
                        TRAIN["seq"], TRAIN["head_dim"])
    c = flash_bf16_check(TFA, dev, gen, None)
    # One PyTorch call for the same functions: SDPA, causal, GQA.
    q4, k4, v4, do4 = (c[x].view(b, -1, t, d)
                       for x in ("q3", "k3", "v3", "do3"))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_fwd = time_eager(lambda: sdpa(q4, k4, v4, is_causal=True,
                                      enable_gqa=True), calls=10)
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q4, k4, v4))

    def sdpa_fwd_bwd():
        out = sdpa(qg, kg, vg, is_causal=True, enable_gqa=True)
        torch.autograd.grad(out, (qg, kg, vg), do4)

    lib_fb = time_eager(sdpa_fwd_bwd, calls=10)
    replaces = {
        "flash_fwd": "tpu_p2p/ops/flash_attention.py:101 (_kernel) and "
                     ":208 (_kernel_flat)",
        "flash_bwd_dkdv": "tpu_p2p/ops/flash_attention.py:717 "
                          "(_bwd_dkdv_kernel)",
        "flash_bwd_dq": "tpu_p2p/ops/flash_attention.py:826 "
                        "(_bwd_dq_kernel) and :693 (_dq_reduce_kernel)",
    }
    rows = []
    for name, (fn, plain) in c["calls"].items():
        ms = time_eager(fn, calls=10, warm=2)
        plain_ms = time_eager(plain, calls=2, warm=1)
        lib = lib_fwd if name == "flash_fwd" else lib_fb
        bd = c["bounds"][name]
        rows.append({
            "name": name, "route": "cuda",
            "source": "tpu_p2p_torch/csrc/flash_attention.cu",
            "replaces": replaces[name], "max_abs_err": c["abs_err"][name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bd["bound_ms"],
            "bound_by": bd["bound_by"], "library_ms": lib,
        })
        say(f"kernel {name} @ B{b} H{hq}/{hkv} T{t} D{d} bf16 causal: "
            f"normalised L-inf vs plain {c['errs']} (tol {FLASH_BF16_TOL}) "
            f"| {ms:.3f} ms vs bound {bd['bound_ms']:.3f} ms "
            f"({bd['bound_by']}: {bd['ops'] / 1e12:.3f} TFLOP, "
            f"{bd['bytes'] / 1e9:.3f} GB; "
            f"{bd['ops'] / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, "
            f"SDPA {'fwd' if name == 'flash_fwd' else 'fwd+bwd'} "
            f"{lib:.3f} ms | {card}")
    return rows


def flash_train_windowed(TFA, dev, gen, card) -> None:
    """The training-shape check with ``--attn-window 1024`` (the banded
    sweep), each kernel timed beside its live-tile bound."""
    window, t = 1024, TRAIN["seq"]
    c = flash_bf16_check(TFA, dev, gen, window)
    times = {n: time_eager(fn, calls=10) for n, (fn, _) in c["calls"].items()}
    bounds = c["bounds"]
    say(f"flash bf16 @ B{TRAIN['batch']} H{TRAIN['heads']}/"
        f"{TRAIN['kv_heads']} T{t} D{TRAIN['head_dim']} window {window}: "
        f"normalised L-inf vs plain {c['errs']} (tol {FLASH_BF16_TOL}) | "
        f"{live_tile_pairs(t, t, 0, 0, True, window)} live tile pairs, "
        f"{visible_pairs(t, t, 0, 0, True, window)} visible (query, key) "
        f"pairs a row (causal: {live_tile_pairs(t, t, 0, 0, True, None)}, "
        f"{visible_pairs(t, t, 0, 0, True, None)}) | ms "
        + ", ".join(f"{n} {times[n]:.3f} (bound {bounds[n]['bound_ms']:.3f}"
                    f" {bounds[n]['bound_by']})" for n in times)
        + f" | {card}")


def flash_f32_window(TFA, dev, gen, card) -> None:
    """The three kernels in float32 at T 512, window 96 (not a tile
    multiple), q_off != k_off and a random incoming carry, against their
    plain versions at atol = rtol = FLASH_F32_TOL."""
    b, hq, hkv, t, d = 2, TRAIN["heads"], TRAIN["kv_heads"], 512, 128
    q_off, k_off, window = 300, 250, 96
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    q3, do3, o0 = rnd(b * hq, t, d), rnd(b * hq, t, d), rnd(b * hq, t, d)
    k3, v3 = rnd(b * hkv, t, d), rnd(b * hkv, t, d)
    m0 = rnd(b * hq, t)
    l0 = torch.rand((b * hq, t), generator=gen, device=dev)
    kw = dict(causal=True, q_heads=hq, window=window)
    fargs = (q3, k3, v3, o0, m0, l0, q_off, k_off)
    got = TFA._flash_call(*fargs, **kw)
    want = TFA._flash_call_plain(*fargs, **kw)
    o, m, l = want
    L = torch.where(l > 0, m + torch.log(torch.where(l > 0, l, 1.0)), 1e30)
    delta = rnd(b * hq, t)
    bargs = (q3, k3, v3, do3, L, delta, q_off, k_off)
    got += TFA._flash_bwd_dkdv(*bargs, **kw) + (TFA._flash_bwd_dq(*bargs,
                                                                 **kw),)
    want += TFA._flash_bwd_dkdv_plain(*bargs, **kw) + (
        TFA._flash_bwd_dq_plain(*bargs, **kw),)
    torch.cuda.synchronize()
    errs = {}
    for name, g, w in zip(("o", "m", "l", "dk", "dv", "dq"), got, want):
        torch.testing.assert_close(g, w, atol=FLASH_F32_TOL,
                                   rtol=FLASH_F32_TOL, msg=name)
        errs[name] = (g - w).abs().max().item()
    bounds = flash_bounds(q3, k3, q_off, k_off, True, window,
                          F32_FLOPS_PER_S)
    times = {
        "flash_fwd": time_eager(lambda: TFA._flash_call(*fargs, **kw)),
        "flash_bwd_dkdv": time_eager(
            lambda: TFA._flash_bwd_dkdv(*bargs, **kw)),
        "flash_bwd_dq": time_eager(lambda: TFA._flash_bwd_dq(*bargs, **kw)),
    }
    say(f"flash f32 @ B{b} H{hq}/{hkv} T{t} D{d} window {window} q_off "
        f"{q_off} k_off {k_off}, random carry: max abs err vs plain "
        f"{errs} (atol = rtol = {FLASH_F32_TOL}) | ms "
        + ", ".join(f"{n} {times[n]:.4f} (bound {bounds[n]['bound_ms']:.4f}"
                    f" {bounds[n]['bound_by']})" for n in times)
        + f" | {card}")


# ------------------------------------------------------------ phase 5


def run_train(cfg, steps: int, TFA, dev) -> dict:
    """``run_training`` with a record every step; → records, launches,
    per-step ms (from the records' wall clock, each read after the
    step's loss reached the host) and peak memory."""
    from tpu_p2p_torch.train import run_training

    buf = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    TFA.reset_launches()
    out = run_training(cfg, steps=steps, lr=1e-2, seed=0, log_every=1,
                       log_stream=buf, device=dev)
    torch.cuda.synchronize()
    launches = dict(TFA.launches)
    recs = [json.loads(s) for s in buf.getvalue().splitlines()]
    walls = [0.0] + [r["wall_s"] for r in recs]
    del out
    return {"recs": recs, "launches": launches,
            "losses": [r["loss"] for r in recs],
            "step_ms": [1e3 * (b - a) for a, b in zip(walls, walls[1:])],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def check_train_run(run: dict, cfg, steps: int) -> None:
    losses = run["losses"]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train losses {losses}")
    want = steps * cfg.stages * cfg.microbatches
    if any(n != want for n in run["launches"].values()):
        raise AssertionError(f"flash launches {run['launches']} over "
                             f"{steps} steps, expected {want} of each "
                             "(once per block per microbatch per step)")


def train(TFA, dev, card) -> dict:
    from tpu_p2p_torch.models.flagship import FlagshipConfig

    cfg = FlagshipConfig(**TRAIN)
    run = run_train(cfg, TRAIN_STEPS, TFA, dev)
    check_train_run(run, cfg, TRAIN_STEPS)
    ln_v = math.log(cfg.vocab)
    if not ln_v - 1 <= run["losses"][0] <= ln_v + 2:
        raise AssertionError(f"first loss {run['losses'][0]} outside "
                             f"[ln V - 1, ln V + 2] = [{ln_v - 1}, "
                             f"{ln_v + 2}]")
    p50 = statistics.median(run["step_ms"][1:])
    tokens = cfg.batch * cfg.seq
    say(f"train flagship_large (B{cfg.batch} T{cfg.seq}, {cfg.stages} "
        f"blocks, bf16, flash, SGD lr 1e-2, seed 0): losses "
        f"{run['losses']} | step ms {[round(x) for x in run['step_ms']]}, "
        f"p50 of steps 2-{TRAIN_STEPS} {p50:.0f} ms = "
        f"{tokens / p50 * 1e3:.0f} tokens/s | peak memory "
        f"{run['peak_gib']:.2f} GiB | flash launches {run['launches']} | "
        f"{card}")
    return {"launches": run["launches"], "step_ms_p50": p50}


def grads_vs_dense(dev, card) -> None:
    """One step's gradients through the kernels against dense attention
    from the same params and batch, at batch 1: the dense path saves a
    float32 [16, 4096, 4096] score block per block, which at batch 4
    over 8 blocks exceeds the card."""
    from tpu_p2p_torch.models.flagship import (
        FlagshipConfig, flagship_token_batch, init_flagship_params,
        make_flagship_lm_grad_fn)

    cfg = FlagshipConfig(**{**TRAIN, "batch": 1})
    params = init_flagship_params(cfg, seed=0, device=dev)
    toks, tgts = flagship_token_batch(cfg, seed=1, device=dev)
    g_f, l_f = make_flagship_lm_grad_fn(cfg)(params, toks, tgts)
    g_d, l_d = make_flagship_lm_grad_fn(
        dataclasses.replace(cfg, use_flash=False))(params, toks, tgts)
    torch.cuda.synchronize()
    rel = {k: ((g_f[k].float() - g_d[k].float()).norm()
               / g_d[k].float().norm().clamp_min(1e-30)).item()
           for k in g_d}
    worst = max(rel, key=rel.get)
    if not rel[worst] <= GRAD_TOL:
        raise AssertionError(f"flash vs dense grads: relative L2 {rel} > "
                             f"{GRAD_TOL}")
    say(f"grads flash vs dense @ B1 T{cfg.seq} (cut from B{TRAIN['batch']}"
        f" for the dense path's memory): summed CE {l_f.item():.4f} vs "
        f"{l_d.item():.4f}; per-leaf relative L2 max {rel[worst]:.2e} "
        f"({worst}), tol {GRAD_TOL}: "
        + ", ".join(f"{k} {v:.1e}" for k, v in sorted(rel.items()))
        + f" | {card}")


def train_windowed(TFA, dev, card) -> None:
    """The windowed kernels through the entry point: window 1024 at 2
    blocks, 2 steps."""
    from tpu_p2p_torch.models.flagship import FlagshipConfig

    cfg = FlagshipConfig(**{**TRAIN, "stages": 2, "attn_window": 1024})
    run = run_train(cfg, 2, TFA, dev)
    check_train_run(run, cfg, 2)
    say(f"train windowed (window 1024, 2 blocks, B{cfg.batch} T{cfg.seq}):"
        f" losses {run['losses']} | step ms "
        f"{[round(x) for x in run['step_ms']]} | flash launches "
        f"{run['launches']} | {card}")


KERNEL_FAMILIES = (
    ("flash", ("flash_fwd_kernel", "flash_bwd_")),
    ("gemm", ("gemm", "Gemm", "nvjet", "xmma", "cutlass", "cublas")),
    ("copy/cast", ("copy", "Copy", "Memcpy", "Memset", "cast", "Cat")),
    ("reduce", ("reduce", "Reduce", "softmax", "norm")),
    ("elementwise", ("elementwise", "Elementwise", "vectorized")),
)


def profile_step(dev, card) -> None:
    """One flagship_large train step under ``torch.profiler``: device
    time by kernel family and the device's idle share of the step's
    wall time (kernels of one stream do not overlap, so their summed
    time is the busy time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpu_p2p_torch.models.flagship import (
        FlagshipConfig, flagship_token_batch, init_flagship_params,
        make_flagship_lm_train_step)

    cfg = FlagshipConfig(**TRAIN)
    params = init_flagship_params(cfg, seed=0, device=dev)
    toks, tgts = flagship_token_batch(cfg, seed=1, device=dev)
    step = make_flagship_lm_train_step(cfg, lr=1e-2, donate=True)
    step(params, toks, tgts)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, toks, tgts)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fam_ms, by_name, count = {}, {}, 0
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        ms = ev.time_range.elapsed_us() / 1e3
        count += 1
        family = next((f for f, keys in KERNEL_FAMILIES
                       if any(k in ev.name for k in keys)), "other")
        fam_ms[family] = fam_ms.get(family, 0.0) + ms
        by_name[ev.name] = by_name.get(ev.name, 0.0) + ms
    busy = sum(fam_ms.values())
    if not count:
        raise AssertionError("the profiler recorded no device activity")
    say(f"profile one train step (flagship_large): wall {wall_ms:.1f} ms, "
        f"device busy {busy:.1f} ms over {count} device events, idle share "
        f"{1 - busy / wall_ms:.3f} | by family (ms): "
        + ", ".join(f"{f} {v:.1f}" for f, v in
                    sorted(fam_ms.items(), key=lambda kv: -kv[1]))
        + f" | {card}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        say(f"  {ms:9.2f} ms  {name[:110]}")


# ------------------------------------------------------------ phase 6


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


# ------------------------------------------------------------ phase 7


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


# ------------------------------------------------------------ phase 8

P2P_MSG, P2P_ITERS = 32 << 20, 128      # the reference's defaults
P2P4_MSG, P2P4_ITERS = 4 << 20, 16      # the 4-rank world, cut
HOP_CHAIN = 64                          # hops per timed fused chain
NVLINK_BYTES_PER_S = 450e9              # H100 NVLink, each way
EDGE_SETS_8 = {                         # tests/test_pallas_dma.py:101
    "ring": tuple((i, (i + 1) % 8) for i in range(8)),
    "shift3": tuple((i, (i + 3) % 8) for i in range(8)),
    "unidir": ((2, 5),),
    "bidir": ((1, 6), (6, 1)),
    "partial": ((0, 1), (3, 2), (6, 4)),
    "empty": (),
}


def cut_edges(edges, n):
    """``edges`` on a world of ``n``: ranks mod ``n``, an edge kept only
    while its source and destination are still unused."""
    out, srcs, dsts = [], set(), set()
    for s, d in edges:
        s, d = s % n, d % n
        if s not in srcs and d not in dsts:
            out.append((s, d))
            srcs.add(s)
            dsts.add(d)
    return tuple(out)


def pairwise_launches(n: int, rank: int, cfg) -> int:
    """Kernel launches one rank makes in a serialized pairwise run: per
    measured cell the warm-up, ``iters`` and the ``--check`` hop, on
    every rank (full isolation) or on the pair's two ranks (submesh)."""
    per_cell = cfg.warmup + cfg.iters + int(cfg.check)
    dirs = {"uni": 1, "bi": 1, "both": 2}[cfg.direction]
    cells = sum(1 for s in range(n) for d in range(n) if s != d
                and (cfg.isolation == "full" or rank in (s, d)))
    return dirs * len(cfg.sizes()) * cells * per_cell


def latency_launches(cfg) -> int:
    """Launches of the latency workload on a pair in full isolation:
    the serialized loop and the fused chains (warm-up and repeats)."""
    warm = max(1, cfg.warmup)
    return warm + cfg.iters + (warm + cfg.fused_repeats) * cfg.iters


def p2p_kernel_checks(rt, sizes) -> dict:
    """The kernel against its plain version on ``.cpu()`` copies (gloo)
    and against ``expected_permute``, bitwise, over the six edge sets cut
    to the world: int8 at ``sizes``, a float32 [5, 3] row, and one
    backward pass against the reverse permute."""
    from tpu_p2p_torch.parallel import collectives as C
    from tpu_p2p_torch.parallel import pallas_dma as PD

    mesh, dev = rt.mesh, rt.device
    bad, worst, made = [], 0.0, 0
    rng = np.random.default_rng(0)
    xf_all = rng.standard_normal((rt.world, 5, 3)).astype(np.float32)
    gf_all = rng.standard_normal((rt.world, 5, 3)).astype(np.float32)
    for name, edges in ((k, cut_edges(e, rt.world))
                        for k, e in EDGE_SETS_8.items()):
        for nbytes in sizes:
            x = C.make_payload(mesh, nbytes, np.int8)
            got = C.dma_ppermute(x, mesh, edges).cpu()
            made += 1
            plain = PD._dma_ppermute_plain(x.cpu(), mesh, edges)
            want = C.expected_permute(C.host_payload(mesh, nbytes), edges)
            worst = max(worst, (got.int() - plain.int()).abs().max().item())
            if not (torch.equal(got, plain) and np.array_equal(
                    got.numpy(), want[rt.rank:rt.rank + 1])):
                bad.append(f"{name} {nbytes} B")
        xf = torch.from_numpy(xf_all[rt.rank]).to(dev).requires_grad_(True)
        gf = torch.from_numpy(gf_all[rt.rank])
        y = C.dma_ppermute(xf, mesh, edges)
        y.backward(gf.to(dev))
        made += 2
        rev = tuple((d, s) for s, d in edges)
        want_y = C.expected_permute(xf_all, edges)[rt.rank]
        want_g = C.expected_permute(gf_all, rev)[rt.rank]
        plain_y = PD._dma_ppermute_plain(xf.detach().cpu(), mesh, edges)
        worst = max(worst, (y.detach().cpu() - plain_y).abs().max().item())
        if not (torch.equal(y.detach().cpu(), plain_y)
                and np.array_equal(y.detach().cpu().numpy(), want_y)
                and np.array_equal(xf.grad.cpu().numpy(), want_g)):
            bad.append(f"{name} float32 [5, 3] + backward")
    return {"bad": bad, "max_abs_err": worst, "launches": made}


def p2p_timing(rt) -> dict:
    """At 32 MiB on the shared card: the kernel's per-hop time (median
    over 5 fused chains of ``HOP_CHAIN`` ring hops, CUDA events on each
    rank), the plain version's (host clock, gloo on ``.cpu()`` copies)
    and one ``copy_`` of 32 MiB on the card (rank 0 alone)."""
    from tpu_p2p_torch.parallel import collectives as C
    from tpu_p2p_torch.parallel import pallas_dma as PD

    mesh = rt.mesh
    ring = C.ring_edges(rt.world)
    x = C.make_payload(mesh, P2P_MSG, np.int8)
    chain = C.CollectiveCache().dma_permute_chain(mesh, "d", ring, HOP_CHAIN)
    chain(x)
    hops = []
    for _ in range(5):
        rt.barrier()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        chain(x)
        t1.record()
        t1.synchronize()
        hops.append(t0.elapsed_time(t1) / HOP_CHAIN)
    rt.barrier()
    xc, plain = x.cpu(), []
    for _ in range(3):
        rt.barrier()
        t = time.perf_counter()
        PD._dma_ppermute_plain(xc, mesh, ring)
        plain.append((time.perf_counter() - t) * 1e3)
    library = None
    if rt.rank == 0:
        dst = torch.empty_like(x)
        library = time_eager(lambda: dst.copy_(x), calls=50)
    rt.barrier()
    return {"hop_ms": statistics.median(hops), "hop_ms_all": hops,
            "plain_ms": statistics.median(plain), "library_ms": library}


def p2p_rank_case(msg: int, iters: int, isolations, latency: bool,
                  sizes, timing: bool) -> dict:
    """One rank of a world that shares cuda:0 (every rank
    ``make_runtime(device="cuda:0")``), then what ``cli.main`` runs after
    it builds the runtime: ``pairwise --transport pallas_dma --check`` in
    each isolation (and ``latency --transport pallas_dma``), launches
    counted; then the kernel checks and, on request, the timing."""
    from tpu_p2p_torch.cli import run_benchmark
    from tpu_p2p_torch.config import BenchConfig
    from tpu_p2p_torch.parallel import pallas_dma as PD
    from tpu_p2p_torch.parallel.runtime import make_runtime

    rt = make_runtime(device="cuda:0")
    out = {"rank": rt.rank, "world": rt.world}
    rt.barrier()
    PD.reset_launches()
    t0 = time.perf_counter()
    expected = 0
    for iso in isolations:
        cfg = BenchConfig(pattern="pairwise", msg_size=msg, iters=iters,
                          transport="pallas_dma", check=True, isolation=iso)
        run_benchmark(rt, cfg)
        expected += pairwise_launches(rt.world, rt.rank, cfg)
    if latency:
        cfg = BenchConfig(pattern="latency", transport="pallas_dma")
        run_benchmark(rt, cfg)
        expected += latency_launches(cfg)
    rt.barrier()
    out.update(launches=PD.launches["dma_permute"],
               expected_launches=expected,
               main_path_s=time.perf_counter() - t0)
    PD.reset_launches()
    out["checks"] = p2p_kernel_checks(rt, sizes)
    rt.barrier()
    out["checks"]["counted"] = PD.launches["dma_permute"]
    if timing:
        out["timing"] = p2p_timing(rt)
    rt.close()
    return out


def p2p_world(n: int, card: str, **kw) -> list:
    """Spawn a world of ``n`` ranks on cuda:0 running
    :func:`p2p_rank_case`; raise on any failed rank, launch mismatch or
    kernel disagreement."""
    from tpu_p2p_torch.parallel.launch import run_world

    t0 = time.perf_counter()
    res = run_world(n, f"{__file__}:p2p_rank_case", kw, timeout=450)
    for r in res:
        if r["launches"] != r["expected_launches"]:
            raise AssertionError(
                f"world of {n}, rank {r['rank']}: dma_permute launched "
                f"{r['launches']} times on the main path, expected "
                f"{r['expected_launches']}")
        c = r["checks"]
        if c["bad"] or c["counted"] != c["launches"]:
            raise AssertionError(
                f"world of {n}, rank {r['rank']}: kernel vs plain/oracle "
                f"failed for {c['bad']}; launches {c['counted']} vs "
                f"{c['launches']} made")
    say(f"p2p world of {n} on cuda:0 ({', '.join(kw['isolations'])} "
        f"isolation, {kw['msg']} B x {kw['iters']}, pallas_dma, --check"
        f"{', latency' if kw['latency'] else ''}): main path "
        f"{res[0]['main_path_s']:.1f} s, dma_permute launches per rank "
        f"{[r['launches'] for r in res]} (= expected); kernel == plain "
        f"(gloo) == expected_permute bitwise over 6 edge sets at "
        f"{list(kw['sizes'])} B int8 + float32 [5, 3] + backward, "
        f"{res[0]['checks']['launches']} launches a rank | world "
        f"{time.perf_counter() - t0:.1f} s | {card}")
    return res


def p2p_self_edge() -> dict:
    """The kernel with no peer: a world of 1 on cuda:0 pushing 32 MiB
    into its own window over the self-edge, so no context ever waits for
    another. → ms per hop of a fused chain (median of 5 chains of
    ``HOP_CHAIN``, CUDA events), the host's enqueue time per hop over that
    chain, and the kernel's own device time (median over one chain under
    ``torch.profiler``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpu_p2p_torch.parallel import collectives as C
    from tpu_p2p_torch.parallel.runtime import make_runtime

    rt = make_runtime(device="cuda:0")
    x = C.make_payload(rt.mesh, P2P_MSG, np.int8)
    chain = C.CollectiveCache().dma_permute_chain(rt.mesh, "d", ((0, 0),),
                                                  HOP_CHAIN)
    if not torch.equal(chain(x), x):
        raise AssertionError("self-edge chain changed the payload")
    hops, enqueue = [], []
    for _ in range(5):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        t = time.perf_counter()
        chain(x)
        enqueue.append((time.perf_counter() - t) * 1e3 / HOP_CHAIN)
        t1.record()
        t1.synchronize()
        hops.append(t0.elapsed_time(t1) / HOP_CHAIN)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        chain(x)
        torch.cuda.synchronize()
    kernel = [ev.time_range.elapsed_us() / 1e3 for ev in prof.events()
              if ev.device_type == DeviceType.CUDA
              and "dma_permute_kernel" in ev.name]
    if not kernel:
        raise AssertionError("the profiler recorded no self-edge kernel")
    rt.close()
    return {"chain_ms": statistics.median(hops),
            "enqueue_ms": statistics.median(enqueue),
            "kernel_ms": statistics.median(kernel), "profiled": len(kernel)}


def p2p(card: str) -> dict:
    """The reference program on the card: a world of 1 through
    ``cli.main`` (defaults, then ``--pattern latency``), then worlds of 2
    and 4 ranks sharing cuda:0 through the peer-push kernel."""
    from tpu_p2p_torch import cli

    for argv in ([], ["--pattern", "latency"]):
        rc = cli.main(argv)
        if rc:
            raise AssertionError(f"python -m tpu_p2p_torch {argv} "
                                 f"exited {rc}")
    alone = p2p_self_edge()
    w2 = p2p_world(2, card, msg=P2P_MSG, iters=P2P_ITERS,
                   isolations=("full",), latency=True,
                   sizes=(136, P2P_MSG), timing=True)
    w4 = p2p_world(4, card, msg=P2P4_MSG, iters=P2P4_ITERS,
                   isolations=("full", "submesh"), latency=False,
                   sizes=(136, P2P4_MSG), timing=False)
    tm = w2[0]["timing"]
    bound = 2 * P2P_MSG / HBM_BYTES_PER_S * 1e3
    say(f"kernel dma_permute @ 32 MiB int8, 2 ranks on one card: per hop "
        f"{tm['hop_ms']:.4f} ms (median of 5 fused chains of {HOP_CHAIN} "
        f"ring hops, rank 0; all {[round(v, 4) for v in tm['hop_ms_all']]};"
        f" rank 1 median {w2[1]['timing']['hop_ms']:.4f}) vs bound "
        f"{bound:.4f} ms (read + write 32 MiB at 3.35 TB/s; over NVLink "
        f"it would be {P2P_MSG / NVLINK_BYTES_PER_S * 1e3:.4f} ms at 450 "
        f"GB/s), plain {tm['plain_ms']:.3f} ms (gloo, host memory), "
        f"copy_ {tm['library_ms']:.4f} ms (NCCL send/recv cannot form "
        f"between ranks on one card) | time-sliced contexts, not a link "
        f"number; the kernel alone (self-edge, world of 1, no peer): "
        f"{alone['chain_ms']:.4f} ms a hop of a fused chain, host enqueue "
        f"{alone['enqueue_ms']:.4f} ms a hop, kernel device time "
        f"{alone['kernel_ms']:.4f} ms (profiler, median of the "
        f"{alone['profiled']} kernels it recorded of {HOP_CHAIN}) | {card}")
    return {
        "name": "dma_permute", "route": "cuda",
        "source": "tpu_p2p_torch/csrc/p2p_dma.cu",
        "replaces": "tpu_p2p/parallel/pallas_dma.py:146 "
                    "(_dma_transport_permute_call; kernel body :166)",
        "launches": w2[0]["launches"],
        "max_abs_err": max(r["checks"]["max_abs_err"] for r in w2 + w4),
        "ms": tm["hop_ms"], "plain_ms": tm["plain_ms"], "bound_ms": bound,
        "bound_by": "bytes", "library_ms": tm["library_ms"],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this smoke runs on an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    from tpu_p2p_torch.models.flagship import (
        FlagshipConfig, init_flagship_params)
    from tpu_p2p_torch.ops import flash_attention as TFA
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
    for src, info in cuda_build.build(["kvcache", "flash_attention",
                                       "p2p_dma"]).items():
        say(f"build {src}: {info['cmd'] or 'up to date: ' + str(info['path'])}"
            f" ({info['seconds']:.2f} s)")
    say(f"build: {time.perf_counter() - t0:.2f} s wall, all sources at once")

    gen = torch.Generator(device=dev).manual_seed(0)
    kernels = [kernel_paged(TK, dev, gen), kernel_cache_row(TK, dev, gen)]
    for k in kernels:
        say(f"kernel {k['name']}: bitwise == plain | {k['ms']:.5f} ms "
            f"(graph replay) vs bound {k['bound_ms']:.5f} ms, plain "
            f"{k['plain_ms']:.5f} ms, index_put_ {k['library_ms']:.5f} ms, "
            f"host loop {k['host_loop_ms']:.5f} ms | {card}")

    kernels += flash_train_shape(TFA, dev, gen, card)
    torch.cuda.empty_cache()
    flash_train_windowed(TFA, dev, gen, card)
    flash_f32_window(TFA, dev, gen, card)
    torch.cuda.empty_cache()

    trn = train(TFA, dev, card)
    torch.cuda.empty_cache()
    grads_vs_dense(dev, card)
    torch.cuda.empty_cache()
    train_windowed(TFA, dev, card)
    torch.cuda.empty_cache()
    profile_step(dev, card)
    torch.cuda.empty_cache()

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
    del params
    torch.cuda.empty_cache()
    kernels.append(p2p(card))
    launches = {"cache_row_write": dec["launches"]["cache_row_write"],
                "paged_rows_write": srv["launches"]["paged_rows_write"],
                "dma_permute": kernels[-1]["launches"], **trn["launches"]}
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
