#!/usr/bin/env python3
"""On-card smoke of the PyTorch port: ``python3 chip_smoke.py``.

Drives the port's serving and training paths on one NVIDIA GPU at the
full width of the repo's production LM (436 M parameters, Dm 2048, 16
heads x 128 with GQA 2:1, 8 blocks, dense 4x FFN, vocab 32768,
bfloat16; and its MoE twin, 4 experts as wide as that FFN), then the reference program (the all-pairs P2P matrix and the
8 B latency line) on worlds of ranks that share the card, and fails on
the first phase that goes wrong:

1. device   — card name and count, ``nvidia-smi`` name and power limit;
2. build    — ``nvcc`` builds the KV-cache, flash-attention and
   peer-push kernels from ``csrc/``, one compiler per source, all
   started together; ``cuobjdump`` reads the flash library back: the
   bf16 tensor-core kernels (forward, dK/dV, dq) must hold HGMMA (wgmma)
   instructions at every head dim and no bf16 SIMT flash kernel may be
   left; their registers, spills, shared memory and CTAs an SM are
   printed, and the four peer-push kernels' registers, spills and
   shared memory;
3. kernels  — the KV-cache write kernel at the serving shapes, K and V
   in one launch from the projections as the mixed step and the decode
   step make them, against its plain PyTorch version, bitwise (it
   copies), and its single-destination forms (a band image, one slab)
   likewise; timed on graph replay beside its bytes bound, an empty
   kernel over the same grid (the launch floor), the plain version, two
   ``index_put_`` calls and the wrapper's host loop;
4. flash    — the three flash kernels against their plain versions at
   the training shape (B 4, 16 heads over 8 KV heads, T 4096, D 128,
   bf16, causal; normalised L-inf <= 2e-2; all three bf16 kernels on
   the tensor cores; two dq launches bitwise equal), there with a
   window of 1024 (the banded sweep, beside the live blocks each kernel
   loops over), on ragged bf16 edge cases (D 32/64/128, GQA 1/2/4,
   offsets, fully masked rows with an exact-zero dq, a random carry; two
   launches bitwise equal), and at T 512 in float32 (the SIMT kernels)
   with a window of 96, q_off != k_off and a random carry (atol = rtol
   = 1e-4), each timed beside its bound, its plain version and SDPA;
5. train    — ``run_training`` at the full width and depth (B 4 x T
   4096, SGD lr 1e-2, 4 steps, seed 0): finite losses, the first near
   ln(vocab), every flash kernel launched once per block per step; then
   one step's gradients through the kernels against dense attention (at
   batch 1), 2 windowed steps (window 1024, 2 blocks), and one step
   under ``torch.profiler`` (kernel time by family, device idle share);
6. decode   — teacher-forced paged logits (chunk 1) against the dense
   KV-cached decode step, which writes through ``cache_kv_write``, each
   step launching its fused write once per block;
7. serve    — ``run_engine`` over a serve mesh of one rank on a seeded
   16-request trace in continuous
   and static batching: every request finishes, step counts equal the
   dry ``simulate_schedule``, the page pool drains full, both batching
   modes emit the same tokens, and the fused paged write ran once on
   every busy step of every block (K and V together) and nothing else;
8. p2p      — ``python -m tpu_p2p_torch`` through ``cli.main`` on a world
   of 1 (defaults: the 1x1 uni/bi matrices at 32 MiB; then the latency
   line, the self-edge floor; ``ring``, ``all_to_all``, ``allreduce``,
   ``reduce_scatter`` and ``all_gather --check`` at 32 MiB x 16 over a
   one-rank NCCL communicator; ``--mode device`` on ``latency`` and
   ``all_gather``, published from the card's clock, and on
   ``allreduce``, which must refuse: an in-place sum over one rank puts
   nothing on the card; ``--validate-timing`` on the 32 MiB loopback,
   which must say OK; ``--profile-dir``, whose trace must hold kernels);
   the card's clock read two ways on the same chains (the profiler's
   busy-time slope that ``--mode device`` publishes against CUDA-graph
   replays timed by events, within 25 %); a world of 2 ranks sharing
   cuda:0 (``make_runtime(device="cuda:0")`` each, then what
   ``cli.main`` runs) with ``pairwise --transport pallas_dma --check``
   at the reference's 32 MiB x 128 iterations, ``latency --transport
   pallas_dma``, and ``ring --transport pallas_dma`` at 32 MiB x 16
   with ``--check`` and in ``--mode device``; a world of 4 at 4 MiB x 16
   in full and submesh isolation and ``ring --check``; in both, an
   ``allreduce`` must raise ``BackendError`` before any traffic (NCCL
   needs a card a rank); a world of 4 laid out 2x2 with ``torus2d
   --transport pallas_dma --check`` at 4 MiB x 16, each axis line with
   its own windows, all closed at the end. The peer-push kernel's
   launches on those runs must equal the count the workloads make; its
   arrivals must equal the plain version's (gloo, on ``.cpu()`` copies)
   and ``expected_permute`` bitwise over six edge sets at 136 B and the
   run's size in int8, a float32 [5, 3] row and one backward pass, and
   on the 2x2 mesh's per-axis rings; then its per-hop time at 32 MiB
   beside its bound, the plain version and one ``copy_``. Ranks sharing
   a card run as time-sliced CUDA contexts, so these are not link
   numbers; the kernel alone (a world of 1, the 32 MiB self-edge, stored
   straight into the output) beside one ``copy_`` of the same bytes,
   both device time;
9. disagg   — ``run_disagg_engine`` (what ``serve --disagg`` runs) at the
   full width on two in-process ranks sharing cuda:0 (prefill, decode),
   phase 7's trace, 32 decode + 4 prefill slots, ``--transport
   pallas_dma --migrate-chunks 4``: every request finishes, steps and
   migrations equal ``simulate_disagg_schedule``, both pools drain full,
   ``dma_ship`` and ``dma_permute`` launched exactly migrations x 2
   tensors x ranks x (chunks - 1) and x 1 times; its streams equal the
   same run over the library copy, and a run with 32 prefill slots (the
   colocated batch width) equals phase 7's continuous streams; every
   token of the 32 + 4 run and of phase 7's streams is teacher-forced
   through the dense decode step, and its dense logit must lie within
   2 x 5e-2 of the dense maximum (phase 6 holds the paged step to 5e-2
   of it), which is what a 4-slot prefill batch's other float32 GEMM
   rounding may change and a batcher or migration fault would not keep
   to; then 1 prefill + 3 decode ranks at 2 blocks (dummy edges, shard
   choice).
   The fused-ship kernel against its plain version and
   ``expected_permute`` on 2 and 4 in-process ranks, bitwise, and its
   time beside a token-chunk GEMM: ship alone, compute alone, fused,
   and their overlap; then, in a process of its own, one ship alone
   and one fused under ``torch.profiler``, split into push, arrival,
   spin and idle time.
   In-process ranks run concurrently on the card, so the migration Gbps
   are on-card copies, not link numbers;
10. mesh    — (run right after phase 5) the training step's
   sequence-parallel ring on one card:
   every rank of rings of 2 and 4 (T_local 2048 and 1024 of phase 4's
   shape), each rank's forward folds and backward steps through
   ``ring_flash``'s per-hop functions in this process, each hop's block
   handed to the next rank's call, contiguous and zigzag, causal, with
   and without a window of 1024: the assembled output and dq/dk/dv
   (un-permuted from zigzag) within 2e-2 (normalised L-inf) of the
   full-sequence flash kernels and of the plain versions of the same hop
   calls, and each kernel launched as often as the ring makes it calls
   (live hops x four under zigzag); then ``run_training`` through the
   mesh code on a world of one (the five axes of size 1) at the full
   width for 2 steps, with phase 5's gates, and one profiled step in
   which the card runs no NCCL kernel. Ranks sharing a card have no
   NCCL, so the multi-rank step runs across cards by hand
   (``flagship_cards.py``);
11. moe     — (run right after phase 10) the MoE FFN: (a) one layer at
   flagship_large's width (Dm 2048, 4 experts of 8192, 16384 bf16
   tokens in groups of 256, capacity factor 2) on the card against the
   port's CPU evaluation of the same inputs — each token's expert, its
   slot, the drops and the kept slots a group and expert equal, bar
   tokens whose top-1/top-2 router-logit margin is under 1e-4 (their
   number printed), the output within 2e-2 (normalised L-inf) — and
   its device time beside the expert FFN's; (b) ``run_training`` with
   the MoE FFN at the full width (4 experts, B 4 x T 4096) for 3
   steps, with phase 5's gates, step ms, tokens/s and peak memory; (c)
   the MoE model's dense-cache decode against its paged step at chunk 1
   over 16 positions of 32 slots (phase 6's check and launch counts);
12. memory  — (run right after phase 11) rematerialization and ZeRO
   storage on one card: (a) the dense step at the full width, plain and
   with ``remat=True``, 2 steps each from the same params over the same
   batches: the remat losses bitwise the plain ones (or else the
   difference printed and held within 1e-6 relative), the flash forward
   launched twice a block a step (the recompute), peak memory of each;
   (b) the LM train step with phase 11's MoE config (one set of
   card-drawn params) under ``remat=True`` and under
   ``remat_policy="dots_with_no_batch_dims_saveable"``, 2
   steps each, with phase 5's gates, step ms, tokens/s and peak memory,
   each peak below phase 11's plain MoE peak; (c) ``zero_dp=True`` on a
   world of one through the mesh code: an empty ZeRO plan, losses
   bitwise the plain step's, and no NCCL kernel in a profiled step;
13. patterns — (run right after phase 12) the benchmark's model
   patterns on a world of one: (a) ``ring_attention --flash`` (also
   with ``--attn-window 128``) and ``ulysses_attention --flash``
   through ``cli.main`` at the CLI's defaults (B 8, H 8, T 512, D 64,
   bf16, causal): each line parses, the flash forward launches once a
   call, its ``--profile-dir`` trace holds it and no NCCL kernel; then both
   patterns' workloads at flagship_large's attention width (B 4, H 16,
   T 4096, D 128; the ring also with a window of 1024), their p50 and
   TFLOP/s beside the attention function called from a host loop, the
   forward kernel alone at that shape and phase 4's, each function's flash
   output within 2e-2 (normalised L-inf) of its plain path; (b) the
   RingTransformer at ``ModelConfig()``'s width (B 8, T 512, 8 heads x
   64, bf16) on a (dp, sp, tp) mesh of one: the flash forward within
   2e-2 of the plain one, 3 SGD steps with finite losses, the first
   within 1e-2 relative of the port's CPU float32 evaluation; (c)
   ``flagship_step`` at the CLI's tiny defaults in float32 and
   bfloat16, then at phase 5's width without the vocabulary (the
   pattern trains the block stack on the regression objective) for 3
   steps: its p50 within 10 % of the same step called alone, each
   flash kernel launched once a block a step; then with ``zero_dp``
   and ``overlap="prefetch"``: an empty ZeRO plan and no NCCL kernel.
14. loop    — (run right after phase 13) the training loop's optimizer,
   evaluation and durable checkpoints at phase 5's width, cut to 2 of
   its 8 blocks (the generations' bytes and the steps a quarter): (a)
   ``run_training`` with AdamW (weight decay 0.01), global-norm
   clipping at 1.0, one warmup step and the cosine schedule for 4
   steps, eval every 2 steps on one held-out batch, a generation every
   2 steps keeping 2: finite losses, the first near ln V, eval records
   at steps 2 and 4, both generations verify, each flash kernel once a
   block a step (the forward once more a block an evaluation); step ms
   (phase 5's 8-block SGD p50 beside it), peak memory, each save's ms, bytes and
   GB/s, the verifying load's ms; (b) a resume to step 4 from a copy of
   the directory without ``gen-000004``: start step 2, the loss and
   every param bitwise (a)'s (else the largest difference, held within
   1e-6 relative); (c) ``run_training_supervised`` with a simulated
   crash 512 bytes into the step-4 save: one restart from
   ``gen-000002``, the three ``# supervise:`` lines, (a)'s final loss.
15. serve mesh — (run right after phase 9's engine runs) colocated
   serving over the serve mesh, every rank a (card, stream) pair of one
   controller: (a) ``run_engine`` on dp 2 and dp 4 ranks sharing cuda:0
   at phase 7's width and trace (32 slots, pages ``SLOTS·5 + n``
   rounded up to a multiple of n), continuous and static: every request
   finishes, steps equal ``simulate_schedule(n_shards=n)``, every shard
   drains full, both modes emit the same tokens, the fused paged write
   launched ``stages`` times a (busy step, rank with an active row) and
   nothing else; every token teacher-forced through the dense decode
   step within 2 x 5e-2 of the dense maximum (phase 9's gate); how many
   streams equal phase 7's bitwise; tokens/s, TTFT and per-token p50/p99
   for dp 1 (phase 7), 2 and 4; (b) ``serve --reuse``'s three graded
   runs on 2 ranks sharing cuda:0: the schedule counts of the CPU run,
   TTFT ratio below 0.5, more than 1 token a decode step, and each
   stream that parts from the baseline (or from the CPU's) held to the
   teacher-forced gate with its count and top-2 margins printed; (c)
   ``run_chaos`` on 2 ranks sharing cuda:0: preempt, shed and step
   counts of the CPU run, ``slow_step``'s streams bitwise the fault-free
   twin's, the sampled streams against their batch-1 dense rollouts
   under the same gate;
16. overlap  — (run after phase 9's ship checks) the overlap knobs: (a)
   on a world of one, the dense step at phase 5's width and phase 11's
   MoE step, 2 steps each with ``tp_overlap="ring"``,
   ``ep_overlap="ring"`` and ``pp_overlap="wave"`` and without: losses
   bitwise (every axis has size 1), each flash kernel once a block a
   step; (b) process worlds of 2 and 4 ranks sharing cuda:0:
   ``ring_allgather_matmul(transport="pallas_dma")`` at flagship_large's
   tp FFN join (a [4, 4096 / n, 2048] bf16 chunk through a [2048,
   8192 / n] wf1 shard) with one backward pass, and
   ``chunked_ppermute_compute(transport="pallas_dma")`` over a partial
   edge set in padded chunks: the fused ship's and the permute's
   launches equal the calls' count (n - 1 ships a ring), every shipped
   chunk bitwise the plain version's (gloo on ``.cpu()`` copies) and
   ``expected_permute``'s, the ring's output bitwise the same products
   on the card in rank order, dx within 2e-2 (normalised L-inf) of the
   sum over ranks, a float32 ring's backward bitwise its plain
   version's; on 2 ranks the process-mesh ship alone, the compute alone,
   fused and their overlap (device time of time-sliced contexts, not a
   link number) beside the slab route's bytes bound, the plain version
   and one ``copy_``;
17. tp/ep serving — (run right after phase 15) serve meshes of
   in-process ranks sharing cuda:0, one thread a rank meeting at
   rendezvous for the tp and ep joins: (a) ``run_engine`` over (dp 1, tp
   2) and (dp 1, tp 4) at phase 7's width and trace, continuous: every
   request finishes, steps equal ``simulate_schedule``, the pool drains
   full, the fused paged write launched stages x busy steps x tp ranks;
   tokens/s, TTFT and per-token p50/p99; one tp rank's paged write
   (its heads of its weight shard's projections) bitwise the plain
   version; (b) phase 11's MoE model (capacity factor 4: no drops)
   decoding over (dp 1, ep 2) against ep 1, 16 teacher-forced positions:
   every token's expert equal wherever its top-2 router margin exceeds
   twice its router-logit difference between the runs, the logits
   within ``GRAD_TOL`` (relative L2); (c) flagship_large's
   decode with ZeRO-stored params over dp 2, bitwise the replicated dp
   2 decode; (d) ``run_disagg_engine`` with a tp 2 prefill (2 + 1 ranks,
   32 + 4 slots, ``pallas_dma`` x4): phase 9's gates, the migration
   bytes equal phase 9's tp 1 run's, the peer-push launches migrations x
   2 x 2 prefill ranks x 3 ranks; one migration from 2 prefill tp ranks
   at flagship_large's pages bitwise the plain version's (CPU ranks)
   over ``pallas_dma`` x1, x2 and ``xla``; every token of (a)'s and
   (d)'s streams held to phase 9's teacher-forced gate; ``serve
   --disagg`` through ``engine.main`` on 4 ranks of cuda:0 (prefill tp
   2 + decode dp 2) over ``xla`` and ``pallas_dma --migrate-chunks 2``,
   its own token parity against the colocated twin OK; (e) ``serve
   --trace PATH`` through ``engine.main`` on phase 7's trace:
   ``validate_chrome_trace`` finds no problem.
18. schedules — (run after phase 16) the tick-IR executor: (a) on a
   world of one, the flagship step (``make_flagship_train_step_1f1b``)
   at phase 5's width without the vocabulary (the MSE objective), 4
   microbatches, 2 steps each of fused 1F1B masked, 1F1B switch, zb
   switch (the fused program on one stage) and interleaved ``chunks=2``,
   beside the GPipe autograd step from the same params and batch:
   losses and params bitwise across zb/1f1b and switch/masked, one
   step's gradients and loss within ``GRAD_TOL`` (relative L2) of the
   GPipe step's, each flash kernel launched as the program's ticks call
   it; step ms, tokens/s and peak memory; (b) process worlds of 2 and 4
   ranks sharing cuda:0: ``make_tick_train_step`` with ``mlp_block`` at
   flagship_large's widths (d_model 2048, d_ff 8192; 16 MiB hops) over
   ``transport="pallas_dma"``, GPipe, 1F1B, interleaved and zb under
   both lowerings and 1F1B as a wave of 2 chunks: zb bitwise 1f1b,
   switch bitwise masked, the wave bitwise the one-shot ship, each
   update within ``GRAD_TOL`` of ``pipeline_reference``'s on the card,
   the peer-push launches a rank equal to the lowered hop tables'; step
   ms (time-sliced processes, not a link number); (c) ``python -m
   tpu_p2p_torch zb`` in this process: its JSON line, ``loss_bitwise``
   true, the ratio and the program's own grade.
19. Observability and health, each part in processes of its own (the
   profiler loses device events in an old process): (a) a world of one
   at phase 5's width, 2 of its 8 blocks: ``run_training`` for 4 steps
   with ``obs_jsonl`` and ``obs_window_step=2`` beside the same run
   without the stream: losses bitwise, one step row a step, one
   ``device_window`` record with ``device_track`` true and
   ``device_busy_frac`` in (0, 1], the summary; the flash launches of
   the profiled step equal to its flash kernel events in the window;
   ``obs watch`` over the stream exits 0; step ms with and without the
   stream; (b) process worlds of 2 and 4 ranks sharing cuda:0 run
   ``python -m tpu_p2p_torch obs --msg-size 32MiB --count 8 --no-gate
   --artifacts-dir <tmp>``: the ledger totals equal the CPU world's of
   the same size, every ``dma`` issue joined to a ``dma_permute_kernel``
   event (none ragged or unmatched), each ring edge of the peer-push
   matrix finite and the matrix labelled time-sliced, the library rows
   host-only; (c) ``python -m tpu_p2p_torch obs smoke`` on 4 processes
   sharing cuda:0: ``ok``, detection within 5 steps, the heal on 2 ranks
   and ``heal_loss_delta_rel`` <= 0.05.
20. The tools, each part in processes of its own: (a) ``python -m
   tpu_p2p_torch topo --smoke`` on 4 processes sharing cuda:0 (the
   throttled edge probed on the host group, the recommended ring around
   it, the ring's payloads over the peer-push kernels bitwise the
   rank-order ring's, migration placement beating free-pages-first in
   the dry scheduler, the disagg engine's streams bitwise under either
   placement; the probe's Gbps time-sliced, not link numbers) and
   ``topo --preset ring``'s render; (b) the flight recorder of ``obs
   trace`` on worlds of 2 and 4 processes of cuda:0 (zb, switch,
   d_model 2048, d_ff 8192, ``pallas_dma``): stamps from CUDA events,
   the device-trace join not n/a, each joined ``dma_permute_kernel``
   event on a shipping tick of its site, one a hop slot of the profiled
   step on every rank, the peer-push launches the program's hops give,
   busy and hop-wait ms and the constant overhead a tick; (c) ``python
   -m tpu_p2p_torch obs ckpt-smoke`` on the card: the three storage
   scenarios graded ok, bitwise against the uninterrupted twin,
   ``ckpt_recover_steps`` and ``ckpt_save_ms_p50``; (d) the native
   support library built with ``g++``, its outputs equal to the Python
   fallbacks'.

Then one JSON line with every kernel's numbers, one with the card, and
as the last line ``{"ok": true, "device": {...}}``. Exits non-zero,
printing no result, where no CUDA device is visible.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
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
WG_ROWS = 64                     # rows of a tensor-core kernel's warpgroup
MODEL = dict(heads=16, kv_heads=8, head_dim=128, stages=8,
             dense_ffn=True, moe_mult=4, vocab=32768, rope=True,
             norm=True, dtype="bfloat16", microbatches=1)
SLOTS, PAGE_LEN, MAX_BLOCKS, CHUNK = 32, 32, 8, 8
NUM_PAGES = SLOTS * 5 + 1        # 161 pages of 1 MiB
DECODE_POSITIONS = 16
SERVE_KEYS = ("serve_tokens_per_s", "serve_ttft_ms_p50", "serve_ttft_ms_p99",
              "serve_tok_ms_p50", "serve_tok_ms_p99", "wall_s", "steps")


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


# ------------------------------------------------------------ phase 2


# The tensor-core kernels and the wrapper (``launches`` key) of each.
TC_KERNELS = {"flash_fwd_kernel_wgmma": "flash_fwd",
              "flash_bwd_dkdv_kernel_wgmma": "flash_bwd_dkdv",
              "flash_bwd_dq_kernel_wgmma": "flash_bwd_dq"}
# The SIMT kernels' bf16 instances, which the tensor-core kernels retired.
RETIRED = ("flash_fwd_kernelI13__nv_bfloat16",
           "flash_bwd_dkdv_kernelI13__nv_bfloat16",
           "flash_bwd_dq_kernelI13__nv_bfloat16")


def cuobjdump(*args) -> str:
    from tpu_p2p_torch.utils.cuda_build import nvcc_path

    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    return subprocess.run([tool, *args], capture_output=True, text=True,
                          timeout=300, check=True).stdout


def sass_check(TFA, info: dict, card: str) -> None:
    """The built flash library read back with ``cuobjdump``: every
    instance of the tensor-core kernels holds HGMMA (wgmma) instructions
    and no bf16 instance of a SIMT flash kernel is left; prints
    each tensor-core kernel's registers, stack and local bytes
    (``-res-usage``), ptxas's spill bytes (the build's log, when this
    run built it), dynamic shared memory and CTAs an SM."""
    from tpu_p2p_torch.utils.cuda_build import ptxas_usage

    path = str(info["path"])
    hgmma, name = {}, None
    for line in cuobjdump("-sass", path).splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            hgmma[name] = 0
        elif name and "HGMMA" in line:
            hgmma[name] += 1
    tc = {n: c for n, c in hgmma.items() if any(k in n for k in TC_KERNELS)}
    if (len(tc) != len(TC_KERNELS) * len(TFA.KERNEL_HEAD_DIMS)
            or not all(tc.values())):
        raise AssertionError(f"HGMMA instructions per tensor-core kernel: "
                             f"{tc}")
    left = [n for n in hgmma if any(k in n for k in RETIRED)]
    if left:
        raise AssertionError(f"bf16 SIMT kernels still built: {left}")
    usage = {m.group(1): m.group(2, 3, 5) for m in re.finditer(
        r"Function (\S+):\s*REG:(\d+) STACK:(\d+) SHARED:(\d+) "
        r"LOCAL:(\d+)", cuobjdump("-res-usage", path))}
    for n in sorted(tc):
        kernel = next(k for k in TC_KERNELS if k in n)
        d = int(re.search(kernel + r"ILi(\d+)E", n).group(1))
        cfg = TFA.kernel_config(TC_KERNELS[kernel], torch.bfloat16, d)
        reg, stack, local = usage.get(n, ("?", "?", "?"))
        spill = ptxas_usage(info["log"], f"{kernel}ILi{d}E")
        say(f"sass {kernel} D{d}: {tc[n]} HGMMA | {reg} registers, stack "
            f"{stack} B, local {local} B, ptxas spill stores / loads "
            f"{spill['spill_stores']} / {spill['spill_loads']} B | tiles "
            f"{cfg['bq']} x {cfg['bk']}, {cfg['threads']} threads, "
            f"{cfg['smem']} B dynamic shared, {cfg['ctas_per_sm']} CTAs an "
            f"SM | {card}")
    say(f"sass: no bf16 SIMT flash kernel left ({len(hgmma)} kernels in "
        f"the library)")


# The peer-push kernels (csrc/p2p_dma.cu).
P2P_KERNELS = ("dma_permute_kernel", "dma_ship_push_kernel",
               "dma_ship_arrive_kernel", "dma_ship_copy_kernel")


def p2p_resources(info: dict, card: str) -> None:
    """The built peer-push library read back with ``cuobjdump
    -res-usage``: each kernel's registers, static shared memory and local
    bytes, with ptxas's spill bytes (the build's log, when this run built
    it)."""
    from tpu_p2p_torch.utils.cuda_build import ptxas_usage

    usage = {m.group(1): m.group(2, 3, 4) for m in re.finditer(
        r"Function (\S+):\s*REG:(\d+) STACK:\d+ SHARED:(\d+) "
        r"LOCAL:(\d+)", cuobjdump("-res-usage", str(info["path"])))}
    for kernel in P2P_KERNELS:
        name = next((n for n in usage if kernel in n), None)
        if name is None:
            raise AssertionError(f"{kernel} not in the p2p_dma library")
        reg, shared, local = usage[name]
        spill = ptxas_usage(info["log"], kernel)
        say(f"resources {kernel}: {reg} registers, {shared} B static "
            f"shared, local {local} B, ptxas spill stores / loads "
            f"{spill['spill_stores']} / {spill['spill_loads']} B | {card}")


# ------------------------------------------------------------ phase 3


def projections(dev, gen, chunk: int, pos):
    """A layer's K and V rows as the mixed step makes them: the einsum
    of a ``[SLOTS, chunk, Dm]`` bf16 activation with ``[H_kv, Dm, Dh]``
    weights, K roped at ``pos[:, None] + arange(chunk)``; in the layouts
    those ops return."""
    from tpu_p2p_torch.ops.rope import apply_rope

    H, Dh = MODEL["kv_heads"], MODEL["head_dim"]
    dm = MODEL["heads"] * Dh
    x = torch.randn((SLOTS, chunk, dm), generator=gen,
                    device=dev).to(torch.bfloat16)
    wk, wv = (torch.randn((H, dm, Dh), generator=gen, device=dev)
              .mul(dm ** -0.5).to(torch.bfloat16) for _ in range(2))
    k = torch.einsum("btm,hmd->bhtd", x, wk)
    v = torch.einsum("btm,hmd->bhtd", x, wv)
    qpos = pos[:, None] + torch.arange(chunk, device=dev)[None, :]
    return apply_rope(k, qpos), v


def write_timings(write, plain, library, empty) -> dict:
    """The fused write's device time on graph replay, the empty kernel's
    over the same grid (the launch floor), the plain version's and the
    two ``index_put_`` calls' times, and the wrapper's host loop."""
    return {"ms": time_graph(write), "floor_ms": time_graph(empty),
            "plain_ms": time_eager(plain, calls=20),
            "library_ms": time_graph(library),
            "host_loop_ms": time_eager(write)}


def kernel_paged(TK, dev, gen) -> dict:
    """``paged_kv_write`` on the serving pools (161 pages, 32 slots,
    chunk 8) from the projections as the mixed step makes them, n in
    {0, 1, 8} at every in-band offset; then the band-image form
    ``paged_rows_write``, bitwise."""
    S, H, Dh = MODEL["stages"], MODEL["kv_heads"], MODEL["head_dim"]
    pools = [torch.randn((S, NUM_PAGES, H, PAGE_LEN, Dh), generator=gen,
                         device=dev).to(torch.bfloat16) for _ in range(2)]
    b = torch.arange(SLOTS, device=dev)
    n = torch.tensor([(0, 1, 8)[i % 3] for i in range(SLOTS)],
                     dtype=torch.int32, device=dev)
    r0 = torch.where(n == 8, 0, b % 8).to(torch.int32)
    page = torch.where(n > 0, 1 + 5 * b, 0).to(torch.int32)
    band = (b % (PAGE_LEN // 8)).to(torch.int32)
    rows = projections(dev, gen, CHUNK, band.long() * 8 + r0.long())
    stage = 3
    args = (*rows, page, band, r0, n, stage)
    want = TK.paged_kv_write_plain(*(p.clone() for p in pools), *args)
    got = [p.clone() for p in pools]
    TK.paged_kv_write(*got, *args)
    torch.cuda.synchronize()
    err = max((g.float() - w.float()).abs().max().item()
              for g, w in zip(got, want))
    if not all(bits_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(
            f"paged_kv_write differs from its plain version "
            f"(max abs err {err})")
    slab8 = torch.randn((SLOTS, H, 8, Dh), generator=gen,
                        device=dev).to(torch.bfloat16)
    one = pools[0].clone()
    TK.paged_rows_write(one, slab8, page, band, r0, n, stage)
    if not bits_equal(one, TK.paged_rows_write_plain(
            pools[0].clone(), slab8, page, band, r0, n, stage)):
        raise AssertionError("paged_rows_write (band image) differs from "
                             "its plain version")
    # The library yardstick: one index_put_ a projection (two calls) of
    # the live rows, indices and row values gathered beforehand.
    live = [(i, r) for i in range(SLOTS) for r in range(int(n[i]))]
    bi = torch.tensor([i for i, _ in live], device=dev)
    ri = torch.tensor([r for _, r in live], device=dev)
    pg = page.long()[bi][:, None]
    row = (band.long()[bi] * 8 + r0.long()[bi] + ri)[:, None]
    hi = torch.arange(H, device=dev)[None, :]
    vals = [t[bi, :, ri] for t in rows]                # [rows, H, Dh]
    dst = [p.clone() for p in pools]
    dst_s = [d[stage] for d in dst]

    def library():
        dst_s[0].index_put_((pg, hi, row), vals[0])
        dst_s[1].index_put_((pg, hi, row), vals[1])

    library()
    if not all(bits_equal(d, w) for d, w in zip(dst, want)):
        raise AssertionError("index_put_ yardstick disagrees")
    row_bytes = H * Dh * 2
    nbytes = 2 * (2 * len(live) * row_bytes) + 4 * SLOTS * 4
    threads = TK._threads(CHUNK, Dh * 2, 16)
    return {
        "name": "paged_kv_write", "route": "cuda",
        "source": "tpu_p2p_torch/csrc/kvcache.cu",
        "replaces": "tpu_p2p/ops/kvcache.py:89 (_paged_band_kernel)",
        "max_abs_err": err,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "layout": f"k strides {rows[0].stride()}, v {rows[1].stride()}",
        **write_timings(
            lambda: TK.paged_kv_write(*got, *args),
            lambda: TK.paged_kv_write_plain(*got, *args), library,
            lambda: TK.launch_empty(got[0], SLOTS, H, 2, threads)),
    }


def kernel_cache_kv(TK, dev, gen) -> dict:
    """``cache_kv_write`` on the dense caches ``[8, 32, 8, 256, 128]``
    from one token's projections; then the single-destination form
    ``cache_row_write``, bitwise."""
    S, H, Dh = MODEL["stages"], MODEL["kv_heads"], MODEL["head_dim"]
    T = MAX_BLOCKS * PAGE_LEN
    caches = [torch.randn((S, SLOTS, H, T, Dh), generator=gen,
                          device=dev).to(torch.bfloat16) for _ in range(2)]
    pos, stage = 37, 5
    rows = projections(dev, gen, 1,
                       torch.full((SLOTS,), pos, device=dev))
    args = (*rows, pos, stage)
    want = TK.cache_kv_write_plain(*(c.clone() for c in caches), *args)
    got = [c.clone() for c in caches]
    TK.cache_kv_write(*got, *args)
    torch.cuda.synchronize()
    err = max((g.float() - w.float()).abs().max().item()
              for g, w in zip(got, want))
    if not all(bits_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(
            f"cache_kv_write differs from its plain version "
            f"(max abs err {err})")
    one = caches[0].clone()
    TK.cache_row_write(one, rows[0], pos, stage)
    if not bits_equal(one, want[0]):
        raise AssertionError("cache_row_write differs from its plain "
                             "version")
    bi = torch.arange(SLOTS, device=dev)[:, None]
    hi = torch.arange(H, device=dev)[None, :]
    ti = torch.tensor(pos, device=dev)
    vals = [t[:, :, 0] for t in rows]
    dst = [c.clone() for c in caches]
    dst_s = [d[stage] for d in dst]

    def library():
        dst_s[0].index_put_((bi, hi, ti), vals[0])
        dst_s[1].index_put_((bi, hi, ti), vals[1])

    library()
    if not all(bits_equal(d, w) for d, w in zip(dst, want)):
        raise AssertionError("index_put_ yardstick disagrees")
    nbytes = 2 * (2 * SLOTS * H * Dh * 2)
    return {
        "name": "cache_kv_write", "route": "cuda",
        "source": "tpu_p2p_torch/csrc/kvcache.cu",
        "replaces": "tpu_p2p/ops/kvcache.py:25 (_cache_row_kernel)",
        "max_abs_err": err,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "layout": f"k strides {rows[0].stride()}, v {rows[1].stride()}",
        **write_timings(
            lambda: TK.cache_kv_write(*got, *args),
            lambda: TK.cache_kv_write_plain(*got, *args), library,
            lambda: TK.launch_empty(got[0], SLOTS, H, 2,
                                    TK._threads(1, Dh * 2, 16))),
    }


# ------------------------------------------------------------ phase 4


def live_tile_pairs(tq: int, tk: int, q_off: int, k_off: int, causal: bool,
                    window, bq: int, bk: int, by_key: bool = False) -> int:
    """(q block, k block) pairs a flash kernel computes for one row, from
    its own loop bounds (csrc/flash_attention.cu): ``bq``-row q blocks
    each against the ``bk``-row KV tiles it loops over (the forward and
    dq), or, ``by_key``, ``bk``-row key blocks each against the
    ``bq``-row q tiles it loops over (dK/dV)."""
    n_q, n_k = -(-tq // bq), -(-tk // bk)
    pairs = 0
    for t in range(n_k if by_key else n_q):
        lo, hi = 0, (n_q if by_key else n_k) - 1
        if causal and by_key:
            k_first = k_off + t * bk
            lo = max(0, (k_first - q_off) // bq)
            if window:
                hi = min(hi, (k_first + bk - 1 + window - 1 - q_off) // bq)
        elif causal:
            q_first = q_off + t * bq
            hi = min(hi, (q_first + bq - 1 - k_off) // bk)
            if window:
                lo = max(0, (q_first - (window - 1) - k_off) // bk)
        pairs += max(0, hi - lo + 1)
    return pairs


def kernel_blocks(TFA, dtype) -> dict:
    """Per flash kernel, the blocks ``live_tile_pairs`` counts: a
    tensor-core kernel's warpgroup (64 rows) against its other tile, a
    SIMT kernel's two tiles."""
    out = {}
    for name in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
        cfg = TFA.kernel_config(name, dtype, TRAIN["head_dim"])
        tc = cfg["entry"].endswith("_wgmma")
        by_key = name == "flash_bwd_dkdv"
        bq = cfg["bq"] if by_key or not tc else WG_ROWS
        bk = WG_ROWS if by_key and tc else cfg["bk"]
        out[name] = dict(bq=bq, bk=bk, by_key=by_key)
    return out


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
    dq_again = TFA._flash_bwd_dq(*bargs, **kw)
    torch.cuda.synchronize()
    names = ("o", "m", "l", "dk", "dv", "dq")
    errs = {n: norm_err(g, w) for n, g, w in zip(names, got, want)}
    bad = {n: e for n, e in errs.items() if not e <= FLASH_BF16_TOL}
    if bad:
        raise AssertionError(f"flash kernels vs plain (window {window}): "
                             f"normalised L-inf {bad} > {FLASH_BF16_TOL}")
    if not bits_equal(got[5], dq_again):
        raise AssertionError(f"flash dq (window {window}): two launches "
                             "differ")
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
            f"{lib:.3f} ms"
            + ("" if name == "flash_fwd" else
               f" (bwd alone, fwd+bwd - fwd: {lib_fb - lib_fwd:.3f} ms)")
            + f" | {card}")
    return rows


def flash_train_windowed(TFA, dev, gen, card) -> None:
    """The training-shape check with ``--attn-window 1024`` (the banded
    sweep), each kernel timed beside its live-tile bound."""
    window, t = 1024, TRAIN["seq"]
    c = flash_bf16_check(TFA, dev, gen, window)
    times = {n: time_eager(fn, calls=10) for n, (fn, _) in c["calls"].items()}
    bounds = c["bounds"]
    blocks = kernel_blocks(TFA, torch.bfloat16)
    live = {n: (live_tile_pairs(t, t, 0, 0, True, window, **blocks[n]),
                live_tile_pairs(t, t, 0, 0, True, None, **blocks[n]))
            for n in times}
    say(f"flash bf16 @ B{TRAIN['batch']} H{TRAIN['heads']}/"
        f"{TRAIN['kv_heads']} T{t} D{TRAIN['head_dim']} window {window}: "
        f"normalised L-inf vs plain {c['errs']} (tol {FLASH_BF16_TOL}) | "
        f"{visible_pairs(t, t, 0, 0, True, window)} visible (query, key) "
        f"pairs a row (causal: {visible_pairs(t, t, 0, 0, True, None)}) | "
        "live blocks a row, window / causal: "
        + ", ".join(f"{n} {live[n][0]} / {live[n][1]} "
                    f"({blocks[n]['bq']} x {blocks[n]['bk']})" for n in live)
        + " | ms "
        + ", ".join(f"{n} {times[n]:.3f} (bound {bounds[n]['bound_ms']:.3f}"
                    f" {bounds[n]['bound_by']})" for n in times)
        + f" | {card}")


# (head dim, Hq, Hkv, Tq, Tk, q_off, k_off, window, random carry): GQA
# groups 1, 2 and 4; Tq != Tk, neither a tile multiple; q_off < k_off
# with a window, so the first queries see no key (fully masked rows).
FLASH_EDGES = ((32, 4, 4, 100, 150, 0, 0, None, False),
               (64, 4, 2, 200, 264, 37, 5, 100, True),
               (128, 8, 2, 130, 190, 3, 70, 96, True))


def flash_bf16_edges(TFA, dev, gen, card) -> None:
    """The bf16 kernels on ragged shapes against their plain versions
    (normalised L-inf <= FLASH_BF16_TOL), each launched twice: the two
    results must be bitwise equal (no atomics, a fixed order of sums);
    rows that see no key get an exact-zero dq."""
    errs, blind_rows = {}, 0
    for d, hq, hkv, tq, tk, q_off, k_off, window, rand in FLASH_EDGES:
        rnd = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
        q3, do3 = (rnd(2 * hq, tq, d).bfloat16() for _ in range(2))
        k3, v3 = (rnd(2 * hkv, tk, d).bfloat16() for _ in range(2))
        carry = ((rnd(2 * hq, tq, d), rnd(2 * hq, tq),
                  torch.rand((2 * hq, tq), generator=gen, device=dev))
                 if rand else TFA.zero_carry(2 * hq, tq, d, dev))
        kw = dict(causal=True, q_heads=hq, window=window)
        fargs = (q3, k3, v3, *carry, q_off, k_off)
        want = TFA._flash_call_plain(*fargs, **kw)
        o, m, l = want
        live = l > 0
        L = torch.where(live, m + torch.log(torch.where(live, l, 1.0)), 1e30)
        delta = (do3.float() * (o / torch.where(live, l, 1.0)[..., None])
                 ).sum(-1)
        bargs = (q3, k3, v3, do3, L, delta, q_off, k_off)
        want += TFA._flash_bwd_dkdv_plain(*bargs, **kw) + (
            TFA._flash_bwd_dq_plain(*bargs, **kw),)
        runs = [TFA._flash_call(*fargs, **kw)
                + TFA._flash_bwd_dkdv(*bargs, **kw)
                + (TFA._flash_bwd_dq(*bargs, **kw),) for _ in range(2)]
        torch.cuda.synchronize()
        case = f"D{d} H{hq}/{hkv} T{tq}/{tk} off {q_off}/{k_off} w{window}"
        errs[case] = {n: norm_err(g, w) for n, g, w in
                      zip(("o", "m", "l", "dk", "dv", "dq"), runs[0], want)}
        bad = {n: e for n, e in errs[case].items() if not e <= FLASH_BF16_TOL}
        if bad:
            raise AssertionError(f"flash bf16 edge case {case}: normalised "
                                 f"L-inf {bad} > {FLASH_BF16_TOL}")
        if not all(bits_equal(a, b) for a, b in zip(*runs)):
            raise AssertionError(f"flash bf16 edge case {case}: two launches "
                                 "differ")
        q_pos = q_off + torch.arange(tq, device=dev)
        blind = q_pos < k_off
        if window:
            blind |= q_pos - (window - 1) > k_off + tk - 1
        if runs[0][5][:, blind].any():
            raise AssertionError(f"flash bf16 edge case {case}: dq of rows "
                                 "that see no key is not zero")
        blind_rows += int(blind.sum())
    say("flash bf16 edge cases (random carry where marked), normalised "
        f"L-inf vs plain (tol {FLASH_BF16_TOL}), two launches bitwise "
        f"equal, dq exactly 0 on {blind_rows} rows that see no key: "
        + "; ".join(
            f"{c}: " + ", ".join(f"{n} {e:.1e}" for n, e in v.items())
            for c, v in errs.items()) + f" | {card}")


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


def run_train(cfg, steps: int, TFA, dev, mesh=None) -> dict:
    """``run_training`` with a record every step (on ``mesh`` when
    given); → records, launches, per-step ms (from the records' wall
    clock, each read after the step's loss reached the host) and peak
    memory."""
    from tpu_p2p_torch.train import run_training

    buf = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    TFA.reset_launches()
    out = run_training(cfg, steps=steps, lr=1e-2, seed=0, log_every=1,
                       log_stream=buf, device=dev, mesh=mesh)
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
    """Finite losses, one a step, and each flash kernel once per block
    per microbatch per step — the forward twice under remat, whose
    backward runs each block's forward again."""
    losses = run["losses"]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train losses {losses}")
    check_launches(run["launches"], cfg, steps)


def check_launches(launches: dict, cfg, steps: int) -> None:
    once = steps * cfg.stages * cfg.microbatches
    want = {name: once * (2 if cfg.remat and name == "flash_fwd" else 1)
            for name in launches}
    if launches != want:
        raise AssertionError(f"flash launches {launches} over {steps} "
                             f"steps, expected {want} (once per block per "
                             "microbatch per step; the forward again in "
                             "the remat recompute)")


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
    return {"launches": run["launches"], "step_ms_p50": p50,
            "peak_gib": run["peak_gib"]}


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
    want = cfg.stages * DECODE_POSITIONS
    if counts != {"cache_kv_write": want, "paged_kv_write": want,
                  "cache_row_write": 0, "paged_rows_write": 0}:
        raise AssertionError(f"decode launches {counts}, expected {want} "
                             "of each fused write (stages x positions) "
                             "and none of the single-destination ones")
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
    from tpu_p2p_torch.serve.engine import (run_engine, serve_mesh,
                                            synthetic_trace)

    sc = serve_config(cfg)
    trace = synthetic_trace(sc)
    mesh = serve_mesh(1, [params["emb"].device])
    run_engine(mesh, cfg, params, trace[:2], sc=sc)  # warm-up, not counted
    torch.cuda.synchronize()
    streams, summary, busy_total = {}, {}, 0
    TK.reset_launches()
    for mode in ("continuous", "static"):
        sim = simulate_schedule(
            trace, slots=sc.slots, page_len=sc.page_len,
            num_pages=sc.num_pages, max_blocks=sc.max_blocks,
            chunk=sc.chunk, mode=mode)
        torch.cuda.reset_peak_memory_stats()
        out = run_engine(mesh, cfg, params, trace, sc=sc, mode=mode)
        torch.cuda.synchronize()
        b = out["batcher"]
        busy = b.step_idx - b.idle_steps
        summary[mode] = {k: out[k] for k in SERVE_KEYS}
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
    want = cfg.stages * busy_total
    if counts != {"paged_kv_write": want, "cache_kv_write": 0,
                  "paged_rows_write": 0, "cache_row_write": 0}:
        raise AssertionError(f"serve launches {counts}, expected "
                             f"paged_kv_write {want} times (stages x busy "
                             "steps) and nothing else")
    if streams["continuous"] != streams["static"]:
        diff = [r for r in streams["continuous"]
                if streams["continuous"][r] != streams["static"][r]]
        raise AssertionError(f"continuous vs static streams differ for "
                             f"requests {diff}")
    return {"launches": counts, "streams": streams["continuous"],
            "summary": summary}


# ------------------------------------------------------------ phase 8

P2P_MSG, P2P_ITERS = 32 << 20, 128      # the reference's defaults
P2P4_MSG, P2P4_ITERS = 4 << 20, 16      # the 4-rank world, cut
RING_ITERS = 16                         # ring / torus2d / NCCL cells, cut
NCCL_PATTERNS = ("ring", "all_to_all", "allreduce", "reduce_scatter",
                 "all_gather")
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


def device_mode_launches(cfg) -> tuple:
    """Hops of one ``--mode device`` cell (``measure_headline``): both
    chains warmed and timed ``fused_repeats`` times on the host clock,
    then run twice in the profiler's warm-up cycle and twice recorded —
    once, or twice over where the two clocks disagreed and rank 0 chose
    to measure again."""
    short = max(1, cfg.iters // 8)
    once = (1 + cfg.fused_repeats + 4) * (short + max(cfg.iters, short + 1))
    return once, 2 * once


def ring_launches(cfg, axes: int = 1) -> tuple:
    """Launches one rank makes in a ``ring`` (``axes=1``) or ``torus2d``
    run over the peer-push kernel: per axis the serialized loop (warm-up
    and ``iters``) or the device-mode chains, and the ``--check`` hop —
    every rank of a ring or an axis line takes part in every hop. → the
    counts the run may make (two where a re-measure can happen)."""
    check = int(cfg.check)
    if cfg.mode == "device":
        return tuple(axes * (n + check) for n in device_mode_launches(cfg))
    return (axes * (cfg.warmup + cfg.iters + check),)


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
                  sizes, timing: bool, ring_msg: int = 0,
                  ring_modes=()) -> dict:
    """One rank of a world that shares cuda:0 (every rank
    ``make_runtime(device="cuda:0")``), then what ``cli.main`` runs after
    it builds the runtime: ``pairwise --transport pallas_dma --check`` in
    each isolation (and ``latency --transport pallas_dma``), then ``ring
    --transport pallas_dma`` at ``ring_msg`` x ``RING_ITERS`` in each of
    ``ring_modes`` (``--check`` with serialized), launches counted; an
    ``allreduce`` must raise ``BackendError`` before any traffic (NCCL
    cannot form on one card); then the kernel checks and, on request,
    the timing."""
    from tpu_p2p_torch.cli import run_benchmark
    from tpu_p2p_torch.config import BenchConfig
    from tpu_p2p_torch.parallel import pallas_dma as PD
    from tpu_p2p_torch.parallel.runtime import make_runtime
    from tpu_p2p_torch.utils.errors import BackendError

    rt = make_runtime(device="cuda:0")
    out = {"rank": rt.rank, "world": rt.world}
    rt.barrier()
    PD.reset_launches()
    t0 = time.perf_counter()
    expected = [0]
    for iso in isolations:
        cfg = BenchConfig(pattern="pairwise", msg_size=msg, iters=iters,
                          transport="pallas_dma", check=True, isolation=iso)
        run_benchmark(rt, cfg)
        expected = [e + pairwise_launches(rt.world, rt.rank, cfg)
                    for e in expected]
    if latency:
        cfg = BenchConfig(pattern="latency", transport="pallas_dma")
        run_benchmark(rt, cfg)
        expected = [e + latency_launches(cfg) for e in expected]
    for mode in ring_modes:
        cfg = BenchConfig(pattern="ring", msg_size=ring_msg,
                          iters=RING_ITERS, transport="pallas_dma",
                          mode=mode, check=mode == "serialized")
        run_benchmark(rt, cfg)
        expected = [e + n for e in expected for n in ring_launches(cfg)]
    rt.barrier()
    out.update(launches=PD.launches["dma_permute"],
               expected_launches=expected,
               main_path_s=time.perf_counter() - t0)
    if ring_modes:
        try:
            run_benchmark(rt, BenchConfig(pattern="allreduce",
                                          msg_size=ring_msg, iters=2))
            out["allreduce"] = "ran"
        except BackendError as e:
            out["allreduce"] = str(e)
        out["allreduce_launches"] = PD.launches["dma_permute"] - \
            out["launches"]
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
        if r["launches"] not in r["expected_launches"] or \
                r["launches"] != res[0]["launches"]:
            raise AssertionError(
                f"world of {n}, rank {r['rank']}: dma_permute launched "
                f"{r['launches']} times on the main path, expected one "
                f"of {r['expected_launches']} (the same on every rank)")
        if kw.get("ring_modes") and (
                "NCCL collective" not in r["allreduce"]
                or r["allreduce_launches"]):
            raise AssertionError(
                f"world of {n}, rank {r['rank']}: allreduce on ranks "
                f"sharing a card must raise BackendError before any "
                f"traffic; got {r['allreduce']!r}, "
                f"{r['allreduce_launches']} launches")
        c = r["checks"]
        if c["bad"] or c["counted"] != c["launches"]:
            raise AssertionError(
                f"world of {n}, rank {r['rank']}: kernel vs plain/oracle "
                f"failed for {c['bad']}; launches {c['counted']} vs "
                f"{c['launches']} made")
    rings = ""
    if kw.get("ring_modes"):
        rings = (f", ring {'/'.join(kw['ring_modes'])} at {kw['ring_msg']} B"
                 f" x {RING_ITERS}; allreduce refused: "
                 f"{res[0]['allreduce']}")
    say(f"p2p world of {n} on cuda:0 ({', '.join(kw['isolations'])} "
        f"isolation, {kw['msg']} B x {kw['iters']}, pallas_dma, --check"
        f"{', latency' if kw['latency'] else ''}{rings}): main path "
        f"{res[0]['main_path_s']:.1f} s, dma_permute launches per rank "
        f"{[r['launches'] for r in res]} (= expected); kernel == plain "
        f"(gloo) == expected_permute bitwise over 6 edge sets at "
        f"{list(kw['sizes'])} B int8 + float32 [5, 3] + backward, "
        f"{res[0]['checks']['launches']} launches a rank | world "
        f"{time.perf_counter() - t0:.1f} s | {card}")
    return res


def torus_rank_case(msg: int, sizes) -> dict:
    """One rank of a world of 4 sharing cuda:0, laid out 2x2 (``make_
    runtime(device="cuda:0", mesh_shape=(2, 2))``): ``torus2d --transport
    pallas_dma --check`` at ``msg`` x ``RING_ITERS``, launches counted;
    then the kernel on each axis's ring (a full permutation of the
    rank's line) against its plain version (gloo over the line, on
    ``.cpu()`` copies) and ``expected_permute(axis=)``, bitwise, at
    ``sizes``; and the peer-push windows, one set a line."""
    from tpu_p2p_torch.cli import run_benchmark
    from tpu_p2p_torch.config import BenchConfig
    from tpu_p2p_torch.parallel import collectives as C
    from tpu_p2p_torch.parallel import pallas_dma as PD
    from tpu_p2p_torch.parallel.runtime import make_runtime

    rt = make_runtime(device="cuda:0", mesh_shape=(2, 2))
    mesh = rt.mesh
    out = {"rank": rt.rank}
    rt.barrier()
    PD.reset_launches()
    t0 = time.perf_counter()
    cfg = BenchConfig(pattern="torus2d", msg_size=msg, iters=RING_ITERS,
                      transport="pallas_dma", check=True, mesh_shape=(2, 2))
    run_benchmark(rt, cfg)
    rt.barrier()
    out.update(launches=PD.launches["dma_permute"],
               expected_launches=ring_launches(cfg, axes=2),
               main_path_s=time.perf_counter() - t0)
    PD.reset_launches()
    bad, worst, made = [], 0, 0
    for a, axis in enumerate(mesh.axis_names):
        line, ring = mesh.line(axis), C.ring_edges(mesh.shape[axis])
        for nbytes in sizes:
            x = C.make_payload(mesh, nbytes, np.int8)
            got = C.dma_ppermute(x, line, ring).cpu()
            made += 1
            plain = PD._dma_ppermute_plain(x.cpu(), line, ring)
            want = C.expected_permute(C.host_payload(mesh, nbytes), ring,
                                      axis=a)
            worst = max(worst, (got.int() - plain.int()).abs().max().item())
            if not (torch.equal(got, plain)
                    and C.verify_against(got, want, mesh)):
                bad.append(f"axis {axis} ring {nbytes} B")
    rt.barrier()
    lines = [mesh.line(a) for a in mesh.axis_names]
    out["checks"] = {"bad": bad, "max_abs_err": worst, "launches": made,
                     "counted": PD.launches["dma_permute"]}
    out["windows"] = {
        "lines": [sorted(m.windows) for m in lines],
        "world": sorted(mesh.windows),
        "distinct": len({id(m.windows) for m in lines}
                        | {id(mesh.windows)}) == 3,
    }
    rt.close()
    out["windows"]["left"] = sum(len(m.windows) for m in lines)
    return out


def torus_world(card: str) -> list:
    """Spawn the 2x2 world of :func:`torus_rank_case`; raise on a failed
    rank, a launch mismatch, a kernel disagreement, or windows shared
    between lines or left open."""
    from tpu_p2p_torch.parallel.launch import run_world

    t0 = time.perf_counter()
    res = run_world(4, f"{__file__}:torus_rank_case",
                    {"msg": P2P4_MSG, "sizes": (136, P2P4_MSG)}, timeout=450)
    for r in res:
        c, w = r["checks"], r["windows"]
        if r["launches"] not in r["expected_launches"]:
            raise AssertionError(
                f"torus 2x2, rank {r['rank']}: dma_permute launched "
                f"{r['launches']} times, expected {r['expected_launches']}")
        if c["bad"] or c["counted"] != c["launches"]:
            raise AssertionError(
                f"torus 2x2, rank {r['rank']}: kernel vs plain/oracle "
                f"failed for {c['bad']}; launches {c['counted']} vs "
                f"{c['launches']} made")
        if not (w["distinct"] and all(w["lines"]) and not w["world"]
                and not w["left"]):
            raise AssertionError(f"torus 2x2, rank {r['rank']}: windows "
                                 f"{w} (one set a line, none left open)")
    say(f"torus2d world of 4 on cuda:0 (2x2, {P2P4_MSG} B x {RING_ITERS}, "
        f"pallas_dma, --check): main path {res[0]['main_path_s']:.1f} s, "
        f"dma_permute launches per rank {[r['launches'] for r in res]} (= "
        f"expected); kernel == plain (gloo over the line) == "
        f"expected_permute(axis=) bitwise on both axes' rings at 136 B and "
        f"{P2P4_MSG} B; windows one set a line "
        f"{res[0]['windows']['lines']}, none on the world, all closed | "
        f"world {time.perf_counter() - t0:.1f} s | {card}")
    return res


def cli_cell(argv, rc: int = 0) -> tuple:
    """``cli.main(argv)`` in this process (a world of 1), its output
    echoed → (stdout, stderr); raises unless it exits ``rc``."""
    import contextlib

    from tpu_p2p_torch import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        got = cli.main(argv)
    sys.stdout.write(out.getvalue())
    if got != rc:
        raise AssertionError(f"python -m tpu_p2p_torch {argv} exited {got}, "
                             f"expected {rc}: {err.getvalue()[-2000:]}")
    return out.getvalue(), err.getvalue()


def nccl_world1(card: str) -> None:
    """The new patterns in a world of 1 through ``cli.main``: the NCCL
    ones with ``--check`` at 32 MiB x ``RING_ITERS``; ``--mode device``
    on ``latency`` and ``all_gather`` (published from the card's clock)
    and on ``allreduce``, which must refuse (an in-place sum over one
    rank puts nothing on the card); ``--validate-timing`` on the 32 MiB
    loopback, which must say OK; ``--profile-dir``, whose trace must
    hold the card's kernels."""
    import tempfile

    t0 = time.perf_counter()
    for pattern in NCCL_PATTERNS:
        cli_cell(["--pattern", pattern, "--check", "--iters",
                  str(RING_ITERS)])
    with tempfile.TemporaryDirectory(prefix="smoke_p2p_") as td:
        log = os.path.join(td, "cells.jsonl")
        out, _ = cli_cell(["--pattern", "latency", "--mode", "device"])
        if "(device_trace)" not in out:
            raise AssertionError(f"latency --mode device: {out!r}")
        cli_cell(["--pattern", "all_gather", "--mode", "device", "--iters",
                  str(RING_ITERS), "--jsonl", log])
        with open(log) as fh:
            rec = json.loads(fh.readline())
        if rec.get("source") != "device_trace" or not rec["mean_s"] > 0:
            raise AssertionError(f"all_gather --mode device record {rec}")
        _, err = cli_cell(["--pattern", "allreduce", "--mode", "device",
                           "--iters", str(RING_ITERS)], rc=1)
        # Refused for lack of device work either way: the long chain put
        # no more on the card than the short one, or the trace held no
        # device event of the short chain (the tracer can lose a run's).
        if "no device work" not in err:
            raise AssertionError(f"allreduce --mode device: {err!r}")
        out, _ = cli_cell(["--pattern", "loopback", "--msg-size", "32MiB",
                           "--iters", str(RING_ITERS), "--validate-timing"])
        if "timing-validation[OK]" not in out:
            raise AssertionError(f"--validate-timing did not say OK: {out!r}")
        prof = os.path.join(td, "prof")
        cli_cell(["--pattern", "latency", "--profile-dir", prof])
        with open(os.path.join(prof, "rank0.trace.json")) as fh:
            kernels = sum(1 for e in json.load(fh)["traceEvents"]
                          if e.get("cat") == "kernel")
        if not kernels:
            raise AssertionError("--profile-dir trace holds no kernel")
    say(f"p2p world of 1 (NCCL): {', '.join(NCCL_PATTERNS)} --check at "
        f"32 MiB x {RING_ITERS}; --mode device on latency and all_gather "
        f"(source device_trace), allreduce refused (no device work over one "
        f"rank); --validate-timing OK; --profile-dir trace with {kernels} "
        f"kernels | {time.perf_counter() - t0:.1f} s | {card}")


def graph_slope(make_chain, x, short: int, long: int, reps: int = 5):
    """Per-op device time as the slope between two chain lengths, each
    chain captured once in a CUDA graph and replayed ``reps`` times
    between two events: the card's clock with no host issue in the
    way."""
    ms = {}
    for k in (short, long):
        fn = make_chain(k)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(x)
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn(x)
        g.replay()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            g.replay()
        t1.record()
        t1.synchronize()
        ms[k] = t0.elapsed_time(t1) / reps
    return (ms[long] - ms[short]) / (long - short) * 1e-3


def device_clock_check(card: str) -> dict:
    """The two ways to read a chain's time on the card, on the same
    chains of a world of 1 at 32 MiB: the busy-time slope of a
    ``torch.profiler`` trace (what ``--mode device`` publishes) against
    CUDA-graph replays timed by events, and the host slope beside them;
    the two device readings must agree within 25 %. → the loopback cell's
    numbers."""
    from tpu_p2p_torch.parallel import collectives as C
    from tpu_p2p_torch.parallel.runtime import make_runtime
    from tpu_p2p_torch.utils.profiling import measure_headline

    rt = make_runtime(device="cuda:0")
    cache = C.CollectiveCache()
    x = C.make_payload(rt.mesh, P2P_MSG, np.int8)
    cells = {
        "loopback rewrite": lambda k: cache.loopback_chain(rt.mesh, k),
        "all_gather (NCCL, one rank)":
            lambda k: cache.ag_chain(rt.mesh, "d", k),
    }
    out = {}
    for name, chain in cells.items():
        m = measure_headline(chain, x, HOP_CHAIN, group=rt.mesh.host_group)
        g = graph_slope(chain, x, m.n_short, m.n_long)
        if m.source != "device_trace" or not 0.8 <= m.per_op_s / g <= 1.25:
            raise AssertionError(
                f"{name}: profiler slope {m.per_op_s} s/op ({m.source}, "
                f"{m.note}) vs graph slope {g} s/op")
        out[name] = (m.per_op_s, g, m.host_per_op_s)
        say(f"device clock, {name} 32 MiB (chains {m.n_short}/{m.n_long}): "
            f"profiler busy-time slope {m.per_op_s * 1e6:.3f} us/op, "
            f"CUDA-graph slope {g * 1e6:.3f} us/op (ratio "
            f"{m.per_op_s / g:.3f}), host slope "
            f"{m.host_per_op_s * 1e6:.3f} us/op | {card}")
    rt.close()
    return out


def p2p_self_edge() -> dict:
    """The kernel with no peer: a world of 1 on cuda:0 pushing 32 MiB
    over the self-edge, straight into its own output, so no context ever
    waits for another. → ms per hop of a fused chain (median of 5 chains
    of ``HOP_CHAIN``, CUDA events), the host's enqueue time per hop over
    that chain, and the device times of the kernel and of one ``copy_``
    of the same 32 MiB (medians over one chain of each under
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
    dst = torch.empty_like(x)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        chain(x)
        torch.cuda.synchronize()
        for _ in range(HOP_CHAIN):
            dst.copy_(x)
        torch.cuda.synchronize()
    kernel = [ev.time_range.elapsed_us() / 1e3 for ev in prof.events()
              if ev.device_type == DeviceType.CUDA
              and "dma_permute_kernel" in ev.name]
    copies = [ev.time_range.elapsed_us() / 1e3 for ev in prof.events()
              if ev.device_type == DeviceType.CUDA
              and "dma_permute_kernel" not in ev.name]
    if not kernel or not copies:
        raise AssertionError("the profiler recorded no self-edge kernel "
                             "or copy_")
    rt.close()
    return {"chain_ms": statistics.median(hops),
            "enqueue_ms": statistics.median(enqueue),
            "kernel_ms": statistics.median(kernel), "profiled": len(kernel),
            "copy_ms": statistics.median(copies)}


def p2p(card: str) -> dict:
    """The reference program on the card: a world of 1 through
    ``cli.main`` (defaults, then ``--pattern latency``), then worlds of 2
    and 4 ranks sharing cuda:0 through the peer-push kernel."""
    for argv in ([], ["--pattern", "latency"]):
        cli_cell(argv)
    nccl_world1(card)
    device_clock_check(card)
    alone = p2p_self_edge()
    w2 = p2p_world(2, card, msg=P2P_MSG, iters=P2P_ITERS,
                   isolations=("full",), latency=True,
                   sizes=(136, P2P_MSG), timing=True, ring_msg=P2P_MSG,
                   ring_modes=("serialized", "device"))
    w4 = p2p_world(4, card, msg=P2P4_MSG, iters=P2P4_ITERS,
                   isolations=("full", "submesh"), latency=False,
                   sizes=(136, P2P4_MSG), timing=False, ring_msg=P2P4_MSG,
                   ring_modes=("serialized",))
    t4 = torus_world(card)
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
        f"{alone['profiled']} kernels it recorded of {HOP_CHAIN}; "
        f"{bound / alone['kernel_ms']:.3f} of the bound) beside copy_ "
        f"{alone['copy_ms']:.4f} ms of device time on the same 32 MiB "
        f"({alone['kernel_ms'] / alone['copy_ms']:.3f}x) | {card}")
    return {
        "name": "dma_permute", "route": "cuda",
        "source": "tpu_p2p_torch/csrc/p2p_dma.cu",
        "replaces": "tpu_p2p/parallel/pallas_dma.py:146 "
                    "(_dma_transport_permute_call; kernel body :166)",
        "launches": w2[0]["launches"],
        "edge_sets": "the six edge sets of tests/test_pallas_dma.py:101 "
                     "cut to 2 and 4 ranks (pairs, partial sets, empty, "
                     "full rings), 2x2 torus lines (full per-axis rings)",
        "max_abs_err": max(r["checks"]["max_abs_err"]
                           for r in w2 + w4 + t4),
        "ms": tm["hop_ms"], "plain_ms": tm["plain_ms"], "bound_ms": bound,
        "bound_by": "bytes", "library_ms": tm["library_ms"],
    }


# ------------------------------------------------------------ phase 9

MIGRATE_CHUNKS = 4                      # --migrate-chunks of the path
SHIP_CHUNK = (MODEL["stages"], 1, MODEL["kv_heads"],
              PAGE_LEN // MIGRATE_CHUNKS,
              MODEL["head_dim"])        # one page's migration chunk, bf16
GEMM = (256, 2048, 8192)                # token chunk x the FFN's first matrix
SHIP_TIMED = 25                         # timed calls a median is taken over
# How far an emitted token's dense logit may trail the dense maximum:
# the engine's logits p and the dense step's q differ by at most
# BF16_TOL (phase 6's limit), so the engine's argmax g has q[g] >=
# p[g] - BF16_TOL >= p[a] - BF16_TOL >= q[a] - 2 BF16_TOL, a = argmax q.
WITNESS_TOL = 2 * BF16_TOL


def local_meshes(n: int):
    """``n`` in-process ranks on cuda:0, and the same on the CPU (the
    plain version's mesh)."""
    from tpu_p2p_torch.parallel.runtime import LocalMesh

    return LocalMesh([torch.device("cuda", 0)] * n), LocalMesh(["cpu"] * n)


def ship_kernel_checks(n: int) -> dict:
    """``dma_ship_compute`` on ``n`` in-process ranks sharing cuda:0
    against its plain version (CPU copies) and ``expected_permute``,
    bitwise, over the six edge sets cut to ``n``: int8 at 136 B and bf16
    at one migration chunk, each with a float32 compute (``c @ w``) whose
    ``y`` must equal the same product on the side bitwise; then one
    backward pass, whose ship gradient must be the reverse hop."""
    from tpu_p2p_torch.parallel import collectives as C
    from tpu_p2p_torch.parallel import pallas_dma as PD

    mesh, cpu = local_meshes(n)
    dev = mesh.devices[0]
    gen = torch.Generator().manual_seed(n)
    payloads = {
        "int8 136 B": [torch.randint(-128, 128, (1, 136), generator=gen,
                                     dtype=torch.int8) for _ in range(n)],
        "bf16 " + "x".join(map(str, SHIP_CHUNK)): [
            torch.randn(SHIP_CHUNK, generator=gen).to(torch.bfloat16)
            for _ in range(n)],
    }
    w = torch.randn((136, 64), generator=gen).to(dev)
    bad, worst, made = [], 0.0, 0
    for name, edges in ((k, cut_edges(e, n)) for k, e in EDGE_SETS_8.items()):
        for what, rows in payloads.items():
            ops = [r.float().reshape(-1)[:136].reshape(1, 136).to(dev)
                   for r in rows]
            arr, y = PD.dma_ship_compute([r.to(dev) for r in rows], mesh,
                                         edges, lambda a: a @ w, ops)
            mesh.synchronize()
            made += n
            plain, _ = PD.dma_ship_compute(rows, cpu, edges, lambda a: a,
                                           rows)
            want = C.expected_permute(
                np.stack([r.float().numpy() for r in rows]), edges)
            for i in range(n):
                got = arr[i].cpu()
                worst = max(worst, (got.float() - plain[i].float())
                            .abs().max().item())
                if not (torch.equal(got, plain[i])
                        and np.array_equal(got.float().numpy(), want[i])
                        and torch.equal(y[i], ops[i] @ w)):
                    bad.append(f"{name} {what} rank {i}")
    xs = [torch.randn((5, 3), generator=gen).to(dev).requires_grad_(True)
          for _ in range(n)]
    edges = cut_edges(EDGE_SETS_8["partial"], n)
    arr, y = PD.dma_ship_compute(xs, mesh, edges, lambda a: a * 3, xs)
    sum((a * a).sum() + b.sum() for a, b in zip(arr, y)).backward()
    mesh.synchronize()
    made += 2 * n                            # the push, then the reverse hop
    rev = tuple((d, s) for s, d in edges)
    back = PD.dma_ppermute([2 * a.detach().cpu() for a in arr], cpu, rev)
    for i in range(n):
        if not torch.equal(xs[i].grad.cpu(), back[i] + 3):
            bad.append(f"backward rank {i}")
    mesh.close()
    return {"bad": bad, "max_abs_err": worst, "launches": made}


def device_ms(fn, calls: int = SHIP_TIMED) -> list:
    """Device ms of each of ``calls`` calls: the card first sleeps while
    the host issues the whole call, so the span between two events on
    the caller's stream is the call's device time, not its launch
    cost."""
    out = []
    for _ in range(calls + 2):
        torch.cuda._sleep(4_000_000)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        out.append(t0.elapsed_time(t1))
    return out[2:]


def ship_cases():
    """The fused ship of one migration chunk (edge (0, 1) on 2 ranks of
    cuda:0) with a real compute on each rank, a token chunk through the
    FFN's first matrix. → the two meshes, the ship's rows, and the three
    calls: the ship alone, the compute alone, both fused."""
    from tpu_p2p_torch.parallel import pallas_dma as PD

    mesh, cpu = local_meshes(2)
    dev = mesh.devices[0]
    gen = torch.Generator(device=dev).manual_seed(9)
    ship = [torch.randn(SHIP_CHUNK, generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(2)]
    m, k, f = GEMM
    a = [torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
         for _ in range(2)]
    b = torch.randn((k, f), generator=gen, device=dev).to(torch.bfloat16)
    edges = ((0, 1),)

    def ship_alone():
        PD.dma_ship_compute(ship, mesh, edges, lambda: None)

    def fused():
        PD.dma_ship_compute(ship, mesh, edges, lambda x: x @ b, a)

    def compute_alone():
        caller = torch.cuda.current_stream(dev)
        for i in range(2):
            mesh.streams[i].wait_stream(caller)
            with mesh.on(i):
                a[i] @ b
        for i in range(2):
            caller.wait_stream(mesh.streams[i])

    return mesh, cpu, ship, {"ship": ship_alone, "compute": compute_alone,
                             "fused": fused}


def ship_timing(card: str) -> dict:
    """:func:`ship_cases`' three calls, medians of ``SHIP_TIMED`` calls
    of device time; the overlap; the plain version (host) and one
    ``copy_`` of the chunk on the card."""
    from tpu_p2p_torch.parallel import pallas_dma as PD

    mesh, cpu, ship, calls = ship_cases()
    edges = ((0, 1),)
    m, k, f = GEMM
    times = {name: statistics.median(device_ms(fn))
             for name, fn in calls.items()}
    times["overlap"] = ((times["ship"] + times["compute"] - times["fused"])
                        / min(times["ship"], times["compute"]))
    rows = [r.cpu() for r in ship]
    plain = []
    for _ in range(5):
        t = time.perf_counter()
        PD.dma_ship_compute(rows, cpu, edges, lambda: None)
        plain.append((time.perf_counter() - t) * 1e3)
    plain_ms = statistics.median(plain)
    dst = torch.empty_like(ship[0])
    library = statistics.median(device_ms(lambda: dst.copy_(ship[0])))
    nbytes = ship[0].numel() * ship[0].element_size()
    # What the function must move: the real edge's source read once and
    # every rank's arrival written once (the dummy edge's is zeros).
    bound = (1 + 2) * nbytes / HBM_BYTES_PER_S * 1e3
    flops = 2 * m * k * f * 2
    say(f"kernel dma_ship @ one migration chunk {list(SHIP_CHUNK)} bf16 "
        f"({nbytes} B), edge (0, 1) on 2 in-process ranks of cuda:0, "
        f"compute [{m}, {k}] @ [{k}, {f}] bf16 on each rank: ship alone "
        f"{times['ship']:.4f} ms, compute alone {times['compute']:.4f} ms "
        f"({flops / times['compute'] / 1e9:.1f} TFLOP/s), fused "
        f"{times['fused']:.4f} ms, overlap (ship + compute - fused) / "
        f"min = {times['overlap']:.3f} (medians of {SHIP_TIMED} calls, "
        f"device time) | bound {bound:.5f} ms (bytes: source read + 2 "
        f"arrivals written at 3.35 TB/s), plain {plain_ms:.3f} ms (host "
        f"copies), copy_ {library:.4f} ms | {card}")
    mesh.close()
    return {**times, "plain_ms": plain_ms, "library_ms": library,
            "bound_ms": bound}


SHIP_PROFILED = 7                       # calls of each kind under the profiler


def calls_after_sleeps(prof, sleep=("spin", "sleep")) -> list:
    """The profiled device kernels as one list per call, each call being
    what ran after one ``torch.cuda._sleep`` and before the next:
    ``(name, start_us, end_us)`` sorted by start."""
    from torch.autograd import DeviceType

    evs = sorted(((ev.name, ev.time_range.start, ev.time_range.end)
                  for ev in prof.events()
                  if ev.device_type == DeviceType.CUDA),
                 key=lambda e: e[1])
    calls = []
    for e in evs:
        if any(k in e[0] for k in sleep):
            calls.append([])
        elif calls:
            calls[-1].append(e)
    return calls


def union_us(spans) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def ship_split(group) -> dict:
    """One profiled ship call (its kernels) split into µs: its device
    span (first kernel start to last kernel end), the time some push,
    arrival or compute kernel ran (each the union of its kernels'
    intervals), the idle time inside the span (no kernel at all), and
    the arrivals' spin: the part of each arrival kernel spent before the
    last push ended (it cannot end before the bytes it waits for)."""
    t0 = min(e[1] for e in group)
    kind = {"push": [], "arrive": [], "compute": []}
    for name, a, b in group:
        k = ("push" if "dma_ship_push" in name else
             "arrive" if "dma_ship_arrive" in name else "compute")
        kind[k].append((a - t0, b - t0))
    span = max(e[2] for e in group) - t0
    last_push = max((b for _, b in kind["push"]), default=0.0)
    out = {"span": span, "idle": span - union_us(
        [(a - t0, b - t0) for _, a, b in group])}
    out.update({k: union_us(v) for k, v in kind.items()})
    out["spin"] = sum(max(0.0, min(b, last_push) - a)
                      for a, b in kind["arrive"])
    out["timeline"] = " ".join(
        f"{k}@{a:.1f}-{b:.1f}" for k, v in kind.items() for a, b in sorted(v))
    return out


def ship_profile(card: str) -> dict:
    """``SHIP_PROFILED`` calls of :func:`ship_cases`' ship alone and fused
    under ``torch.profiler``, each issued whole while the card sleeps, so
    the gaps between its kernels are the card's own: per kind, the
    medians of :func:`ship_split`'s parts over the calls whose two pushes
    the profiler recorded, and the kernels of the call with the median
    span (µs from its first kernel). The same calls run once first as
    the profiler's warm-up cycle: the first events after tracing starts
    can be lost (a lost sleep merges or drops a call). :func:`ship` runs
    it in a process of its own: in a process minutes old the profiler
    loses and misplaces device events (PERF.md § 7)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    mesh, _, _, calls = ship_cases()
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    res = {}
    for name in ("ship", "fused"):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):                  # warm-up, then recorded
                for _ in range(SHIP_PROFILED):
                    torch.cuda._sleep(8_000_000)
                    calls[name]()
                    torch.cuda.synchronize()
                prof.step()
        splits = [ship_split(c) for c in calls_after_sleeps(prof)
                  if sum("dma_ship_push" in k[0] for k in c) == 2]
        if 2 * len(splits) < SHIP_PROFILED:
            raise AssertionError(f"the profiler recorded both pushes of "
                                 f"{len(splits)} of {SHIP_PROFILED} {name} "
                                 "calls")
        splits.sort(key=lambda s: s["span"])
        med = {k: statistics.median(s[k] for s in splits)
               for k in ("span", "push", "arrive", "compute", "idle",
                         "spin")}
        med["timeline"] = splits[len(splits) // 2]["timeline"]
        res[name] = med
        say(f"profile ship {name} (median of {len(splits)} calls, µs, "
            f"device time under torch.profiler): span {med['span']:.1f} = "
            f"kernels busy {med['span'] - med['idle']:.1f} + idle "
            f"{med['idle']:.1f} | push {med['push']:.1f}, arrival "
            f"{med['arrive']:.1f} (of it spinning before the last push "
            f"ended {med['spin']:.1f}), compute {med['compute']:.1f} | "
            f"median call: {med['timeline']} | {card}")
    mesh.close()
    return res


def short_trace(trace, n: int, max_new: int) -> list:
    """The first ``n`` requests of ``trace``, arriving at step 0 and
    generating ``max_new`` tokens: a warm-up or a profiled window of a
    few steps."""
    from tpu_p2p_torch.serve.batcher import Request

    return [Request(rid=r.rid, prompt=r.prompt, max_new=max_new)
            for r in trace[:n]]


def disagg_config(cfg, prefill_slots: int, transport: str, **kw):
    """Phase 7's geometry and trace, disaggregated: ``SLOTS`` decode
    slots over the decode ranks, ``prefill_slots`` on the prefill rank,
    the prefill pool sized for its slots and a full migration queue."""
    from tpu_p2p_torch.config import ServeConfig

    base = dataclasses.asdict(serve_config(cfg))
    base.update(disagg=True, prefill_tp=1, prefill_slots=prefill_slots,
                prefill_pages=(prefill_slots + SLOTS) * MAX_BLOCKS + 1,
                transport=transport, migrate_chunks=MIGRATE_CHUNKS)
    base.update(kw)
    return ServeConfig(**base)


def disagg_run(mesh, cfg, params, sc, trace, what: str, card: str) -> dict:
    """``run_disagg_engine`` on ``mesh``; raises unless every request
    finishes in full, the steps equal ``simulate_disagg_schedule`` and
    both pools drain full."""
    from tpu_p2p_torch.serve.disagg import (run_disagg_engine,
                                            simulate_disagg_schedule)

    sim = simulate_disagg_schedule(
        trace, slots=sc.slots, prefill_slots=sc.prefill_slots,
        page_len=sc.page_len, num_pages=sc.num_pages,
        prefill_pages=sc.prefill_pages, max_blocks=sc.max_blocks,
        chunk=sc.chunk, n_decode_shards=mesh.size - (sc.prefill_tp or 1),
        cfg=cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = run_disagg_engine(mesh, cfg, params, trace, sc=sc)
    torch.cuda.synchronize()
    b, fin = out["batcher"], out["finished"]
    if len(fin) != len(trace) or any(len(r.generated) != r.max_new
                                      for r in fin):
        raise AssertionError(f"{what}: {len(fin)}/{len(trace)} requests "
                             "finished in full")
    busy = out["steps"] - out["idle_steps"]
    if (busy, out["idle_steps"]) != (sim["busy_steps"], sim["idle_steps"]) \
            or out["migrate_events"] != sim["migrate_events"]:
        raise AssertionError(
            f"{what}: {busy} busy + {out['idle_steps']} idle steps, the dry "
            f"schedule says {sim['busy_steps']} + {sim['idle_steps']} (or "
            "the migrations differ)")
    if b.pool_p.available(0) != b.pool_p.capacity or any(
            b.pool_d.available(d) != b.pool_d.capacity
            for d in range(b.n_dec)):
        raise AssertionError(f"{what}: page leak")
    out["streams"] = {r.rid: list(r.generated) for r in fin}
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    mib = out["kv_migrate_bytes"] / 2**20
    step_ms = out["wall_s"] * 1e3 / max(out["steps"], 1)
    mig_ms = b.migrate_wall_s * 1e3 / max(out["kv_migrated"], 1)
    say(f"disagg {what}: {out['requests']} requests, {out['prompt_tokens']} "
        f"prompt + {out['gen_tokens']} generated tokens, {busy} steps "
        f"(= simulate_disagg_schedule) + {out['idle_steps']} idle | "
        f"{out['serve_tokens_per_s']} tokens/s ttft p50 "
        f"{out['serve_ttft_ms_p50']} ms p99 {out['serve_ttft_ms_p99']} ms | "
        f"per-token p50 {out['serve_tok_ms_p50']} ms p99 "
        f"{out['serve_tok_ms_p99']} ms | peak memory "
        f"{out['peak_gib']:.3f} GiB | wall {out['wall_s']} s | "
        f"kv_migrate: {out['kv_migrated']} migrations, "
        f"{out['kv_migrate_blocks']} pages ({mib:.2f} MiB, "
        f"{out['serve_kv_migrate_gbps']} Gbps, on-card copies), wait p50 "
        f"{out['migrate_wait_steps_p50']} max "
        f"{out['migrate_wait_steps_max']} steps | a step {step_ms:.1f} ms "
        f"of wall, a migration {mig_ms:.2f} ms (all migrations "
        f"{b.migrate_wall_s / out['wall_s']:.3f} of the wall) | {card}")
    return out


def expect_launches(counts: dict, out: dict, ranks: int, chunks: int,
                    what: str, srcs: int = 1) -> None:
    """Each migration ships K and V from each of ``srcs`` prefill ranks:
    ``chunks - 1`` fused ships and one last permute each, every call
    launching once per rank."""
    mig = out["kv_migrated"]
    want = {"dma_ship": mig * 2 * srcs * (chunks - 1) * ranks,
            "dma_permute": mig * 2 * srcs * ranks}
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want} "
                             f"({mig} migrations x 2 tensors x {srcs} "
                             f"prefill ranks x {ranks} "
                             f"ranks, {chunks} chunks)")


def dense_margins(cfg, params, seqs: list) -> list:
    """Teacher-force each ``(prompt, generated)`` of ``seqs`` (one a row,
    ``cfg.batch`` rows a pass) through the dense KV-cached decode step
    (phase 6: bitwise the paged step at chunk 1), independent of the
    batcher, the page tables and the migration. → per sequence, for
    each generated token, how far its dense logit trails the dense
    maximum, and how many tokens of the vocabulary lie within
    ``WITNESS_TOL`` of that maximum."""
    from tpu_p2p_torch.models import decode as D

    if len(seqs) > cfg.batch:
        return (dense_margins(cfg, params, seqs[:cfg.batch])
                + dense_margins(cfg, params, seqs[cfg.batch:]))
    dev = params["emb"].device
    full = [np.concatenate([p, g]).astype(np.int64) for p, g in seqs]
    steps = max(len(f) for f in full) - 1
    toks = np.zeros((cfg.batch, steps), np.int64)
    tgt = np.zeros((cfg.batch, steps), np.int64)
    emitted = np.zeros((cfg.batch, steps), bool)
    for r, ((p, g), f) in enumerate(zip(seqs, full)):
        toks[r, :len(f) - 1] = f[:-1]
        tgt[r, len(p) - 1:len(f) - 1] = g
        emitted[r, len(p) - 1:len(f) - 1] = True
    toks_d, tgt_d = (torch.from_numpy(a).to(dev) for a in (toks, tgt))
    step = D.make_flagship_lm_decode_step(cfg)
    cache = D.init_kv_cache(cfg, MAX_BLOCKS * PAGE_LEN, dev)
    margin = torch.zeros((cfg.batch, steps), device=dev)
    near = torch.zeros((cfg.batch, steps), device=dev)
    for t in range(steps):
        cache, lg = step(params, cache, toks_d[:, t:t + 1], t)
        lg = lg[:, 0].float()
        top = lg.max(-1).values
        margin[:, t] = top - lg.gather(1, tgt_d[:, t:t + 1])[:, 0]
        near[:, t] = (lg >= (top - WITNESS_TOL)[:, None]).sum(-1)
    margin, near = margin.cpu().numpy(), near.cpu().numpy()
    return [(margin[r][emitted[r]], near[r][emitted[r]])
            for r in range(len(seqs))]


def stream_witness(cfg, params, trace, runs: dict, card: str) -> None:
    """Every token of every stream in ``runs`` (name → {rid: tokens})
    against the dense decode step: its dense logit within
    ``WITNESS_TOL`` of the dense maximum, else the phase fails. Where
    two runs' streams part, both tokens must pass; the line shows the
    dense gap between them."""
    names = list(runs)
    seqs = [(np.asarray(r.prompt), np.asarray(runs[n][r.rid], np.int64))
            for n in names for r in trace]
    got = dense_margins(cfg, params, seqs)
    per = {n: dict(zip([r.rid for r in trace],
                       got[k * len(trace):(k + 1) * len(trace)]))
           for k, n in enumerate(names)}
    bad = [(n, rid, int(j), float(m[j])) for n in names
           for rid, (m, _) in per[n].items()
           for j in np.flatnonzero(m > WITNESS_TOL)]
    parts = []
    a, b = names[0], names[-1]
    for r in trace:
        sa, sb = runs[a][r.rid], runs[b][r.rid]
        if sa != sb:
            j = next(k for k, (x, y) in enumerate(zip(sa, sb)) if x != y)
            gap = abs(float(per[a][r.rid][0][j] - per[b][r.rid][0][j]))
            parts.append(f"rid {r.rid} at token {j}: {sa[j]} vs {sb[j]}, "
                         f"dense gap {gap:.3g}")
    for n in names:
        m = np.concatenate([v[0] for v in per[n].values()])
        c = np.concatenate([v[1] for v in per[n].values()])
        say(f"witness {n}: {m.size} tokens against the dense decode step, "
            f"dense logit below the max by at most {m.max():.3g} (tol "
            f"{WITNESS_TOL}), {int((m > 0).sum())} not the dense argmax; "
            f"tokens within tol of the max: mean {c.mean():.3f}, max "
            f"{int(c.max())} of {cfg.vocab} | {card}")
    say(f"witness {a} vs {b}: {len(parts)} streams part: "
        + ("; ".join(parts) or "none") + f" | {card}")
    if bad:
        raise AssertionError(f"tokens whose dense logit trails the max by "
                             f"more than {WITNESS_TOL}: {bad[:8]}")


def gemm_rows(card: str) -> None:
    """Does a row of the FFN's first product get the same bits in a
    prefill batch of 4 slots x chunk 8 as in the colocated batch of 32 x
    8? In float32 (the mixed step's widened FFN and unembed) and bf16."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    rows, k, f = SLOTS * CHUNK, MODEL["heads"] * MODEL["head_dim"], GEMM[2]
    x = torch.randn((rows, k), generator=gen, device=dev)
    w = torch.randn((k, f), generator=gen, device=dev)
    same = {}
    for name, dt in (("float32", torch.float32), ("bf16", torch.bfloat16)):
        xd, wd = x.to(dt), w.to(dt)
        full = xd @ wd
        part = xd[:4 * CHUNK] @ wd
        same[name] = (torch.equal(part, full[:4 * CHUNK]),
                      (part.float() - full[:4 * CHUNK].float()).abs()
                      .max().item())
    say(f"gemm rows: [{4 * CHUNK}, {k}] @ [{k}, {f}] vs the same rows of "
        f"[{rows}, {k}] @ [{k}, {f}]: " + ", ".join(
            f"{n} {'bitwise' if eq else 'differs'} (max abs {d:.3g})"
            for n, (eq, d) in same.items()) + f" | {card}")


def disagg(cfg, params, colocated: dict, card: str) -> dict:
    """The disaggregated engine through ``run_disagg_engine`` (what
    ``serve --disagg`` calls once it has its devices) at the full width:
    1 prefill + 1 decode rank sharing cuda:0, ``pallas_dma`` in
    ``MIGRATE_CHUNKS`` chunks, the launches counted; its streams against
    the same geometry over the library copy; then, with as many prefill
    as decode slots, against phase 7's colocated streams; then 1 prefill
    + 3 decode ranks at 2 blocks."""
    from tpu_p2p_torch.models.flagship import (STAGELESS_LEAVES,
                                               FlagshipConfig)
    from tpu_p2p_torch.parallel import pallas_dma as PD
    from tpu_p2p_torch.serve.disagg import run_disagg_engine
    from tpu_p2p_torch.serve.engine import synthetic_trace

    gemm_rows(card)
    mesh, _ = local_meshes(2)
    sc = disagg_config(cfg, 4, "pallas_dma")
    trace = synthetic_trace(sc)
    run_disagg_engine(mesh, cfg, params, short_trace(trace, 1, 2),
                      sc=sc)                                 # warm-up
    torch.cuda.synchronize()
    PD.reset_launches()
    run = disagg_run(mesh, cfg, params, sc, trace,
                     f"1+1 ranks on cuda:0, {SLOTS}+4 slots, pallas_dma "
                     f"x{MIGRATE_CHUNKS} chunks", card)
    counts = dict(PD.launches)
    expect_launches(counts, run, 2, MIGRATE_CHUNKS, "disagg 1+1")
    lib = disagg_run(mesh, cfg, params,
                     dataclasses.replace(sc, transport="xla"), trace,
                     f"1+1, {SLOTS}+4 slots, xla (copy_)", card)
    if lib["streams"] != run["streams"]:
        raise AssertionError("disagg streams differ between pallas_dma and "
                             "the library copy")
    wide = disagg_run(mesh, cfg, params, disagg_config(cfg, SLOTS,
                                                       "pallas_dma"),
                      trace, f"1+1, {SLOTS}+{SLOTS} slots, pallas_dma", card)
    if wide["streams"] != colocated:
        diff = [r for r in colocated if wide["streams"].get(r) != colocated[r]]
        raise AssertionError(f"disagg ({SLOTS}+{SLOTS} slots) vs colocated "
                             f"streams differ for requests {diff}")
    same = sum(run["streams"][r] == colocated[r] for r in colocated)
    mesh.close()
    stream_witness(cfg, params, trace,
                   {"colocated": colocated,
                    f"disagg {SLOTS}+4": run["streams"]}, card)
    say(f"disagg parity: {SLOTS}+4 slots pallas_dma == xla bitwise "
        f"({len(trace)}/{len(trace)} streams); {SLOTS}+{SLOTS} slots == "
        f"colocated continuous bitwise ({len(trace)}/{len(trace)}); "
        f"{SLOTS}+4 slots == colocated for {same}/{len(trace)} streams "
        "(a 4-slot prefill batch runs other cuBLAS float32 GEMM kernels "
        f"than a {SLOTS}-slot one) | launches {counts} (= migrations x 2 "
        f"x ranks x {MIGRATE_CHUNKS - 1} and x 1) | {card}")
    # 1 prefill + 3 decode: dummy edges, shard choice; 24 decode slots
    # (8 a replica) at 2 blocks, 8 requests.
    cut = FlagshipConfig(**{**dataclasses.asdict(cfg), "stages": 2})
    cut_params = {k: v if k in STAGELESS_LEAVES else v[:2]
                  for k, v in params.items()}       # the first 2 blocks
    mesh4, _ = local_meshes(4)
    sc4 = disagg_config(cut, 4, "pallas_dma", slots=24, requests=8,
                        num_pages=3 * (8 * 5 + 1),
                        prefill_pages=(4 + 24) * MAX_BLOCKS + 1)
    trace4 = synthetic_trace(sc4)
    PD.reset_launches()
    four = disagg_run(mesh4, cut, cut_params, sc4, trace4,
                      "1+3 ranks on cuda:0 (2 blocks, 24+4 slots), "
                      f"pallas_dma x{MIGRATE_CHUNKS}", card)
    counts4 = dict(PD.launches)
    expect_launches(counts4, four, 4, MIGRATE_CHUNKS, "disagg 1+3")
    shards = {e["dst_shard"] for e in four["migrate_events"]}
    lib4 = disagg_run(mesh4, cut, cut_params,
                      dataclasses.replace(sc4, transport="xla"), trace4,
                      "1+3, xla (copy_)", card)
    if lib4["streams"] != four["streams"]:
        raise AssertionError("1+3 streams differ between pallas_dma and the "
                             "library copy")
    mesh4.close()
    say(f"disagg 1+3: migrations to decode shards {sorted(shards)}, "
        f"pallas_dma == xla bitwise ({len(trace4)} streams), launches "
        f"{counts4} | {card}")
    profile_disagg(cfg, params, card)
    return {"launches": counts, "streams": run["streams"],
            "kv_migrate_bytes": run["kv_migrate_bytes"]}


DISAGG_FAMILIES = (
    ("ship push", ("dma_ship_push",)),
    ("ship arrival", ("dma_ship_arrive",)),
    ("permute", ("dma_permute",)),
    ("kv write", ("kv_rows",)),
) + KERNEL_FAMILIES


def profile_disagg(cfg, params, card: str) -> None:
    """A short disagg run under ``torch.profiler`` (phase 7's first 4
    prompts, 8 tokens each, 32+4 slots, pallas_dma x4): wall and device
    time a step, kernel time by family, and the device's idle share (the
    union of the kernels' intervals: two ranks' streams may overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpu_p2p_torch.serve.disagg import run_disagg_engine
    from tpu_p2p_torch.serve.engine import synthetic_trace

    mesh, _ = local_meshes(2)
    sc = disagg_config(cfg, 4, "pallas_dma")
    trace = short_trace(synthetic_trace(sc), 4, 8)
    run_disagg_engine(mesh, cfg, params, trace[:1], sc=sc)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run_disagg_engine(mesh, cfg, params, trace, sc=sc)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fam_ms, spans = {}, []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        tr = ev.time_range
        spans.append((tr.start, tr.end))
        family = next((f for f, keys in DISAGG_FAMILIES
                       if any(k in ev.name for k in keys)), "other")
        fam_ms[family] = fam_ms.get(family, 0.0) + tr.elapsed_us() / 1e3
    if not spans:
        raise AssertionError("the profiler recorded no device activity")
    busy_us = union_us(spans)
    steps = out["steps"]
    mesh.close()
    say(f"profile disagg (4 requests of 8 tokens, 32+4 slots, pallas_dma x"
        f"{MIGRATE_CHUNKS}, under the profiler): {steps} steps, "
        f"{out['kv_migrated']} migrations, wall {wall_ms:.1f} ms "
        f"({wall_ms / steps:.1f} a step), device busy {busy_us / 1e3:.1f} "
        f"ms ({busy_us / 1e3 / steps:.2f} a step), idle share "
        f"{1 - busy_us / 1e3 / wall_ms:.3f} | kernel ms by family: "
        + ", ".join(f"{f} {v:.2f}" for f, v in
                    sorted(fam_ms.items(), key=lambda kv: -kv[1]))
        + f" | {card}")


def ship(card: str, dis: dict) -> dict:
    """The kernel checks on 2 and 4 ranks, the timing, and the row of
    the kernels line."""
    from tpu_p2p_torch.parallel.launch import run_world

    checks = [ship_kernel_checks(n) for n in (2, 4)]
    for n, c in zip((2, 4), checks):
        if c["bad"]:
            raise AssertionError(f"dma_ship on {n} ranks vs plain/oracle: "
                                 f"{c['bad']}")
    say(f"kernel dma_ship: == plain (CPU copies) == expected_permute "
        f"bitwise on 2 and 4 in-process ranks of cuda:0 over 6 edge sets at "
        f"136 B int8 and {list(SHIP_CHUNK)} bf16, y == the product on the "
        f"side, backward == the reverse hop | {card}")
    tm = ship_timing(card)
    run_world(1, f"{__file__}:ship_profile", {"card": card}, timeout=300)
    return {
        "name": "dma_ship", "route": "cuda",
        "source": "tpu_p2p_torch/csrc/p2p_dma.cu",
        "replaces": "tpu_p2p/parallel/pallas_dma.py:280 "
                    "(_dma_transport_ship_call; kernel body :289)",
        "launches": dis["launches"]["dma_ship"],
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "ms": tm["ship"], "plain_ms": tm["plain_ms"],
        "bound_ms": tm["bound_ms"], "bound_by": "bytes",
        "library_ms": tm["library_ms"],
    }


# ----------------------------------------------------------- phase 10


RING_SIZES = (2, 4)
RING_VARIANTS = (("contiguous", None), ("zigzag", None),
                 ("contiguous", 1024), ("zigzag", 1024))


def ring_calls(n: int, t_local: int, layout: str, window,
               causal: bool = True) -> int:
    """Calls of each flash kernel a ring of ``n`` makes over all its
    ranks, forward or backward: every rank folds (or differentiates)
    ``live_ring_hops + 1`` blocks, each in four half x half calls under
    causal zigzag."""
    from tpu_p2p_torch.ops.attention import live_ring_hops

    per_block = 4 if layout == "zigzag" and causal else 1
    return n * (live_ring_hops(n, t_local, causal, layout, window) + 1) \
        * per_block


def ring_in_one_process(q, k, v, g, n: int, *, causal: bool, layout: str,
                        window, carry_block, bwd_block) -> tuple:
    """Every rank of a ring of ``n`` in this process, through
    ``ring_flash``'s per-hop steps: rank ``r`` holds block ``r`` of the
    sequence (``q, k, v, g`` are global ``[B, H, T, D]`` in the layout's
    order) and, at hop ``i``, the KV block of rank ``(r - i) % n``, as the
    ring hands each block to the next rank. The forward folds every live
    block into each rank's carry; the backward adds each rank's gradient
    terms into the block's traveling dK/dV (hop by hop, as the block
    visits the ranks in order) and the rank's dq. ``carry_block`` /
    ``bwd_block``: the kernels' wrappers or their plain twins. → global
    ``(out, dq, dk, dv)`` in the layout's order."""
    from tpu_p2p_torch.ops import ring_flash as RF
    from tpu_p2p_torch.ops.attention import NEG_INF, finalize, live_ring_hops
    from tpu_p2p_torch.ops.flash_attention import delta_of, logsumexp

    qs, ks, vs, gs = (x.chunk(n, dim=2) for x in (q, k, v, g))
    t = qs[0].shape[2]
    hops = live_ring_hops(n, t, causal, layout, window)
    kw = dict(causal=causal, layout=layout, window=window)
    outs, Ls = [], []
    for r in range(n):
        o = torch.zeros(qs[r].shape, dtype=torch.float32, device=q.device)
        m = torch.full(qs[r].shape[:3], NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        for i in range(hops + 1):
            src = (r - i) % n
            o, m, l = RF._accumulate(qs[r], ks[src], vs[src], o, m, l, r,
                                     src, n, carry_block=carry_block, **kw)
        outs.append(finalize(o, m, l, q.dtype))
        Ls.append(logsumexp(m, l))
    deltas = [delta_of(gs[r], outs[r]) for r in range(n)]
    dq = [torch.zeros(x.shape, dtype=torch.float32, device=q.device)
          for x in qs]
    dk = [torch.zeros(x.shape, dtype=torch.float32, device=q.device)
          for x in ks]
    dv = [torch.zeros_like(x) for x in dk]
    for i in range(hops + 1):
        for r in range(n):
            src = (r - i) % n
            RF._block_grads(dq[r], dk[src], dv[src], qs[r], ks[src],
                            vs[src], gs[r].to(q.dtype), Ls[r], deltas[r], r,
                            src, n, bwd_block=bwd_block, **kw)
    return tuple(torch.cat(parts, dim=2) for parts in (outs, dq, dk, dv))


def ring_on_one_card(TFA, dev, card) -> dict:
    """Phase 10, part 1: rings of 2 and 4 ranks at the training shape
    (B 4, 16 heads over 8 KV heads, T 4096, D 128, bf16, causal), every
    rank's forward folds and backward steps in this process, contiguous
    and zigzag, with and without a window of 1024: the assembled output
    and dq/dk/dv within FLASH_BF16_TOL (normalised L-inf) of the
    full-sequence flash kernels and of the plain versions of the same
    hop calls; each kernel launched as often as the ring makes it
    calls. → launches per kernel over all the rings."""
    from tpu_p2p_torch.ops.attention import from_zigzag, to_zigzag

    b, hq, hkv, t, d = (TRAIN["batch"], TRAIN["heads"], TRAIN["kv_heads"],
                        TRAIN["seq"], TRAIN["head_dim"])
    gen = torch.Generator(device=dev).manual_seed(10)
    bf = torch.bfloat16
    q, g = (torch.randn((b, hq, t, d), generator=gen, device=dev).to(bf)
            for _ in range(2))
    k, v = (torch.randn((b, hkv, t, d), generator=gen, device=dev).to(bf)
            for _ in range(2))
    total = dict.fromkeys(TFA.launches, 0)
    for window in (None, 1024):
        qf, kf, vf = (x.detach().requires_grad_(True) for x in (q, k, v))
        out = TFA.flash_attention(qf, kf, vf, True, window)
        full = (out,) + torch.autograd.grad(out, (qf, kf, vf), g)
        for n in RING_SIZES:
            for layout in ("contiguous", "zigzag"):
                args = [to_zigzag(x, n) if layout == "zigzag" else x
                        for x in (q, k, v, g)]
                kw = dict(causal=True, layout=layout, window=window)
                TFA.reset_launches()
                got = ring_in_one_process(
                    *args, n, carry_block=TFA.flash_carry_block,
                    bwd_block=TFA.flash_bwd_block, **kw)
                torch.cuda.synchronize()
                launches = dict(TFA.launches)
                plain = ring_in_one_process(
                    *args, n, carry_block=TFA.flash_carry_block_plain,
                    bwd_block=TFA.flash_bwd_block_plain, **kw)
                want_calls = ring_calls(n, t // n, layout, window)
                if any(c != want_calls for c in launches.values()):
                    raise AssertionError(
                        f"ring n={n} {layout} window {window}: launches "
                        f"{launches}, the ring makes {want_calls} of each")
                names = ("out", "dq", "dk", "dv")
                vs_plain = {nm: norm_err(a, p)
                            for nm, a, p in zip(names, got, plain)}
                if layout == "zigzag":
                    got = tuple(from_zigzag(x, n) for x in got)
                vs_full = {nm: norm_err(a, f)
                           for nm, a, f in zip(names, got, full)}
                bad = {f"{k} vs {w}": e
                       for w, errs in (("full", vs_full), ("plain", vs_plain))
                       for k, e in errs.items() if not e <= FLASH_BF16_TOL}
                if bad:
                    raise AssertionError(
                        f"ring n={n} {layout} window {window}: normalised "
                        f"L-inf {bad} > {FLASH_BF16_TOL}")
                for kname, c in launches.items():
                    total[kname] += c
                say(f"ring n={n} T_local {t // n} {layout} window {window}"
                    f": vs full-sequence kernels "
                    + ", ".join(f"{k} {e:.2e}" for k, e in vs_full.items())
                    + " | vs plain hop calls "
                    + ", ".join(f"{k} {e:.2e}" for k, e in vs_plain.items())
                    + f" (tol {FLASH_BF16_TOL}) | launches {launches} | "
                    f"{card}")
                del got, plain
                torch.cuda.empty_cache()
    return total


def train_world_of_one(TFA, dev, card, p50_single: float) -> dict:
    """Phase 10, part 2: ``run_training`` through the mesh code on a
    world of one (``make_runtime`` over the five axes, all of size 1) at
    the full width, 2 steps: phase 5's gates, every flash kernel once per
    block per step, and one profiled step in which the card runs no
    NCCL kernel (a size-1 axis launches nothing). → launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpu_p2p_torch.models.flagship import (
        AXES, FlagshipConfig, flagship_token_batch, init_flagship_params,
        make_flagship_lm_train_step, place_flagship_params)
    from tpu_p2p_torch.parallel.runtime import make_runtime

    cfg = FlagshipConfig(**TRAIN)
    rt = make_runtime(device=dev, mesh_shape=(1,) * len(AXES),
                      axis_names=AXES)
    try:
        run = run_train(cfg, 2, TFA, dev, mesh=rt.mesh)
        check_train_run(run, cfg, 2)
        ln_v = math.log(cfg.vocab)
        if not ln_v - 1 <= run["losses"][0] <= ln_v + 2:
            raise AssertionError(f"mesh train first loss {run['losses'][0]}")
        params = place_flagship_params(
            init_flagship_params(cfg, seed=0, device="cpu"), rt.mesh)
        toks, tgts = flagship_token_batch(cfg, seed=1, device=dev)
        step = make_flagship_lm_train_step(cfg, donate=True, mesh=rt.mesh)
        step(params, toks, tgts)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(params, toks, tgts)
            torch.cuda.synchronize()
        kernels = [ev.name for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA]
        if not kernels:
            raise AssertionError("the profiler saw no kernel in the step")
        nccl = sorted({k for k in kernels if "nccl" in k.lower()})
        if nccl:
            raise AssertionError(f"a world of one launched NCCL kernels in "
                                 f"the step: {nccl}")
        del params, step
    finally:
        rt.close()
    tokens = cfg.batch * cfg.seq
    ms = run["step_ms"][1]
    say(f"train on the mesh, a world of one (dp pp sp tp ep = 1 1 1 1 1, "
        f"flagship_large B{cfg.batch} T{cfg.seq}, bf16, flash): losses "
        f"{run['losses']} | step 2 {ms:.0f} ms = {tokens / ms * 1e3:.0f} "
        f"tokens/s (phase 5, no mesh: {p50_single:.0f} ms = "
        f"{tokens / p50_single * 1e3:.0f} tokens/s) | peak memory "
        f"{run['peak_gib']:.2f} GiB | {len(kernels)} kernels in a profiled "
        f"step, none of NCCL | flash launches {run['launches']} | {card}")
    return run["launches"]


# ----------------------------------------------------------- phase 11


MOE_TRAIN = {**TRAIN, "dense_ffn": False, "num_experts": 4}
MOE_TRAIN_STEPS = 3
MOE_NEAR_TIE = 1e-4      # router-logit margin below which a card/CPU flip
#                          is a rounding tie, not a fault


def _kept_by_expert(route, num_experts: int) -> torch.Tensor:
    """Kept slots ``[N, E]`` of each routing group's experts."""
    onehot = torch.nn.functional.one_hot(route.expert, num_experts)
    return (onehot * route.keep[..., None]).sum(dim=(1, 2))


def moe_layer(dev, card) -> dict:
    """Phase 11 (a): one MoE layer at flagship_large's width (Dm 2048, 4
    experts of 8192, 16384 bf16 tokens in groups of 256, capacity factor
    2) on the card against the port's CPU evaluation of the same inputs:
    the routing state (each token's expert, its slot, drops, kept slots
    a group and expert) equal, bar tokens whose top-1/top-2 router-logit
    margin is under ``MOE_NEAR_TIE``; the output within
    ``FLASH_BF16_TOL`` (normalised L-inf) on every other token. Then the
    layer's device time forward and forward + backward, beside its
    expert FFN alone (the two widened GEMMs, gelu and casts) at the same
    slot count. → timings."""
    from tpu_p2p_torch.models import moe as TM
    from tpu_p2p_torch.models.flagship import FlagshipConfig

    cfg = FlagshipConfig(**MOE_TRAIN).moe()
    tokens = MOE_TRAIN["batch"] * MOE_TRAIN["seq"]
    gs, e = cfg.group_size, cfg.num_experts
    ng, cap = tokens // gs, cfg.capacity(cfg.group_size)
    p_cpu = TM.init_moe_params(cfg, seed=0, dtype=torch.bfloat16)
    x_cpu = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (tokens, cfg.d_model))).to(torch.bfloat16)
    p_dev = {k: v.to(dev) for k, v in p_cpu.items()}
    x_dev = x_cpu.to(dev)

    def route(x, p):
        return TM._route(x.reshape(ng, gs, -1), p["router"], e, cap,
                         cfg.router_top_k)

    t0 = time.perf_counter()
    with torch.no_grad():
        r_dev, out_dev = route(x_dev, p_dev), TM.moe_layer_local(
            p_dev, x_dev, cfg)
        torch.cuda.synchronize()
        r_cpu, out_cpu = route(x_cpu, p_cpu), TM.moe_layer_local(
            p_cpu, x_cpu, cfg)
    cpu_s = time.perf_counter() - t0
    r_dev = TM.Route(*(t.cpu() for t in r_dev))
    top2 = (x_cpu.float() @ p_cpu["router"].float()).topk(2, dim=-1).values
    near = (top2[:, 0] - top2[:, 1] < MOE_NEAR_TIE).reshape(ng, gs)
    flipped = (r_dev.expert != r_cpu.expert).any(-1)
    if (flipped & ~near).any():
        raise AssertionError(
            f"moe routing: {int((flipped & ~near).sum())} tokens chose "
            f"another expert on the card with a router-logit margin >= "
            f"{MOE_NEAR_TIE}")
    kept_dev, kept_cpu = _kept_by_expert(r_dev, e), _kept_by_expert(r_cpu, e)
    drops = [int((~r.keep).sum()) for r in (r_dev, r_cpu)]
    if not flipped.any():
        same = (torch.equal(r_dev.pos, r_cpu.pos)
                and torch.equal(r_dev.keep, r_cpu.keep))
    else:
        # A flipped token moves one kept slot between its two experts.
        moved = torch.nn.functional.one_hot(r_dev.expert[..., 0], e) \
            - torch.nn.functional.one_hot(r_cpu.expert[..., 0], e)
        same = torch.equal(kept_dev, kept_cpu + (
            moved * flipped[..., None]).sum(1))
    if not same or drops[0] != drops[1]:
        raise AssertionError(
            f"moe routing state differs: drops {drops}, kept slots a "
            f"group and expert equal: {torch.equal(kept_dev, kept_cpu)}")
    ok = ~flipped.reshape(-1)
    err = norm_err(out_dev.cpu()[ok], out_cpu[ok])
    if not err <= FLASH_BF16_TOL:
        raise AssertionError(f"moe layer card vs CPU: normalised L-inf "
                             f"{err} > {FLASH_BF16_TOL}")
    del out_cpu, p_cpu, r_cpu

    p_grad = {k: v.detach().requires_grad_(True) for k, v in p_dev.items()}
    x_grad = x_dev.detach().requires_grad_(True)
    g_out = torch.randn_like(x_dev)
    slots = torch.randn((e, ng * cap, cfg.d_model), device=dev,
                        dtype=torch.bfloat16, requires_grad=True)
    g_slots = torch.randn_like(slots)

    def forward():
        with torch.no_grad():
            TM.moe_layer_local(p_dev, x_dev, cfg)

    def forward_backward():
        out = TM.moe_layer_local(p_grad, x_grad, cfg)
        torch.autograd.grad(out, [x_grad, *p_grad.values()], g_out)

    def experts():
        h = torch.nn.functional.gelu(
            torch.matmul(slots.float(), p_grad["w1"].float()),
            approximate="tanh")
        y = torch.matmul(h.to(slots.dtype).float(), p_grad["w2"].float())
        torch.autograd.grad(y.to(slots.dtype),
                            [slots, p_grad["w1"], p_grad["w2"]], g_slots)

    ms = {"forward": time_eager(forward, calls=5, warm=2),
          "forward_backward": time_eager(forward_backward, calls=3, warm=1),
          "experts_forward_backward": time_eager(experts, calls=3, warm=1)}
    gemm_flop = 3 * 2 * 2 * (e * ng * cap) * cfg.d_model * cfg.d_ff
    kept = int(kept_dev.sum())
    say(f"moe layer (Dm {cfg.d_model}, {e} experts of {cfg.d_ff}, {tokens} "
        f"bf16 tokens, groups of {gs}, capacity {cap} a group and expert): "
        f"routing state equal to the CPU's (kept {kept} of {tokens}, drops "
        f"{drops[0]}; {int(near.sum())} tokens under the {MOE_NEAR_TIE} "
        f"router-logit margin, {int(flipped.sum())} of them flipped) | "
        f"output vs CPU normalised L-inf {err:.2e} (tol {FLASH_BF16_TOL}; "
        f"CPU pass {cpu_s:.1f} s) | forward {ms['forward']:.2f} ms, "
        f"forward + backward {ms['forward_backward']:.2f} ms, of it the "
        f"expert FFN {ms['experts_forward_backward']:.2f} ms "
        f"({ms['experts_forward_backward'] / ms['forward_backward']:.3f}; "
        f"{gemm_flop / ms['experts_forward_backward'] / 1e9:.1f} TFLOP/s "
        f"on {gemm_flop / 1e12:.2f} TFLOP of widened float32 GEMMs, "
        f"bound {gemm_flop / F32_FLOPS_PER_S * 1e3:.1f} ms at the float32 "
        f"peak) | {card}")
    return ms


def moe_train(TFA, dev, card) -> dict:
    """Phase 11 (b): ``run_training`` at the full width with the MoE FFN
    (4 experts, capacity factor 2, top-1, groups of 256): phase 5's
    gates, step ms, tokens/s, peak memory. → launches, step ms."""
    from tpu_p2p_torch.models.flagship import FlagshipConfig

    cfg = FlagshipConfig(**MOE_TRAIN)
    run = run_train(cfg, MOE_TRAIN_STEPS, TFA, dev)
    check_train_run(run, cfg, MOE_TRAIN_STEPS)
    ln_v = math.log(cfg.vocab)
    if not ln_v - 1 <= run["losses"][0] <= ln_v + 2:
        raise AssertionError(f"moe train first loss {run['losses'][0]} "
                             f"outside [{ln_v - 1}, {ln_v + 2}]")
    p50 = statistics.median(run["step_ms"][1:])
    tokens = cfg.batch * cfg.seq
    say(f"train flagship_large MoE ({cfg.num_experts} experts of "
        f"{cfg.moe_mult}x, capacity factor {cfg.capacity_factor}, top-1, "
        f"groups of 256; B{cfg.batch} T{cfg.seq}, {cfg.stages} blocks, "
        f"bf16, flash, SGD lr 1e-2, seed 0): losses {run['losses']} | step "
        f"ms {[round(x) for x in run['step_ms']]}, p50 of steps 2-"
        f"{MOE_TRAIN_STEPS} {p50:.0f} ms = {tokens / p50 * 1e3:.0f} "
        f"tokens/s | peak memory {run['peak_gib']:.2f} GiB | flash "
        f"launches {run['launches']} | {card}")
    return {"launches": run["launches"], "step_ms_p50": p50,
            "peak_gib": run["peak_gib"]}


def moe_decode(TK, dev, card) -> dict:
    """Phase 11 (c): the MoE model's dense-cache decode against its paged
    step at chunk 1 (phase 6's check) on ``SLOTS`` slots. → launches."""
    from tpu_p2p_torch.models.flagship import FlagshipConfig

    cfg = FlagshipConfig(batch=SLOTS, **{**MODEL, "dense_ffn": False,
                                         "num_experts": 4})
    params = card_params(cfg, dev)  # both sides take these params: no
    # host init of 1.24 G draws
    dec = decode_parity(cfg, params, dev, TK)
    say(f"moe decode: paged (chunk 1) vs dense over {DECODE_POSITIONS} "
        f"positions x {SLOTS} slots ({cfg.num_experts} experts, "
        f"{sum(p.numel() for p in params.values()) / 1e6:.1f} M "
        f"parameters): max abs diff {dec['max_abs_diff']} (tol "
        f"{BF16_TOL}), bitwise {dec['bitwise']} | launches "
        f"{dec['launches']} | {card}")
    return dec["launches"]


def moe(TFA, TK, dev, card) -> dict:
    """Phase 11: the MoE FFN on the card. → each part's launches."""
    t0 = time.perf_counter()
    moe_layer(dev, card)
    torch.cuda.empty_cache()
    trn = moe_train(TFA, dev, card)
    torch.cuda.empty_cache()
    dec = moe_decode(TK, dev, card)
    torch.cuda.empty_cache()
    say(f"phase 11 (moe): {time.perf_counter() - t0:.1f} s")
    return {"train": trn["launches"], "decode": dec,
            "train_peak_gib": trn["peak_gib"]}


# ----------------------------------------------------------- phase 12


MEMORY_STEPS = 2
REMAT_POLICY = "dots_with_no_batch_dims_saveable"


def direct_steps(cfg, host_params, batches, TFA, dev, mesh=None) -> dict:
    """``MEMORY_STEPS`` LM steps of ``cfg`` (on ``mesh`` when given) from
    a device copy of ``host_params`` over ``batches`` → the unrounded
    losses, the flash launches, peak memory and per-step ms."""
    from tpu_p2p_torch.models.flagship import (
        make_flagship_lm_train_step, place_flagship_params)

    fresh = {k: v.clone() for k, v in host_params.items()}  # the step
    # updates its params in place
    params = place_flagship_params(fresh, mesh, cfg) if mesh \
        else {k: v.to(dev) for k, v in fresh.items()}
    step = make_flagship_lm_train_step(cfg, donate=True, mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    TFA.reset_launches()
    losses, ms = [], []
    for toks, tgts in batches:
        t0 = time.perf_counter()
        params, loss = step(params, toks, tgts)
        losses.append(loss.float().cpu())
        ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    out = {"losses": torch.stack(losses), "launches": dict(TFA.launches),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "step_ms": ms}
    del params, step
    torch.cuda.empty_cache()
    return out


def loss_gate(got: torch.Tensor, want: torch.Tensor, what: str) -> str:
    """Bitwise, or else the relative difference printed and held within
    1e-6."""
    if torch.equal(got, want):
        return "bitwise"
    rel = ((got.double() - want.double()).abs()
           / want.double().abs()).max().item()
    say(f"{what}: losses {got.tolist()} vs {want.tolist()}, max relative "
        f"difference {rel:.3e}")
    if not rel <= 1e-6:
        raise AssertionError(f"{what}: losses differ by {rel:.3e} relative "
                             "(> 1e-6)")
    return f"max relative difference {rel:.3e}"


def memory_dense(TFA, dev, card) -> dict:
    """Phase 12 (a) and (c): the dense step at the full width, plain,
    with ``remat=True``, and with ``zero_dp=True`` through the mesh code
    on a world of one, each ``MEMORY_STEPS`` steps from the same params
    over the same batches. → each run's launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpu_p2p_torch.models.flagship import (
        AXES, FlagshipConfig, _fsdp_plan, init_flagship_params,
        make_flagship_lm_train_step, place_flagship_params)
    from tpu_p2p_torch.parallel.runtime import make_runtime
    from tpu_p2p_torch.train import _per_step_batches

    cfg = FlagshipConfig(**TRAIN)
    host = init_flagship_params(cfg, seed=0, device="cpu")
    stream = _per_step_batches(cfg, 0, 0)
    batches = [tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in next(stream)) for _ in range(MEMORY_STEPS)]
    plain = direct_steps(cfg, host, batches, TFA, dev)
    check_launches(plain["launches"], cfg, MEMORY_STEPS)
    rcfg = dataclasses.replace(cfg, remat=True)
    remat = direct_steps(rcfg, host, batches, TFA, dev)
    check_launches(remat["launches"], rcfg, MEMORY_STEPS)
    remat_gate = loss_gate(remat["losses"], plain["losses"], "dense remat")
    zcfg = dataclasses.replace(cfg, zero_dp=True)
    rt = make_runtime(device=dev, mesh_shape=(1,) * len(AXES),
                      axis_names=AXES)
    try:
        if _fsdp_plan(rt.mesh, zcfg) is not None:
            raise AssertionError("zero_dp on a world of one planned shards")
        zero = direct_steps(zcfg, host, batches, TFA, dev, mesh=rt.mesh)
        check_launches(zero["launches"], zcfg, MEMORY_STEPS)
        if not torch.equal(zero["losses"], plain["losses"]):
            raise AssertionError(
                f"zero_dp on a world of one: losses {zero['losses']} != "
                f"the plain step's {plain['losses']}")
        params = place_flagship_params(
            {k: v.clone() for k, v in host.items()}, rt.mesh, zcfg)
        step = make_flagship_lm_train_step(zcfg, donate=True, mesh=rt.mesh)
        step(params, *batches[0])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(params, *batches[1])
            torch.cuda.synchronize()
        kernels = [ev.name for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA]
        nccl = sorted({k for k in kernels if "nccl" in k.lower()})
        if not kernels or nccl:
            raise AssertionError(f"zero_dp world of one: {len(kernels)} "
                                 f"kernels, NCCL among them: {nccl}")
        del params, step
    finally:
        rt.close()
    torch.cuda.empty_cache()
    tokens = cfg.batch * cfg.seq
    for what, run in (("plain", plain), ("remat", remat),
                      ("zero_dp world of one", zero)):
        say(f"memory dense {what} (flagship_large B{cfg.batch} "
            f"T{cfg.seq}, bf16, flash, {MEMORY_STEPS} steps): losses "
            f"{run['losses'].tolist()} | step ms "
            f"{[round(x) for x in run['step_ms']]}, step 2 "
            f"{run['step_ms'][-1]:.0f} ms = "
            f"{tokens / run['step_ms'][-1] * 1e3:.0f} tokens/s | peak "
            f"memory {run['peak_gib']:.2f} GiB | flash launches "
            f"{run['launches']} | {card}")
    say(f"memory dense: remat losses vs plain {remat_gate}; zero_dp on a "
        f"world of one: empty plan, losses bitwise, {len(kernels)} kernels "
        f"in a profiled step, none of NCCL | {card}")
    return {"remat": remat["launches"], "zero": zero["launches"]}


def memory_moe(TFA, dev, card, plain_peak: float) -> dict:
    """Phase 12 (b): the LM train step with the MoE FFN (phase 11's
    config) under ``remat=True`` and under ``remat_policy=
    REMAT_POLICY``, ``MEMORY_STEPS`` steps each from one set of
    :func:`card_params` over the training loop's batches, with phase 5's
    gates; each peak must stay below phase 11's plain MoE peak. →
    launches."""
    from tpu_p2p_torch.models.flagship import FlagshipConfig
    from tpu_p2p_torch.train import _per_step_batches

    out = {}
    tokens = MOE_TRAIN["batch"] * MOE_TRAIN["seq"]
    # Host copies, so a run's peak counts its own params alone.
    start = {k: v.cpu() for k, v in
             card_params(FlagshipConfig(**MOE_TRAIN), dev).items()}
    stream = _per_step_batches(FlagshipConfig(**MOE_TRAIN), 0, 0)
    batches = [tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in next(stream)) for _ in range(MEMORY_STEPS)]
    for what, policy in (("remat", ""), ("remat_policy", REMAT_POLICY)):
        cfg = FlagshipConfig(**MOE_TRAIN, remat=True, remat_policy=policy)
        run = direct_steps(cfg, start, batches, TFA, dev)
        run["losses"] = run["losses"].tolist()
        check_train_run(run, cfg, MEMORY_STEPS)
        ln_v = math.log(cfg.vocab)
        if not ln_v - 1 <= run["losses"][0] <= ln_v + 2:
            raise AssertionError(f"moe {what} first loss {run['losses'][0]}")
        if not run["peak_gib"] < plain_peak:
            raise AssertionError(
                f"moe {what}: peak {run['peak_gib']:.2f} GiB not below the "
                f"plain MoE step's {plain_peak:.2f} GiB")
        ms = run["step_ms"][-1]
        say(f"memory moe {what}{' ' + policy if policy else ''} "
            f"(flagship_large MoE, B{cfg.batch} T{cfg.seq}, {MEMORY_STEPS} "
            f"steps): losses {run['losses']} | step ms "
            f"{[round(x) for x in run['step_ms']]}, step 2 {ms:.0f} ms = "
            f"{tokens / ms * 1e3:.0f} tokens/s | peak memory "
            f"{run['peak_gib']:.2f} GiB (plain, phase 11: {plain_peak:.2f}) "
            f"| flash launches {run['launches']} | {card}")
        out[what] = run["launches"]
        torch.cuda.empty_cache()
    return out


def memory(TFA, dev, card, moe_peak: float) -> dict:
    """Phase 12: rematerialization and ZeRO storage on one card. → each
    run's flash launches."""
    t0 = time.perf_counter()
    out = memory_dense(TFA, dev, card)
    out.update(("moe_" + k, v)
               for k, v in memory_moe(TFA, dev, card, moe_peak).items())
    say(f"phase 12 (memory): {time.perf_counter() - t0:.1f} s")
    return out


# ----------------------------------------------------------- phase 13


SP_WIDTH = dict(batch=4, heads=16, seq=4096, head_dim=128)  # flagship_large's
# attention (bench.py:545-550), without GQA: the SP patterns' q, k and v
# carry the same heads
SP_WINDOW = 1024
SP_ITERS = 20


def sp_runs():
    """The SP workloads at ``SP_WIDTH``: (pattern, workload, builder,
    window), shared with ``collectives_cards.py``."""
    from tpu_p2p_torch.ops import attention as A
    from tpu_p2p_torch.ops import ulysses as U
    from tpu_p2p_torch.workloads.ring_attn import run_ring_attention
    from tpu_p2p_torch.workloads.ulysses_attn import run_ulysses_attention

    return (("ring_attention", run_ring_attention, A.ring_attention, 0),
            ("ring_attention", run_ring_attention, A.ring_attention,
             SP_WINDOW),
            ("ulysses_attention", run_ulysses_attention,
             U.ulysses_attention, 0))


STEP_ITERS = 3                   # flagship_step timed steps (+1 warm-up)
STEP_TOL = 0.10                  # pattern p50 vs the same step called alone
RT_LOSS_TOL = 1e-2               # card bf16 vs CPU float32, first loss


def counted(TFA, fn, launches: dict):
    """``fn()`` with the flash counts set to 0 just before and read just
    after, added into ``launches`` → its result."""
    torch.cuda.synchronize()
    TFA.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    for k, v in TFA.launches.items():
        launches[k] = launches.get(k, 0) + v
    return out


def trace_kernels(path: str) -> list:
    """The kernel names of a ``--profile-dir`` trace."""
    with open(path) as fh:
        return [e["name"] for e in json.load(fh)["traceEvents"]
                if e.get("cat") == "kernel"]


SP_LINE = re.compile(r"p50 ([0-9.]+)ms/step +([0-9.]+) TFLOP/s")


def sp_cli(TFA, launches: dict, card: str) -> None:
    """Phase 13 (a), at the CLI's defaults (B 8, H 8, T 512, D 64, bf16,
    causal) on a world of one: each command exits 0 and prints a line
    that parses, its trace holds the flash forward kernel and no NCCL
    kernel (the line has one rank), and the forward launches once a
    call (warm-up included)."""
    import tempfile

    cmds = (["--pattern", "ring_attention", "--flash"],
            ["--pattern", "ulysses_attention", "--flash"],
            ["--pattern", "ring_attention", "--flash", "--attn-window",
             "128"])
    iters = 8
    for argv in cmds:
        with tempfile.TemporaryDirectory(prefix="smoke_sp_") as td:
            mine = {}
            out, _ = counted(TFA, lambda: cli_cell(
                [*argv, "--iters", str(iters), "--profile-dir", td]), mine)
            kernels = trace_kernels(os.path.join(td, "rank0.trace.json"))
        m = SP_LINE.search(out)
        if not m or not float(m.group(1)) > 0:
            raise AssertionError(f"{argv}: unparsed line {out!r}")
        nccl = sorted({k for k in kernels if "nccl" in k.lower()})
        flash = [k for k in kernels if "flash_fwd" in k]
        calls = iters + 1
        # The wrapper's count is the launch count. One run's trace lacked
        # one launch the wrapper counted, for a cause not found, so the
        # trace only has to hold the kernel.
        if nccl or not flash or mine["flash_fwd"] != calls:
            raise AssertionError(
                f"{argv}: NCCL kernels {nccl}, flash kernels in the trace "
                f"{len(flash)}, launches {mine}, expected {calls} a call")
        for k, v in mine.items():
            launches[k] = launches.get(k, 0) + v
        say(f"patterns cli {' '.join(argv)}: p50 {m.group(1)} ms, "
            f"{m.group(2)} TFLOP/s (under the profiler) | flash forward "
            f"{mine['flash_fwd'] / calls:g} launch a call, {len(kernels)} "
            f"kernels in the trace ({len(flash)} of them flash), none of "
            f"NCCL | {card}")


def sp_width(TFA, dev, launches: dict, row3_ms: float, card: str) -> dict:
    """Phase 13 (a), at flagship_large's attention width on a world of
    one: ``ring_attention`` (no window, window 1024) and
    ``ulysses_attention`` with ``--flash`` through their workloads, then
    each attention function's flash output against its plain path on the same
    inputs (normalised L-inf <= 2e-2, those calls not counted). → name →
    (p50 ms, TFLOP/s)."""
    from tpu_p2p_torch.config import BenchConfig
    from tpu_p2p_torch.models.ring_transformer import ModelConfig
    from tpu_p2p_torch.ops import attention as A
    from tpu_p2p_torch.parallel.runtime import make_runtime
    from tpu_p2p_torch.workloads.base import WorkloadContext

    mc = ModelConfig(**SP_WIDTH)
    b, h, t, d = mc.batch, mc.heads, mc.seq, mc.head_dim
    g = torch.Generator(device=dev).manual_seed(13)
    q, k, v = (torch.randn((b, h, t, d), generator=g, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    rt = make_runtime(device=dev)
    out = {}
    try:
        for pattern, run, build, window in sp_runs():
            cfg = BenchConfig(pattern=pattern, use_flash=True,
                              attn_window=window, iters=SP_ITERS)
            ctx = WorkloadContext(rt=rt, cfg=cfg)
            mine = {}
            res = counted(TFA, lambda: run(ctx, mc), mine)
            calls = SP_ITERS + 1
            if mine["flash_fwd"] != calls:
                raise AssertionError(f"{pattern} W{window}: launches {mine},"
                                     f" expected {calls}")
            for key, n in mine.items():
                launches[key] = launches.get(key, 0) + n
            w = window or None
            fn = build(rt.mesh, "d", True, use_flash=True, window=w)
            got = fn(q, k, v)
            want = build(rt.mesh, "d", True, use_flash=False,
                         window=w)(q, k, v)
            err = norm_err(got, want)
            del got, want
            torch.cuda.empty_cache()
            if not err <= FLASH_BF16_TOL:
                raise AssertionError(f"{pattern} W{window}: flash vs plain "
                                     f"{err:.3e} > {FLASH_BF16_TOL}")
            # Where the pattern's time goes: the function's call from a
            # host loop (no sync a call), and the kernel alone at this
            # shape from a zero carry.
            loop_ms = time_eager(lambda: fn(q, k, v), calls=10)
            q3, k3, v3 = (x.reshape(b * h, t, d) for x in (q, k, v))
            carry = TFA.zero_carry(b * h, t, d, dev)
            alone_ms = time_eager(lambda: TFA._flash_call(
                q3, k3, v3, *carry, causal=True, q_heads=h, window=w),
                calls=10)
            flops = A.flops_per_step(b, h, t, d, causal=True, window=w)
            name = f"{pattern}{f' W{window}' if window else ''}"
            out[name] = (res["p50_ms"], res["tflops"])
            say(f"patterns {name} --flash @ B{b} H{h} T{t} D{d} bf16 "
                f"causal, world of one: p50 {res['p50_ms']:.3f} ms, "
                f"{res['tflops']:.1f} TFLOP/s ({flops / 1e12:.4f} TFLOP a "
                f"step; a sync a call) | the call from a host loop "
                f"{loop_ms:.3f} ms | the forward kernel alone at H{h}/{h} "
                f"{alone_ms:.3f} ms = {flops / alone_ms / 1e9:.1f} TFLOP/s;"
                f" at B{TRAIN['batch']} H{TRAIN['heads']}/"
                f"{TRAIN['kv_heads']}, causal, no window (phase 4) "
                f"{row3_ms:.3f} ms | flash vs plain {err:.2e} (tol "
                f"{FLASH_BF16_TOL}) | flash forward "
                f"{mine['flash_fwd'] / calls:g} launch a call | {card}")
    finally:
        rt.close()
    return out


def ring_transformer(TFA, dev, launches: dict, card: str) -> None:
    """Phase 13 (b): the RingTransformer at ``ModelConfig()``'s width
    (B 8, T 512, 8 heads x 64, mlp_mult 4, bf16) on a (dp, sp, tp) mesh
    of one rank: ``make_forward`` with ``use_flash`` against the same
    forward without it (2e-2), then 3 SGD steps of ``make_train_step``
    (the forward without the flash kernels, as the reference's step):
    finite losses, the first within 1e-2 relative of the port's CPU
    float32 evaluation of the same params and batch."""
    from tpu_p2p_torch.models import ring_transformer as M
    from tpu_p2p_torch.parallel.runtime import make_runtime

    cfg = M.ModelConfig()
    rt = make_runtime(device=dev, mesh_shape=(1, 1, 1),
                      axis_names=("dp", "sp", "tp"))
    try:
        mesh = rt.mesh
        params = M.init_params(cfg, seed=0, device=dev)
        x, t = M.example_batch(cfg, mesh, seed=1)
        mine = {}
        got = counted(TFA, lambda: M.make_forward(
            mesh, dataclasses.replace(cfg, use_flash=True))(params, x), mine)
        if mine["flash_fwd"] != 1:
            raise AssertionError(f"ring transformer forward: {mine}")
        want = M.make_forward(mesh, cfg)(params, x)
        err = norm_err(got, want)
        if not err <= FLASH_BF16_TOL:
            raise AssertionError(f"ring transformer flash forward vs plain "
                                 f"{err:.3e} > {FLASH_BF16_TOL}")
        f32 = dataclasses.replace(cfg, dtype="float32")
        _, cpu_loss = M.make_train_step(None, f32)(
            {k: v.float().cpu() for k, v in params.items()},
            x.float().cpu(), t.float().cpu())
        step = M.make_train_step(mesh, cfg)
        losses = []

        def steps():
            nonlocal params
            for _ in range(3):
                params, loss = step(params, x, t)
                losses.append(loss.item())

        counted(TFA, steps, mine)
        rel = abs(losses[0] - cpu_loss.item()) / abs(cpu_loss.item())
        if not all(math.isfinite(v) for v in losses) or not rel <= \
                RT_LOSS_TOL:
            raise AssertionError(f"ring transformer losses {losses}, CPU "
                                 f"float32 {cpu_loss.item()} (rel {rel:.2e})")
        for key, n in mine.items():
            launches[key] = launches.get(key, 0) + n
    finally:
        rt.close()
    say(f"patterns RingTransformer (B{cfg.batch} T{cfg.seq} H{cfg.heads}x"
        f"{cfg.head_dim} mlp {cfg.mlp_mult} bf16, mesh dp sp tp = 1 1 1): "
        f"flash forward vs plain {err:.2e} (tol {FLASH_BF16_TOL}); SGD "
        f"losses {losses}, first vs CPU float32 {cpu_loss.item():.6f}: "
        f"{rel:.2e} (tol {RT_LOSS_TOL}) | flash launches {mine} | {card}")


def flagship_pattern(TFA, dev, launches: dict, lm_step_ms: float,
                     card: str) -> None:
    """Phase 13 (c): ``--pattern flagship_step`` at the CLI's tiny
    defaults in float32 and bfloat16; then the workload at phase 5's
    width (``TRAIN`` without the vocabulary: the pattern trains the
    block stack on the regression objective), whose p50 must lie within
    10 % of the same step called alone, each flash kernel launched once
    a block a step; then with ``zero_dp`` and ``overlap="prefetch"`` on
    the world of one: an empty ZeRO plan and no NCCL kernel in the
    profiled run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpu_p2p_torch.config import BenchConfig
    from tpu_p2p_torch.models import flagship as F
    from tpu_p2p_torch.parallel.runtime import make_runtime
    from tpu_p2p_torch.workloads.base import WorkloadContext
    from tpu_p2p_torch.workloads.flagship_step import run_flagship_step

    for dtype in ("float32", "bfloat16"):
        out, _ = counted(TFA, lambda: cli_cell(
            ["--pattern", "flagship_step", "--dtype", dtype, "--iters",
             "4"]), launches)
        if "flagship_step mesh {'dp': 1, 'pp': 1, 'sp': 1, 'tp': 1, " \
                "'ep': 1}" not in out or "tokens/s" not in out:
            raise AssertionError(f"flagship_step {dtype}: {out!r}")
    cfg = F.FlagshipConfig(**{**TRAIN, "vocab": 0})
    zcfg = dataclasses.replace(cfg, zero_dp=True, overlap="prefetch")
    steps = STEP_ITERS + 1
    rt = make_runtime(device=dev)
    try:
        ctx = WorkloadContext(rt=rt, cfg=BenchConfig(
            pattern="flagship_step", iters=STEP_ITERS))
        mine = {}
        res = counted(TFA, lambda: run_flagship_step(ctx, cfg), mine)
        check_launches(mine, cfg, steps)
        if not math.isfinite(res["loss"]):
            raise AssertionError(f"flagship_step TRAIN: loss {res['loss']}")
        for key, n in mine.items():
            launches[key] = launches.get(key, 0) + n
        # The same step called alone, from the same params and batch.
        params = F.init_flagship_params(cfg, device=dev)
        x, t = (a.to(dev) for a in F.flagship_host_batch(
            cfg, np.random.default_rng(1)))
        step = F.make_flagship_train_step(cfg)
        alone = []
        for _ in range(steps):
            t0 = time.perf_counter()
            params, loss = step(params, x, t)
            loss.item()
            alone.append((time.perf_counter() - t0) * 1e3)
        del params, step
        torch.cuda.empty_cache()
        alone_ms = statistics.median(alone[1:])
        if not abs(res["p50_ms"] - alone_ms) <= STEP_TOL * alone_ms:
            raise AssertionError(f"flagship_step p50 {res['p50_ms']:.1f} ms"
                                 f" vs the step alone {alone_ms:.1f} ms")
        mesh = F.build_mesh(1, runtime=rt)
        if F._fsdp_plan(mesh, zcfg) is not None:
            raise AssertionError("zero_dp on a world of one planned shards")
        zmine = {}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            zres = counted(TFA, lambda: run_flagship_step(ctx, zcfg), zmine)
        kernels = [ev.name for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA]
        nccl = sorted({k for k in kernels if "nccl" in k.lower()})
        check_launches(zmine, zcfg, steps)
        if not kernels or nccl:
            raise AssertionError(f"flagship_step zero_dp + prefetch, world "
                                 f"of one: {len(kernels)} kernels, NCCL "
                                 f"{nccl}")
        for key, n in zmine.items():
            launches[key] = launches.get(key, 0) + n
    finally:
        rt.close()
    tokens = cfg.batch * cfg.seq
    say(f"patterns flagship_step (flagship_large blocks, B{cfg.batch} "
        f"T{cfg.seq}, {cfg.stages} blocks, bf16, flash, MSE, {STEP_ITERS} "
        f"steps + 1 warm-up): p50 {res['p50_ms']:.1f} ms = "
        f"{res['tokens_per_s']:.0f} tokens/s | the step alone "
        f"{alone_ms:.1f} ms (tol {STEP_TOL:.0%}); phase 5's LM step "
        f"{lm_step_ms:.0f} ms = {tokens / lm_step_ms * 1e3:.0f} tokens/s | "
        f"flash launches {mine} | zero_dp + prefetch, world of one: empty "
        f"plan, p50 {zres['p50_ms']:.1f} ms under the profiler, "
        f"{len(kernels)} kernels, none of NCCL | {card}")


def patterns(TFA, dev, card, row3_ms: float, lm_step_ms: float) -> dict:
    """Phase 13: the benchmark's model patterns on one card. → the flash
    launches of the runs that drove them (not of the comparisons)."""
    t0 = time.perf_counter()
    launches = {}
    sp_cli(TFA, launches, card)
    torch.cuda.empty_cache()
    sp_width(TFA, dev, launches, row3_ms, card)
    torch.cuda.empty_cache()
    ring_transformer(TFA, dev, launches, card)
    torch.cuda.empty_cache()
    flagship_pattern(TFA, dev, launches, lm_step_ms, card)
    torch.cuda.empty_cache()
    say(f"phase 13 (patterns): {time.perf_counter() - t0:.1f} s | flash "
        f"launches {launches}")
    return launches


# ----------------------------------------------------------- phase 14


LOOP_LR = 3e-4                   # AdamW (at 1e-2 its loss climbs to 18)
LOOP = dict(optimizer="adamw", weight_decay=0.01, clip_norm=1.0,
            warmup_steps=1, schedule="cosine", eval_every=2, eval_batches=1,
            ckpt_every=2, ckpt_keep=2)
LOOP_STEPS = 4
LOOP_STAGES = 2                   # of flagship_large's 8 blocks: the
# loop's three runs and their 0.65 GB generations, not its width
RESUME_RTOL = 1e-6


class SaveClock:
    """Times every ``save_generation`` the loop makes (wrapping the
    module function for the phase): → ``[(step, ms, bytes), ...]``."""

    def __init__(self):
        from tpu_p2p_torch.utils import checkpoint as C

        self.C, self.real, self.saves = C, C.save_generation, []

    def __enter__(self):
        def timed(path, params, step, **kw):
            t0 = time.perf_counter()
            try:
                stats = self.real(path, params, step, **kw)
            except BaseException:
                self.saves.append((step, 1e3 * (time.perf_counter() - t0),
                                   None))
                raise
            self.saves.append((step, 1e3 * (time.perf_counter() - t0),
                               stats["bytes"]))
            return stats

        self.C.save_generation = timed
        return self

    def __exit__(self, *exc):
        self.C.save_generation = self.real


def loop_run(cfg, TFA, dev, fn, **kw) -> dict:
    """``fn`` (``run_training`` or its supervisor) at phase 5's width
    with ``LOOP``'s flags and a record every step → the records, the
    summary, the flash launches, the saves and the peak memory."""
    buf = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    TFA.reset_launches()
    t0 = time.perf_counter()
    with SaveClock() as clock:
        out = fn(cfg, steps=LOOP_STEPS, lr=LOOP_LR, seed=0, log_every=1,
                 log_stream=buf, device=dev, **LOOP, **kw)
    torch.cuda.synchronize()
    lines = buf.getvalue().splitlines()
    recs = [json.loads(s) for s in lines if not s.startswith("#")]
    return {"out": out, "recs": recs, "notes": [s for s in lines
                                                if s.startswith("#")],
            "launches": dict(TFA.launches), "saves": clock.saves,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "seconds": time.perf_counter() - t0}


def loop_records(run: dict, start: int) -> tuple:
    """→ (losses by step, eval losses by step, clean step ms): a step's
    wall time is clean where no eval or save ran between its record and
    the one before (steps after a step that neither evaluates nor
    saves)."""
    losses = {r["step"]: r["loss"] for r in run["recs"] if "loss" in r}
    evals = {r["step"]: r["eval_loss"] for r in run["recs"]
             if "eval_loss" in r}
    walls = {r["step"]: r["wall_s"] for r in run["recs"] if "loss" in r}
    clean = [1e3 * (walls[s] - walls[s - 1]) for s in sorted(walls)
             if s - 1 in walls and (s - 1) % LOOP["eval_every"]
             and (s - 1) % LOOP["ckpt_every"] and s - 1 > start]
    return losses, evals, clean


def check_loop_launches(launches: dict, cfg, steps: int, evals: int):
    once = cfg.stages * cfg.microbatches
    want = {"flash_fwd": once * (steps + evals),
            "flash_bwd_dkdv": once * steps, "flash_bwd_dq": once * steps}
    if launches != want:
        raise AssertionError(f"flash launches {launches}, expected {want} "
                             f"(once a block a step; the forward again "
                             f"a block an evaluation)")


def max_rel_diff(a: dict, b: dict) -> tuple:
    """The largest ``|a - b| / max|b|`` over the leaves → (value, leaf)."""
    diffs = [(float((a[k].float() - b[k].float()).abs().max())
              / max(float(b[k].float().abs().max()), 1e-30), k) for k in b]
    return max(diffs, key=lambda d: d[0])


def train_loop(TFA, dev, card, sgd_p50: float) -> dict:
    """Phase 14: the training loop's optimizer, evaluation and durable
    checkpoints at phase 5's width. → the flash launches of run (a)."""
    import shutil
    import tempfile

    from tpu_p2p_torch.models.flagship import FlagshipConfig
    from tpu_p2p_torch.obs.faults import FaultPlan
    from tpu_p2p_torch.train import run_training, run_training_supervised
    from tpu_p2p_torch.utils import checkpoint as C

    t0 = time.perf_counter()
    cfg = FlagshipConfig(**{**TRAIN, "stages": LOOP_STAGES})
    root = tempfile.mkdtemp(prefix="chip_smoke_loop_")
    try:
        # (a) the full loop
        ck_a = os.path.join(root, "a")
        a = loop_run(cfg, TFA, dev, run_training, ckpt_dir=ck_a)
        losses, evals, clean = loop_records(a, 0)
        final = a["out"]["final_loss"]
        if (sorted(losses) != list(range(1, LOOP_STEPS + 1))
                or not all(math.isfinite(x) for x in losses.values())):
            raise AssertionError(f"loop losses {losses}")
        ln_v = math.log(cfg.vocab)
        if not ln_v - 1 <= losses[1] <= ln_v + 2:
            raise AssertionError(f"loop first loss {losses[1]} outside "
                                 f"[ln V - 1, ln V + 2]")
        if sorted(evals) != [2, 4] or not all(
                math.isfinite(x) for x in evals.values()):
            raise AssertionError(f"eval records {evals}, expected steps "
                                 "2 and 4")
        gens = [n for _, n in C.list_generations(ck_a)]
        if gens != ["gen-000004", "gen-000002"]:
            raise AssertionError(f"generations {gens}")
        reason = C.verify_generation(os.path.join(ck_a, gens[1]))
        if reason is not None:
            raise AssertionError(f"{gens[1]} does not verify: {reason}")
        check_loop_launches(a["launches"], cfg, LOOP_STEPS, len(evals))
        launches = a["launches"]
        tl = time.perf_counter()
        lc = C.load_latest(ck_a)   # verifies gen-000004 on the way
        load_ms = 1e3 * (time.perf_counter() - tl)
        if lc.name != gens[0] or lc.skipped:
            raise AssertionError(f"load_latest chose {lc.name}, skipping "
                                 f"{lc.skipped}")
        load_bytes = sum(os.path.getsize(os.path.join(lc.path, f))
                         for f in os.listdir(lc.path))
        del lc
        p50 = statistics.median(clean)
        tokens = cfg.batch * cfg.seq
        saves = "; ".join(
            f"step {s}: {ms:.0f} ms, {b} B = {b / ms / 1e6:.2f} GB/s"
            for s, ms, b in a["saves"])
        say(f"train loop (a) flagship_large at {cfg.stages} of 8 blocks "
            f"(B{cfg.batch} T{cfg.seq}, bf16, flash), AdamW wd 0.01, clip "
            f"1.0, warmup 1 + cosine, lr {LOOP_LR}, {LOOP_STEPS} steps: "
            f"losses {[losses[s] for s in sorted(losses)]}"
            f" | eval {evals} | step ms of steps {len(clean)} clean "
            f"{[round(x) for x in clean]}, p50 {p50:.0f} ms = "
            f"{tokens / p50 * 1e3:.0f} tokens/s (phase 5's SGD p50 at 8 "
            f"blocks {sgd_p50:.0f} ms) | "
            f"peak memory {a['peak_gib']:.2f} GiB | saves {saves} | "
            f"verifying load of {gens[0]} {load_ms:.0f} ms, "
            f"{load_bytes} B = {load_bytes / load_ms / 1e6:.2f} GB/s | "
            f"flash launches {a['launches']} | {card}")

        # (b) resume from a copy without gen-000004 (hard links)
        ck_b = os.path.join(root, "b")
        os.makedirs(ck_b)
        shutil.copytree(os.path.join(ck_a, "gen-000002"),
                        os.path.join(ck_b, "gen-000002"),
                        copy_function=os.link)
        b = loop_run(cfg, TFA, dev, run_training, ckpt_dir=ck_b,
                     resume=True)
        if b["out"]["start_step"] != 2:
            raise AssertionError(f"resume started at {b['out']['start_step']}")
        bitwise = (b["out"]["final_loss"] == final and all(
            bits_equal(b["out"]["params"][k], a["out"]["params"][k])
            for k in a["out"]["params"]))
        worst, leaf = max_rel_diff(b["out"]["params"], a["out"]["params"])
        loss_rel = abs(b["out"]["final_loss"] - final) / abs(final)
        if not bitwise and max(worst, loss_rel) > RESUME_RTOL:
            raise AssertionError(
                f"resume: final loss {b['out']['final_loss']} vs {final}, "
                f"largest param difference {worst:.3e} ({leaf}), over "
                f"{RESUME_RTOL}")
        say(f"train loop (b) resume from gen-000002 to step {LOOP_STEPS}: "
            f"final loss {b['out']['final_loss']} vs (a) {final}, params "
            f"{'bitwise' if bitwise else f'largest rel. diff {worst:.3e} ({leaf})'}"
            f" | the resume (load, 2 steps, eval, save) "
            f"{b['seconds']:.1f} s | {card}")
        del a, b
        shutil.rmtree(ck_a)
        shutil.rmtree(ck_b)
        torch.cuda.empty_cache()

        # (c) the supervisor through a crash 512 bytes into the step-4 save
        ck_c = os.path.join(root, "c")
        c = loop_run(cfg, TFA, dev, run_training_supervised, ckpt_dir=ck_c,
                     fault_plan=FaultPlan(ckpt_crash_after_bytes=512,
                                          start_step=4))
        sup = c["out"]["supervisor"]
        want_notes = [
            "# supervise: crashed mid-checkpoint at step 4 (simulated "
            "process death after 512 bytes into params.npz)",
            "# supervise: resuming from gen-000002 (step 2, 2 step(s) to "
            "re-run)",
            f"# supervise: completed at step {LOOP_STEPS} after 1 "
            "restart(s)"]
        if (sup != {"restarts": 1, "crashes": [
                {"step": 4, "resume_step": 2, "lost_steps": 2}]}
                or c["notes"] != want_notes):
            raise AssertionError(f"supervise: {sup}, lines {c['notes']}")
        if c["out"]["final_loss"] != final:
            raise AssertionError(f"supervised final loss "
                                 f"{c['out']['final_loss']} vs (a) {final}")
        say(f"train loop (c) supervise, crash 512 B into the step-4 save: "
            f"{sup} | {' / '.join(c['notes'])} | final loss "
            f"{c['out']['final_loss']} == (a) | {c['seconds']:.1f} s with "
            f"the crash and the re-entry | {card}")
        del c
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    say(f"phase 14 (loop): {time.perf_counter() - t0:.1f} s")
    return launches


# ----------------------------------------------------------- phase 15


MESH_RANKS = (2, 4)                     # dp ranks sharing cuda:0


def mesh_pages(n: int) -> int:
    """Phase 7's pool over ``n`` shards: ``SLOTS·5 + n`` pages (a trash
    page a shard), rounded up to a multiple of ``n``."""
    pages = SLOTS * 5 + n
    return pages + (-pages) % n


def mesh_rank_steps(sim: dict, n: int) -> int:
    """Over a dry schedule's busy steps, how many (step, rank) pairs have
    an active row: the serve mesh runs a rank's step only then."""
    act = sim["stacked"]["n_active"]
    return int((act.reshape(len(act), n, -1).sum(-1) > 0).sum())


def mesh_run(mesh, cfg, params, sc, trace, mode: str, TK) -> dict:
    """``run_engine`` over ``mesh``, its KV-write launches counted;
    raises unless every request finishes in full, the steps equal the dry
    ``simulate_schedule(n_shards=n)``, every shard drains full, and the
    KV write launched ``stages`` times a (busy step, rank with an active
    row) and nothing else launched."""
    from tpu_p2p_torch.serve.batcher import simulate_schedule
    from tpu_p2p_torch.serve.engine import run_engine

    n, what = mesh.size, f"dp {mesh.size} {mode}"
    sim = simulate_schedule(
        trace, slots=sc.slots, page_len=sc.page_len,
        num_pages=sc.num_pages, max_blocks=sc.max_blocks, chunk=sc.chunk,
        mode=mode, n_shards=n)
    torch.cuda.synchronize()
    TK.reset_launches()
    out = run_engine(mesh, cfg, params, trace, sc=sc, mode=mode)
    torch.cuda.synchronize()
    counts = dict(TK.launches)
    b, fin = out["batcher"], out["finished"]
    if len(fin) != len(trace) or any(len(r.generated) != r.max_new
                                      for r in fin):
        raise AssertionError(f"{what}: {len(fin)}/{len(trace)} requests "
                             "finished in full")
    busy = out["steps"] - out["idle_steps"]
    if (busy, out["idle_steps"]) != (sim["steps"], sim["idle_steps"]):
        raise AssertionError(
            f"{what}: {busy} busy + {out['idle_steps']} idle steps, the "
            f"dry schedule says {sim['steps']} + {sim['idle_steps']}")
    if any(b.pool_alloc.available(k) != b.pool_alloc.capacity
           for k in range(n)):
        raise AssertionError(f"{what}: page leak")
    rank_steps = mesh_rank_steps(sim, n)
    want = cfg.stages * rank_steps
    if counts != {"paged_kv_write": want, "cache_kv_write": 0,
                  "paged_rows_write": 0, "cache_row_write": 0}:
        raise AssertionError(
            f"{what}: launches {counts}, expected paged_kv_write {want} = "
            f"stages {cfg.stages} x {rank_steps} (busy step, rank with an "
            "active row) pairs, and nothing else")
    out.update(streams={r.rid: list(r.generated) for r in fin},
               launches=want, rank_steps=rank_steps, busy=busy)
    return out


def dense_logits(cfg, params, seq) -> torch.Tensor:
    """Teacher-forced dense-decode logits of one token sequence at batch
    1 on the params' device: row ``t`` scores the token after position
    ``t``."""
    from tpu_p2p_torch.models import decode as D

    dev = params["emb"].device
    cfg1 = dataclasses.replace(cfg, batch=1)
    step = D.make_flagship_lm_decode_step(cfg1)
    cache = D.init_kv_cache(cfg1, len(seq) + (-len(seq)) % 8, dev)
    rows = []
    for t in range(len(seq) - 1):
        tok = torch.tensor([[int(seq[t])]], device=dev)
        cache, lg = step(params, cache, tok, t)
        rows.append(lg[0, 0].float())
    return torch.stack(rows)


def parity_gate(cfg, params, prompts: dict, got: dict, want: dict,
                what: str, card: str) -> int:
    """The streams of ``got`` that part from ``want`` (rid → tokens), each
    token of both held to phase 9's teacher-forced gate (its dense logit
    within ``WITNESS_TOL`` of the dense maximum); prints how many part
    and the dense top-2 margin where each first parts. → how many
    part."""
    parts, worst = [], 0.0
    for rid in sorted(got):
        if got[rid] == want[rid]:
            continue
        j = next(k for k, (x, y) in enumerate(zip(got[rid], want[rid]))
                 if x != y)
        p = len(prompts[rid])
        for toks in (got[rid], want[rid]):
            seq = np.concatenate([prompts[rid], toks]).astype(np.int64)
            rows = dense_logits(cfg, params, seq)[p - 1:]
            tgt = torch.from_numpy(seq[p:]).to(rows.device)
            gap = rows.max(-1).values - rows.gather(1, tgt[:, None])[:, 0]
            worst = max(worst, gap.max().item())
        top2 = torch.topk(rows[j], 2).values
        parts.append(f"rid {rid} at token {j}: {got[rid][j]} vs "
                     f"{want[rid][j]}, dense top-2 margin "
                     f"{(top2[0] - top2[1]).item():.3g}")
    say(f"{what}: {len(parts)}/{len(got)} streams part bitwise"
        + (": " + "; ".join(parts) + f"; every token of both within "
           f"{worst:.3g} of the dense max (tol {WITNESS_TOL})"
           if parts else "") + f" | {card}")
    if worst > WITNESS_TOL:
        raise AssertionError(f"{what}: a token's dense logit trails the "
                             f"max by {worst} > {WITNESS_TOL}")
    return len(parts)


def mesh_width(cfg, params, TK, phase7: dict, card: str) -> int:
    """(a) ``run_engine`` over dp 2 and dp 4 ranks sharing the card at
    phase 7's width and trace, continuous and static; → the KV-write
    launches counted."""
    from tpu_p2p_torch.serve.engine import serve_mesh, synthetic_trace

    dev = params["emb"].device
    base = serve_config(cfg)
    trace = synthetic_trace(base)
    rows = {1: phase7["summary"]["continuous"]}
    runs, launches = {}, 0
    for n in MESH_RANKS:
        mesh = serve_mesh(n, [dev] * n)
        sc = dataclasses.replace(base, num_pages=mesh_pages(n))
        streams = {}
        for mode in ("continuous", "static"):
            out = mesh_run(mesh, cfg, params, sc, trace, mode, TK)
            launches += out["launches"]
            streams[mode] = out["streams"]
            rows.setdefault(n, {k: out[k] for k in SERVE_KEYS})
            say(f"serve mesh dp {n} {mode}: {out['requests']} requests, "
                f"{out['prompt_tokens']} prompt + {out['gen_tokens']} "
                f"generated tokens, {out['busy']} steps (= simulate_"
                f"schedule(n_shards={n})) + {out['idle_steps']} idle, "
                f"pages {sc.num_pages} ({sc.num_pages // n} a shard, "
                f"every shard drained full) | kv_rows_kernel launches "
                f"{out['launches']} = stages {cfg.stages} x "
                f"{out['rank_steps']} (busy step, rank with an active row) "
                f"pairs, of {out['busy']} x {n} | {card}")
        if streams["continuous"] != streams["static"]:
            diff = [r for r in streams["continuous"]
                    if streams["continuous"][r] != streams["static"][r]]
            raise AssertionError(f"dp {n}: continuous vs static streams "
                                 f"differ for requests {diff}")
        same = sum(streams["continuous"][r] == phase7["streams"][r]
                   for r in phase7["streams"])
        say(f"serve mesh dp {n}: continuous == static bitwise "
            f"({len(trace)}/{len(trace)} streams); {same}/{len(trace)} "
            f"streams bitwise phase 7's one-rank streams | {card}")
        runs[f"dp {n}"] = streams["continuous"]
    stream_witness(cfg, params, trace, runs, card)
    for n, r in rows.items():
        say(f"serve mesh dp {n} continuous on one card: "
            f"{r['serve_tokens_per_s']} tokens/s, ttft p50 "
            f"{r['serve_ttft_ms_p50']} ms p99 {r['serve_ttft_ms_p99']} ms, "
            f"per-token p50 {r['serve_tok_ms_p50']} ms p99 "
            f"{r['serve_tok_ms_p99']} ms, {r['steps']} steps in "
            f"{r['wall_s']} s ({r['wall_s'] * 1e3 / r['steps']:.1f} ms a "
            f"step){' (phase 7)' if n == 1 else ''} | {card}")
    return launches


def mesh_reuse(dev, TK, card: str) -> int:
    """(b) ``serve --reuse``'s three graded runs over 2 ranks sharing
    the card, against the same runs on 2 CPU ranks; → the KV-write
    launches counted."""
    from tpu_p2p_torch.serve.engine import (_ttft_steps_mean, run_reuse,
                                            serve_mesh)

    torch.cuda.synchronize()
    TK.reset_launches()
    got = run_reuse(serve_mesh(2, [dev] * 2))
    torch.cuda.synchronize()
    counts = dict(TK.launches)
    if not counts["paged_kv_write"] or sum(counts.values()) \
            != counts["paged_kv_write"]:
        raise AssertionError(f"reuse launches {counts}")
    with contextlib.redirect_stdout(io.StringIO()):
        want = run_reuse(serve_mesh(2, ["cpu"] * 2))
    keys = ("requests", "steps", "prefix_hits", "prefix_pages_shared",
            "prefix_tokens_saved", "cow_forks")
    for run in ("base", "prefix"):
        a, b = ({k: o[run].get(k) for k in keys} for o in (got, want))
        if a != b:
            raise AssertionError(f"reuse {run}: card {a} vs CPU {b}")
    ratio = (_ttft_steps_mean(got["prefix"]["finished"])
             / _ttft_steps_mean(got["base"]["finished"]))
    if not ratio < 0.5:
        raise AssertionError(f"reuse prefix: TTFT ratio {ratio} >= 0.5")
    spec = got["spec"]
    rate = spec["spec_decode_tokens"] / max(spec["spec_decode_steps"], 1)
    if rate <= 1.0:
        raise AssertionError(f"reuse spec: {rate} tokens a decode step")
    prompts = {r.rid: np.asarray(r.prompt) for r in got["trace"]}

    def streams(out):
        return {r.rid: list(r.generated) for r in out["finished"]}

    base = streams(got["base"])
    for run in ("prefix", "spec"):
        parity_gate(got["cfg"], got["params"], prompts,
                    streams(got[run]), base,
                    f"reuse {run} vs baseline on the card", card)
    parity_gate(got["cfg"], got["params"], prompts, base,
                streams(want["base"]), "reuse baseline, card vs CPU", card)
    return counts["paged_kv_write"]


def mesh_chaos(dev, TK, card: str) -> dict:
    """(c) ``run_chaos`` over 2 ranks sharing the card against the same
    on 2 CPU ranks; → the KV-write launches counted (the engine's paged
    ones, the dense rollouts' dense ones)."""
    from tpu_p2p_torch.models.flagship import init_flagship_params
    from tpu_p2p_torch.serve import resilience as R
    from tpu_p2p_torch.serve.engine import (_engine_model, serve_mesh,
                                            synthetic_trace)

    torch.cuda.synchronize()
    TK.reset_launches()
    got = R.run_chaos(serve_mesh(2, [dev] * 2), out=sys.stdout)
    torch.cuda.synchronize()
    counts = dict(TK.launches)
    want = R.run_chaos(serve_mesh(2, ["cpu"] * 2), out=io.StringIO())
    same = {"preempt_clamp": ("preemptions", "completed", "token_loss",
                              "recover_steps", "steps"),
            "storm_shed": ("shed", "total", "completed", "first_shed_step",
                           "steps"),
            "slow_step": ("steps", "ref_steps")}
    for scen, keys in same.items():
        a, b = ({k: o[scen][k] for k in keys} for o in (got, want))
        if a != b:
            raise AssertionError(f"chaos {scen}: card {a} vs CPU {b}")
    p, st, sl = got["preempt_clamp"], got["storm_shed"], got["slow_step"]
    if not (p["preemptions"] and not p["token_loss"]
            and p["completed"] == p["requests"] and st["ok"]
            and sl["tokens_bitwise"] and sl["delay_visible"]):
        raise AssertionError(f"chaos on the card: preempt {p['ok']}, "
                             f"storm {st['ok']}, slow {sl['ok']}")
    sc = R._chaos_sc(2)
    cfg = _engine_model(sc)
    prompts = {r.rid: np.asarray(r.prompt) for r in synthetic_trace(sc)}
    checked = {rid: p["streams"][rid] for rid in p["dense"]}
    parity_gate(cfg, init_flagship_params(cfg, device=dev), prompts,
                checked, p["dense"],
                "chaos preempt_clamp vs its batch-1 dense rollouts", card)
    say(f"chaos on the card: preemptions {p['preemptions']}, shed "
        f"{st['shed']}/{st['total']}, steps {p['steps']} / {st['steps']} / "
        f"{sl['steps']} (= the CPU run), slow_step streams bitwise the "
        f"fault-free twin's, tok p99 {sl['tok_ms_p99_ref']} -> "
        f"{sl['tok_ms_p99_slow']} ms | launches {counts} | {card}")
    if not counts["paged_kv_write"] or not counts["cache_kv_write"]:
        raise AssertionError(f"chaos launches {counts}")
    return counts


def serve_mesh_phase(cfg, params, TK, phase7: dict, card: str) -> dict:
    """Phase 15: (a) at the full width, (b) the graded reuse runs, (c)
    the chaos smoke; → the KV-write launches by path."""
    dev = params["emb"].device
    paged = {"serve_mesh": mesh_width(cfg, params, TK, phase7, card)}
    torch.cuda.empty_cache()
    paged["serve_reuse"] = mesh_reuse(dev, TK, card)
    chaos = mesh_chaos(dev, TK, card)
    paged["serve_chaos"] = chaos["paged_kv_write"]
    return {"paged_kv_write": paged,
            "cache_kv_write": {"serve_chaos": chaos["cache_kv_write"]}}


# ----------------------------------------------------------- phase 16

OVERLAP_STEPS = 2
OVERLAP_KNOBS = dict(tp_overlap="ring", ep_overlap="ring", pp_overlap="wave")
# flagship_large's tp FFN join: a rank's token chunk [B, T / n, Dm] of
# the attention delta, gathered through its wf1 column shard [Dm, 4 Dm / n].
TP_DM, TP_TOKENS = 2048, 4096
WAVE_CHUNKS = 3                          # 2048 / n tokens: padded chunks
OVERLAP_TIMED = 10                       # calls a timed run makes


def card_params(cfg, dev, seed: int = 0) -> dict:
    """The flagship's leaves drawn on the card from a seeded generator,
    scaled as the seeded init scales them: a comparison of two steps from
    the same params needs no host init (tens of seconds at this width)."""
    from tpu_p2p_torch.models.flagship_params import (
        _FAN_IN_DIM, _GAIN_PARAMS, flagship_param_shapes, torch_dtype)

    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = torch_dtype(cfg.params_dtype)
    return {name: (torch.ones(shape, dtype=dtype, device=dev)
                   if name in _GAIN_PARAMS else
                   (torch.randn(shape, generator=gen, device=dev)
                    / math.sqrt(shape[_FAN_IN_DIM[name]])).to(dtype))
            for name, shape in flagship_param_shapes(cfg).items()}


def overlap_world_of_one(TFA, dev, card) -> dict:
    """Phase 16 (a): on a world of one, the dense step at phase 5's width
    and phase 11's MoE step, each ``OVERLAP_STEPS`` steps with the
    overlap knobs on and off from the same params (:func:`card_params`)
    and batches: the knobs'
    losses bitwise the ``none`` step's (every axis has size 1), each
    flash kernel once a block a step. → the knob runs' flash launches."""
    from tpu_p2p_torch.models.flagship import AXES, FlagshipConfig
    from tpu_p2p_torch.parallel.runtime import make_runtime
    from tpu_p2p_torch.train import _per_step_batches

    rt = make_runtime(device=dev, mesh_shape=(1,) * len(AXES),
                      axis_names=AXES)
    launches = {}
    try:
        for what, kw in (("dense", TRAIN), ("moe", MOE_TRAIN)):
            cfg = FlagshipConfig(**kw)
            start = card_params(cfg, dev)
            stream = _per_step_batches(cfg, 0, 0)
            batches = [tuple(torch.from_numpy(np.ascontiguousarray(a))
                             .to(dev) for a in next(stream))
                       for _ in range(OVERLAP_STEPS)]
            kcfg = dataclasses.replace(cfg, **OVERLAP_KNOBS)
            none = direct_steps(cfg, start, batches, TFA, dev, mesh=rt.mesh)
            knob = direct_steps(kcfg, start, batches, TFA, dev, mesh=rt.mesh)
            check_launches(knob["launches"], kcfg, OVERLAP_STEPS)
            if not torch.equal(knob["losses"], none["losses"]):
                raise AssertionError(
                    f"overlap knobs on a world of one ({what}): losses "
                    f"{knob['losses'].tolist()} != the none step's "
                    f"{none['losses'].tolist()}")
            for name, n in knob["launches"].items():
                launches[name] = launches.get(name, 0) + n
            phase = 5 if what == "dense" else 11
            say(f"overlap world of one, {what} (phase {phase}'s width, "
                f"{OVERLAP_STEPS} steps, tp_overlap=ring "
                f"ep_overlap=ring pp_overlap=wave on axes of size 1): losses "
                f"{knob['losses'].tolist()} bitwise the none step's | step "
                f"ms {[round(x) for x in knob['step_ms']]} (none "
                f"{[round(x) for x in none['step_ms']]}) | flash launches "
                f"{knob['launches']} | {card}")
            del start, batches
            torch.cuda.empty_cache()
    finally:
        rt.close()
    return launches


def _seeded(shape, seed: int, dev, dtype=torch.bfloat16) -> torch.Tensor:
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def _bits(t: torch.Tensor) -> np.ndarray:
    """A bf16 tensor's bits as int16, on the host (numpy has no bf16)."""
    return t.contiguous().view(torch.int16).cpu().numpy()


def overlap_rank_case(timed: bool) -> dict:
    """One rank of a world sharing cuda:0: ``ring_allgather_matmul(
    transport="pallas_dma")`` at flagship_large's tp FFN join (each
    rank's ``[4, 4096 / n, 2048]`` bf16 token chunk through its float32-
    widened ``[2048, 8192 / n]`` wf1 shard, as ``_tp_ring_join`` computes
    it) with one backward pass, and ``chunked_ppermute_compute(transport=
    "pallas_dma")`` of the chunk over the partial edge set in
    ``WAVE_CHUNKS`` padded chunks: the main path, its launches counted
    from zero. Then the checks (every shipped chunk bitwise the plain
    version's, gloo on ``.cpu()`` copies, and ``expected_permute``'s; the
    ring's output bitwise the same products run on the card in rank
    order; the backward's dx against the sum over ranks; a float32 ring's
    backward bitwise its plain version's) and, on request, the timing."""
    from tpu_p2p_torch.parallel import collectives as C
    from tpu_p2p_torch.parallel import pallas_dma as PD
    from tpu_p2p_torch.parallel.runtime import make_runtime

    rt = make_runtime(device="cuda:0")
    dev, n, r, line = rt.device, rt.world, rt.rank, rt.mesh
    t, ff = TP_TOKENS // n, 4 * TP_DM // n
    xs = [_seeded((4, t, TP_DM), 100 + j, dev) for j in range(n)]
    ws = [_seeded((TP_DM, ff), 200 + j, dev) for j in range(n)]
    gs = [_seeded((4, TP_TOKENS, ff), 300 + j, dev, torch.float32)
          for j in range(n)]
    fwd = C.ring_edges(n)
    partial = cut_edges(EDGE_SETS_8["partial"], n)
    out = {"rank": r, "world": n, "bad": []}
    seen = {}

    def ffn1(c, src):
        seen[src] = c.detach()
        return torch.matmul(c.float(), ws[r].float())

    x = xs[r].clone().requires_grad_(True)
    rt.barrier()
    PD.reset_launches()
    t0 = time.perf_counter()
    y = C.ring_allgather_matmul(ffn1, x, line, 1, transport="pallas_dma")
    (y * gs[r]).sum().backward()
    waved = C.chunked_ppermute_compute(lambda c, i: c, xs[r], line, partial,
                                       1, WAVE_CHUNKS, transport="pallas_dma")
    torch.cuda.synchronize()
    PD.check_faults()
    out["main_path_s"] = time.perf_counter() - t0
    out["launches"] = dict(PD.launches)
    out["expected"] = {"dma_ship": (n - 1) + (WAVE_CHUNKS - 1),
                       "dma_permute": (n - 1) + 1}
    rt.barrier()
    # Every shipped chunk: the oracle hop by hop (expected_permute), the
    # plain version's gather (gloo on .cpu() copies, identity compute).
    cur = np.stack([_bits(v) for v in xs])
    plain = C.ring_allgather_matmul(lambda c, s: c, xs[r].cpu(), line, 1,
                                    transport="pallas_dma")
    for s in range(n):
        src = (r - s) % n
        if s:
            cur = C.expected_permute(cur, fwd)
        if not (np.array_equal(_bits(seen[src]), cur[r]) and torch.equal(
                seen[src].cpu(), plain.narrow(1, src * t, t))):
            out["bad"].append(f"hop {s}: the chunk of rank {src}")
    want = torch.cat([torch.matmul(v.float(), ws[r].float()) for v in xs], 1)
    if not torch.equal(y.detach(), want):
        out["bad"].append("the ring's output != the products in rank order")
    dx = sum(torch.matmul(g.narrow(1, r * t, t), w.float().t())
             for g, w in zip(gs, ws))
    err = norm_err(x.grad.float(), dx)
    out["dx_err"] = err
    if not err <= FLASH_BF16_TOL:
        out["bad"].append(f"dx normalised L-inf {err:.3e} > {FLASH_BF16_TOL}")
    rows = np.stack([_bits(v) for v in xs])
    want_w = C.expected_permute(rows, partial)[r]
    plain_w = C.chunked_ppermute_compute(lambda c, i: c, xs[r].cpu(), line,
                                         partial, 1, WAVE_CHUNKS,
                                         transport="pallas_dma")
    if not (np.array_equal(_bits(waved), want_w)
            and torch.equal(waved.cpu(), plain_w)):
        out["bad"].append("the wave's arrival")
    # A float32 ring's backward (the reverse hops of row 8's slab path)
    # bitwise its plain version's.
    gen = np.random.default_rng(7)
    xf_all = gen.standard_normal((n, 4, 64, 32)).astype(np.float32)
    gf_all = gen.standard_normal((n, 4, 64 * n, 32)).astype(np.float32)
    grads = []
    for where in (dev, torch.device("cpu")):
        xf = torch.from_numpy(xf_all[r]).to(where).requires_grad_(True)
        yf = C.ring_allgather_matmul(lambda c, s: c * 3, xf, line, 1,
                                     transport="pallas_dma")
        (yf * torch.from_numpy(gf_all[r]).to(where)).sum().backward()
        grads.append(xf.grad.cpu())
    if not torch.equal(*grads):
        out["bad"].append("the float32 ring's backward != its plain version")
    torch.cuda.synchronize()
    PD.check_faults()
    out["max_abs_err"] = 0.0 if not out["bad"] else float("nan")
    if timed:
        calls = {
            "ship": lambda: PD.dma_ship_compute(xs[r], line, fwd,
                                                lambda: None),
            "compute": lambda: torch.matmul(xs[r].float(), ws[r].float()),
            "fused": lambda: PD.dma_ship_compute(
                xs[r], line, fwd, lambda c: torch.matmul(c.float(),
                                                         ws[r].float()),
                xs[r])}
        tm = {}
        for name, fn in calls.items():
            # Every rank's calls together, from a barrier to the last
            # rank's drain: a rank's own events would also time whatever
            # its peer's context ran in its slices.
            fn()
            rt.barrier()
            t1 = time.perf_counter()
            for _ in range(OVERLAP_TIMED):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t1) * 1e3 / OVERLAP_TIMED
            tm[name] = max(rt.gather(wall))
        tm["overlap"] = ((tm["ship"] + tm["compute"] - tm["fused"])
                         / min(tm["ship"], tm["compute"]))
        xc, plain_ms = xs[r].cpu(), []
        for _ in range(3):
            rt.barrier()
            t1 = time.perf_counter()
            PD.dma_ship_compute(xc, line, fwd, lambda: None)
            plain_ms.append((time.perf_counter() - t1) * 1e3)
        tm["plain_ms"] = statistics.median(plain_ms)
        if r == 0:  # the copy on a card no peer's context shares
            dst = torch.empty_like(xs[r])
            tm["library_ms"] = statistics.median(
                device_ms(lambda: dst.copy_(xs[r]), OVERLAP_TIMED))
        rt.barrier()
        PD.check_faults()
        out["timing"] = tm
    rt.barrier()
    rt.close()
    return out


def overlap_world(n: int, card: str, timed: bool) -> list:
    """Spawn :func:`overlap_rank_case` on ``n`` ranks of cuda:0; raise on
    a failed rank, a launch count off the expected one or a check that
    disagreed."""
    from tpu_p2p_torch.parallel.launch import run_world

    t0 = time.perf_counter()
    res = run_world(n, f"{__file__}:overlap_rank_case", {"timed": timed},
                    timeout=300)
    for r in res:
        if r["launches"] != r["expected"] or r["bad"]:
            raise AssertionError(
                f"overlap world of {n}, rank {r['rank']}: launches "
                f"{r['launches']} (expected {r['expected']}), failed "
                f"checks {r['bad']}")
    t = TP_TOKENS // n
    say(f"overlap world of {n} on cuda:0: ring_allgather_matmul("
        f"transport='pallas_dma') of [4, {t}, {TP_DM}] bf16 through [{TP_DM},"
        f" {4 * TP_DM // n}] (float32-widened, as _tp_ring_join) + one "
        f"backward, chunked_ppermute_compute(pallas_dma) over "
        f"{cut_edges(EDGE_SETS_8['partial'], n)} in {WAVE_CHUNKS} padded "
        f"chunks: main path {res[0]['main_path_s']:.2f} s, launches a rank "
        f"{res[0]['launches']} (= expected: n - 1 ships a ring, chunks - 1 "
        f"a wave; the backward's and the wave's last hop through "
        f"dma_permute) | every shipped chunk == plain (gloo) == "
        f"expected_permute bitwise, the output == the products in rank "
        f"order bitwise, dx normalised L-inf "
        f"{max(r['dx_err'] for r in res):.2e} (tol {FLASH_BF16_TOL}), a "
        f"float32 ring's backward == plain bitwise | world "
        f"{time.perf_counter() - t0:.1f} s | {card}")
    return res


def overlap(TFA, dev, card) -> dict:
    """Phase 16: the overlap knobs on a world of one, then the fused ship
    on process worlds of 2 and 4 sharing cuda:0. → the flash launches of
    (a), the process-mesh ship's row and the ranks' peer-push launches."""
    t0 = time.perf_counter()
    flash = overlap_world_of_one(TFA, dev, card)
    torch.cuda.empty_cache()
    w2 = overlap_world(2, card, timed=True)
    w4 = overlap_world(4, card, timed=False)
    tm = w2[0]["timing"]
    nbytes = 4 * (TP_TOKENS // 2) * TP_DM * 2
    # Per hop on one card, both ranks: the function moves each chunk once
    # (read it, write the arrival), which is the bound. The slab route
    # adds the copy-out (push: read x, write the peer's slab; arrival:
    # read the slab, write the output), kept beside it.
    bound = 2 * 2 * nbytes / HBM_BYTES_PER_S * 1e3
    slab_bound = 2 * 4 * nbytes / HBM_BYTES_PER_S * 1e3
    m, k, f = 4 * (TP_TOKENS // 2), TP_DM, 4 * TP_DM // 2
    say(f"kernel dma_ship on a process mesh @ [4, {TP_TOKENS // 2}, "
        f"{TP_DM}] bf16 ({nbytes} B), the ring edge on 2 ranks of cuda:0 "
        f"(time-sliced contexts, not a link number), compute [{m}, {k}] @ "
        f"[{k}, {f}] float32-widened on each rank: ship alone "
        f"{tm['ship']:.4f} ms, compute alone {tm['compute']:.4f} ms, fused "
        f"{tm['fused']:.4f} ms, overlap (ship + compute - fused) / min = "
        f"{tm['overlap']:.3f} (a call of both ranks: {OVERLAP_TIMED} calls "
        f"from a barrier to the slower rank's drain) | bound "
        f"{bound:.4f} ms (bytes: read the chunk, write the peer's arrival, "
        f"2 x {nbytes} B a rank x 2 ranks at 3.35 TB/s; the slab route with "
        f"its copy-out moves 4 x, {slab_bound:.4f} ms), plain "
        f"{tm['plain_ms']:.2f} ms (gloo, host memory), copy_ "
        f"{tm['library_ms']:.4f} ms | {card}")
    say(f"phase 16 (overlap): {time.perf_counter() - t0:.1f} s")
    return {"flash": flash,
            "dma_ship": w2[0]["launches"]["dma_ship"],
            "dma_permute": w2[0]["launches"]["dma_permute"],
            "process_mesh": {
                "ranks": "2 processes on cuda:0 (time-sliced)",
                "launches": w2[0]["launches"]["dma_ship"],
                "max_abs_err": max(r["max_abs_err"] for r in w2 + w4),
                "ms": tm["ship"], "fused_ms": tm["fused"],
                "compute_ms": tm["compute"], "overlap": tm["overlap"],
                "plain_ms": tm["plain_ms"], "bound_ms": bound,
                "slab_route_bound_ms": slab_bound,
                "bound_by": "bytes", "library_ms": tm["library_ms"]}}


# ----------------------------------------------------------- phase 17


TP_SERVE = (2, 4)                # tp ranks of a (dp 1, tp n) serve mesh
EP_DECODE = 2                    # ep ranks of the MoE decode (dp 1)
ZERO_DP = 2                      # dp ranks of the ZeRO-stored decode
PREFILL_TP = 2                   # the disagg prefill's tp ranks
TP_MIGRATE_CHUNKS = 2            # --migrate-chunks of the CLI runs


def serve_local_mesh(dev, dp: int = 1, tp: int = 1, ep: int = 1):
    """A ``(dp, tp, ep)`` serve mesh of in-process ranks on ``dev``."""
    from tpu_p2p_torch.parallel.runtime import LocalMesh

    return LocalMesh([dev] * (dp * tp * ep), ("dp", "tp", "ep"),
                     (dp, tp, ep))


def tp_rank_write(cfg, params, TK, tp: int, card: str) -> None:
    """One tp rank's paged write at the shapes its mixed step gives the
    kernel (its ``H_kv / tp`` heads of the projections of its weight
    shard, K roped, into its block of the pool) against
    ``paged_kv_write_plain``, bitwise."""
    from tpu_p2p_torch.models.flagship import place_local_params
    from tpu_p2p_torch.ops.rope import apply_rope

    dev = params["emb"].device
    mesh = serve_local_mesh(dev, tp=tp)
    shard = place_local_params(params, mesh, cfg)[tp - 1]
    gen = torch.Generator(device=dev).manual_seed(17)
    h = torch.randn((SLOTS, CHUNK, cfg.model_dim), generator=gen,
                    device=dev).to(torch.bfloat16)
    stage, heads = 5, cfg.num_kv_heads // tp
    b = torch.arange(SLOTS, device=dev)
    n = torch.tensor([(0, 1, 8)[i % 3] for i in range(SLOTS)],
                     dtype=torch.int32, device=dev)
    r0 = torch.where(n == 8, 0, b % 8).to(torch.int32)
    page = torch.where(n > 0, 1 + 5 * b, 0).to(torch.int32)
    band = (b % (PAGE_LEN // 8)).to(torch.int32)
    qpos = (band.long() * 8 + r0.long())[:, None] + torch.arange(
        CHUNK, device=dev)[None, :]
    k = apply_rope(torch.einsum("btm,hmd->bhtd", h, shard["wk"][stage]),
                   qpos)
    v = torch.einsum("btm,hmd->bhtd", h, shard["wv"][stage])
    pools = [torch.randn((cfg.stages, NUM_PAGES, heads, PAGE_LEN,
                          cfg.head_dim), generator=gen, device=dev)
             .to(torch.bfloat16) for _ in range(2)]
    args = (k, v, page, band, r0, n, stage)
    want = TK.paged_kv_write_plain(*(p.clone() for p in pools), *args)
    got = [p.clone() for p in pools]
    TK.paged_kv_write(*got, *args)
    torch.cuda.synchronize()
    if not all(bits_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"tp {tp} rank {tp - 1}'s paged write differs "
                             "from its plain version")
    say(f"kernel paged_kv_write, tp {tp} rank {tp - 1}: K {tuple(k.shape)} "
        f"(strides {k.stride()}) and V into its pool block "
        f"{tuple(pools[0].shape)}, n in (0, 1, 8): bitwise == plain | "
        f"{card}")


def tp_serving(cfg, params, TK, phase7: dict, card: str) -> dict:
    """(a) ``run_engine`` over (dp 1, tp 2) and (dp 1, tp 4) meshes of
    cuda:0 at phase 7's width and trace, continuous: every request
    finishes, steps equal ``simulate_schedule``, the pool drains full,
    the KV write launched stages x busy steps x tp ranks and nothing
    else; → the streams and the launches by mesh."""
    from tpu_p2p_torch.serve.batcher import simulate_schedule
    from tpu_p2p_torch.serve.engine import run_engine, synthetic_trace

    dev = params["emb"].device
    sc = serve_config(cfg)
    trace = synthetic_trace(sc)
    sim = simulate_schedule(
        trace, slots=sc.slots, page_len=sc.page_len,
        num_pages=sc.num_pages, max_blocks=sc.max_blocks, chunk=sc.chunk,
        mode="continuous")
    runs, launches = {}, {}
    for tp in TP_SERVE:
        mesh = serve_local_mesh(dev, tp=tp)
        run_engine(mesh, cfg, params, short_trace(trace, 1, 2), sc=sc)
        torch.cuda.synchronize()
        TK.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        out = run_engine(mesh, cfg, params, trace, sc=sc)
        torch.cuda.synchronize()
        counts = dict(TK.launches)
        b, fin = out["batcher"], out["finished"]
        busy = out["steps"] - out["idle_steps"]
        if len(fin) != len(trace) or any(len(r.generated) != r.max_new
                                          for r in fin):
            raise AssertionError(f"tp {tp}: {len(fin)}/{len(trace)} "
                                 "requests finished in full")
        if (busy, out["idle_steps"]) != (sim["steps"], sim["idle_steps"]):
            raise AssertionError(f"tp {tp}: {busy} busy steps, the dry "
                                 f"schedule says {sim['steps']}")
        if b.pool_alloc.available(0) != b.pool_alloc.capacity:
            raise AssertionError(f"tp {tp}: page leak")
        want = cfg.stages * busy * tp
        if counts != {"paged_kv_write": want, "cache_kv_write": 0,
                      "paged_rows_write": 0, "cache_row_write": 0}:
            raise AssertionError(f"tp {tp}: launches {counts}, expected "
                                 f"paged_kv_write {want} = stages x busy "
                                 "steps x tp ranks, and nothing else")
        runs[f"tp {tp}"] = {r.rid: list(r.generated) for r in fin}
        launches[f"serve_tp{tp}"] = want
        same = sum(runs[f"tp {tp}"][r] == phase7["streams"][r]
                   for r in phase7["streams"])
        say(f"serve tp {tp} (dp 1, {tp} ranks of cuda:0, {cfg.heads // tp} "
            f"heads and {cfg.num_kv_heads // tp} KV heads a rank): "
            f"{out['requests']} requests, {out['prompt_tokens']} prompt + "
            f"{out['gen_tokens']} generated tokens, {busy} steps (= "
            f"simulate_schedule) | {out['serve_tokens_per_s']} tokens/s "
            f"ttft p50 {out['serve_ttft_ms_p50']} ms p99 "
            f"{out['serve_ttft_ms_p99']} ms | per-token p50 "
            f"{out['serve_tok_ms_p50']} ms p99 {out['serve_tok_ms_p99']} ms "
            f"| {out['wall_s'] * 1e3 / out['steps']:.1f} ms a step | peak "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB | "
            f"kv_rows_kernel launches {want} ({want // tp} a rank) | "
            f"{same}/{len(trace)} streams bitwise tp 1's (phase 7) | "
            f"{card}")
        mesh.close()
        torch.cuda.empty_cache()
    tp_rank_write(cfg, params, TK, TP_SERVE[-1], card)
    return {"streams": runs, "launches": launches}


def route_spy(TM):
    """Record every ``moe._route`` call's top-1 experts and router
    logits, by rank thread, until ``stop()``."""
    import threading

    calls, orig = [], TM._route

    def spy(x, router_w, *args, **kw):
        route = orig(x, router_w, *args, **kw)
        z = torch.matmul(x.float(), router_w.float())
        calls.append((threading.current_thread().name,
                      route.expert[..., 0].reshape(-1).cpu(),
                      z.reshape(-1, z.shape[-1]).cpu()))
        return route

    TM._route = spy

    def stop():
        TM._route = orig
        return calls

    return stop


def ep_decode(TK, dev, card: str) -> dict:
    """(b) phase 11's MoE model (4 experts, capacity factor 4: no drops)
    decoding over a (dp 1, ep 2) mesh of cuda:0 against the same decode
    at ep 1, 16 teacher-forced positions of 32 slots: each token's
    expert equal wherever its top-1/top-2 router-logit margin exceeds
    twice the largest difference of its router logits between the two
    runs (only the rounding of a batch of 16 against 32 rows moves the
    router's input, and below that margin it, not the dispatch, decides
    the expert), and the logits within ``GRAD_TOL`` (relative L2). → the
    launches."""
    from tpu_p2p_torch.models import decode as D
    from tpu_p2p_torch.models import moe as TM
    from tpu_p2p_torch.models.flagship import (
        FlagshipConfig, init_flagship_params, place_local_params)

    cfg = FlagshipConfig(batch=SLOTS, **{**MODEL, "dense_ffn": False,
                                         "num_experts": 4,
                                         "capacity_factor": 4.0})
    params = init_flagship_params(cfg, seed=0, device=dev)
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab, (SLOTS, DECODE_POSITIONS))).to(dev)
    outs, routes, counts = {}, {}, {}
    for ep in (1, EP_DECODE):
        mesh = serve_local_mesh(dev, ep=ep)
        step = D.make_flagship_lm_decode_step(mesh, cfg)
        shards = place_local_params(params, mesh, cfg)
        cache = D.init_kv_cache(cfg, MAX_BLOCKS * PAGE_LEN, mesh=mesh)
        torch.cuda.synchronize()
        TK.reset_launches()
        stop = route_spy(TM)
        try:
            rows = []
            for t in range(DECODE_POSITIONS):
                cache, lg = step(shards, cache,
                                 D.split_rows(mesh, toks[:, t:t + 1]), t)
                rows.append(D.join_rows(mesh, lg)[:, 0].float())
            torch.cuda.synchronize()
        finally:
            calls = stop()
        counts[ep] = dict(TK.launches)
        outs[ep] = torch.stack(rows, 1)
        # A position's layer calls: ep 1 routes the 32 rows at once, each
        # ep rank its 16; the ranks' calls joined in rank order.
        by_rank = {}
        for name, e, z in calls:
            by_rank.setdefault(name, []).append((e, z))
        ranked = [by_rank[k] for k in sorted(by_rank)]
        routes[ep] = [(torch.cat([r[i][0] for r in ranked]),
                       torch.cat([r[i][1] for r in ranked]))
                      for i in range(len(ranked[0]))]
        want = cfg.stages * DECODE_POSITIONS * ep
        if counts[ep] != {"cache_kv_write": want, "paged_kv_write": 0,
                          "cache_row_write": 0, "paged_rows_write": 0}:
            raise AssertionError(f"ep {ep} decode launches {counts[ep]}, "
                                 f"expected cache_kv_write {want}")
        mesh.close()
    if len(routes[1]) != len(routes[EP_DECODE]):
        raise AssertionError("ep decode: routing calls differ in number")
    flips, moved, worst = [], 0, 0.0
    for (e1, z1), (e2, z2) in zip(routes[1], routes[EP_DECODE]):
        top2 = z1.topk(2, -1).values
        margin = top2[:, 0] - top2[:, 1]
        dz = (z1 - z2).abs().max(-1).values
        worst = max(worst, dz.max().item())
        diff = e1 != e2
        moved += int(diff.sum())
        for j in torch.nonzero(diff & (margin > 2 * dz))[:, 0].tolist():
            flips.append((margin[j].item(), dz[j].item()))
    rel = ((outs[EP_DECODE] - outs[1]).norm() / outs[1].norm()).item()
    tokens = sum(e.numel() for e, _ in routes[1])
    say(f"ep decode: MoE ({cfg.num_experts} experts, capacity factor "
        f"{cfg.capacity_factor}) over (dp 1, ep {EP_DECODE}) of cuda:0 vs "
        f"ep 1, {DECODE_POSITIONS} positions x {SLOTS} slots: {tokens} "
        f"routed tokens, {moved} expert choices differ, each with its "
        f"top-2 router margin within twice its router-logit difference "
        f"between the runs (largest difference {worst:.3g}), {len(flips)} "
        f"outside it; logits relative L2 {rel:.3g} (tol {GRAD_TOL}), "
        f"bitwise {torch.equal(outs[1], outs[EP_DECODE])} | launches "
        f"{counts[EP_DECODE]['cache_kv_write']} "
        f"({counts[EP_DECODE]['cache_kv_write'] // EP_DECODE} a rank) | "
        f"{card}")
    if flips or rel > GRAD_TOL or not torch.isfinite(outs[EP_DECODE]).all():
        raise AssertionError(f"ep decode: routing flips (margin, router "
                             f"logit difference) {flips[:8]}, relative L2 "
                             f"{rel}")
    return counts[EP_DECODE]["cache_kv_write"]


def zero_decode(cfg, params, TK, card: str) -> int:
    """(c) flagship_large's dense decode with ZeRO-stored params over dp
    2 ranks of cuda:0 against the same decode with the params
    replicated: bitwise (the gather moves bits). → the launches."""
    from tpu_p2p_torch.models import decode as D
    from tpu_p2p_torch.models.flagship import place_local_params

    dev = params["emb"].device
    toks = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab, (SLOTS, DECODE_POSITIONS))).to(dev)
    outs, launches, stored = {}, 0, {}
    for zero in (False, True):
        c = dataclasses.replace(cfg, zero_dp=zero)
        mesh = serve_local_mesh(dev, dp=ZERO_DP)
        shards = place_local_params(params, mesh, c)
        stored[zero] = sum(v.numel() for v in shards[0].values())
        step = D.make_flagship_lm_decode_step(mesh, c)
        cache = D.init_kv_cache(c, MAX_BLOCKS * PAGE_LEN, mesh=mesh)
        torch.cuda.synchronize()
        TK.reset_launches()
        t0 = time.perf_counter()
        rows = []
        for t in range(DECODE_POSITIONS):
            cache, lg = step(shards, cache,
                             D.split_rows(mesh, toks[:, t:t + 1]), t)
            rows.append(D.join_rows(mesh, lg))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / DECODE_POSITIONS
        outs[zero] = (torch.cat(rows, 1), ms)
        if zero:
            launches = TK.launches["cache_kv_write"]
        mesh.close()
        del shards, cache
        torch.cuda.empty_cache()
    same = torch.equal(outs[False][0], outs[True][0])
    say(f"zero decode: flagship_large over dp {ZERO_DP} ranks of cuda:0, "
        f"params ZeRO-stored ({stored[True] / 1e6:.1f} M a rank, "
        f"{stored[False] / 1e6:.1f} M replicated), gathered at step entry: "
        f"{DECODE_POSITIONS} positions x {SLOTS} slots bitwise the "
        f"replicated decode: {same} | {outs[True][1]:.1f} ms a step (host "
        f"wall) vs {outs[False][1]:.1f} replicated | launches {launches} "
        f"| {card}")
    if not same or launches != cfg.stages * DECODE_POSITIONS * ZERO_DP:
        raise AssertionError(f"zero decode: bitwise {same}, launches "
                             f"{launches}")
    return launches


def disagg_cli_on_card(card: str) -> dict:
    """``serve --disagg`` through ``engine.main`` with its devices set
    to 4 ranks of cuda:0 (the CLI gives every visible card a rank): the
    default partition, prefill tp 2 + decode dp 2, over ``xla`` and over
    ``pallas_dma`` with ``--migrate-chunks 2``; the CLI's own token
    parity against the colocated twin must say OK. → the peer-push
    launches of the second."""
    from tpu_p2p_torch.parallel import pallas_dma as PD
    from tpu_p2p_torch.serve import engine as TE

    dev = torch.device("cuda", 0)
    real, TE._serve_devices = TE._serve_devices, lambda args: [dev] * 4
    counts = {}
    try:
        for extra in ([], ["--transport", "pallas_dma", "--migrate-chunks",
                           str(TP_MIGRATE_CHUNKS)]):
            buf = io.StringIO()
            PD.reset_launches()
            with contextlib.redirect_stdout(buf):
                rc = TE.main(["--disagg", "--requests", "6", "--seed", "0",
                              *extra])
            torch.cuda.synchronize()
            lines = buf.getvalue().splitlines()
            for line in lines:
                say(f"  | {line}")
            if rc != 0 or "token parity OK" not in lines[-1]:
                raise AssertionError(f"serve --disagg {extra}: rc {rc}, "
                                     f"{lines[-1:]}")
            counts = dict(PD.launches)
            mig = int(re.search(r"kv_migrate: (\d+) migrations",
                                buf.getvalue()).group(1))
    finally:
        TE._serve_devices = real
    want = {"dma_ship": mig * 2 * PREFILL_TP * 4 * (TP_MIGRATE_CHUNKS - 1),
            "dma_permute": mig * 2 * PREFILL_TP * 4}
    if counts != want:
        raise AssertionError(f"serve --disagg pallas_dma: launches {counts},"
                             f" expected {want} (migrations x 2 tensors x "
                             f"{PREFILL_TP} prefill ranks x 4 ranks)")
    say(f"serve --disagg on 4 ranks of cuda:0 (prefill tp {PREFILL_TP} + "
        f"decode dp 2): token parity OK over xla and pallas_dma x"
        f"{TP_MIGRATE_CHUNKS} | launches {counts} | {card}")
    return counts


def tp_migrator_check(card: str) -> None:
    """One migration of 5 flagship_large pages from 2 prefill tp ranks
    (4 KV heads each) to decode shard 0 of 1 + 1 decode ranks, all on
    cuda:0, over ``pallas_dma`` in 1 and 2 chunks and ``xla``: each
    shard's arrival (the deposited pages) bitwise the plain version's
    (the same migration on CPU ranks) and the prefill pages' heads in
    order."""
    from tpu_p2p_torch.models.flagship import FlagshipConfig
    from tpu_p2p_torch.parallel.runtime import LocalMesh
    from tpu_p2p_torch.serve.disagg import KvMigrator

    cfg = FlagshipConfig(batch=SLOTS, **MODEL)
    gen = torch.Generator().manual_seed(18)
    heads = cfg.num_kv_heads // PREFILL_TP
    shape = (cfg.stages, 9, heads, PAGE_LEN, cfg.head_dim)
    pre = [{k: torch.randn(shape, generator=gen).to(torch.bfloat16)
            for k in "kv"} for _ in range(PREFILL_TP)]
    src, dst = [4, 2, 7, 1, 8], [3, 1, 2, 4, 5]
    dec_shape = (cfg.stages, 6, cfg.num_kv_heads, PAGE_LEN, cfg.head_dim)
    want = {k: torch.cat([p[k][:, src] for p in pre], dim=2) for k in "kv"}
    cases = []
    for transport, chunks in (("pallas_dma", 1), ("pallas_dma", 2),
                              ("xla", 1)):
        dec = {}
        for dev in ("cpu", "cuda"):
            mig = LocalMesh([torch.device(dev)] * (PREFILL_TP + 1))
            d = [{k: torch.zeros(dec_shape, dtype=torch.bfloat16,
                                 device=dev) for k in "kv"}]
            KvMigrator(mig, cfg, page_len=PAGE_LEN, transport=transport,
                       chunks=chunks, n_prefill=PREFILL_TP).migrate(
                [{k: v.to(dev) for k, v in p.items()} for p in pre], src,
                d, dst, 0)
            mig.close()
            dec[dev] = d[0]
        for k in "kv":
            got = dec["cuda"][k].cpu()
            if not (bits_equal(got, dec["cpu"][k])
                    and bits_equal(got[:, dst], want[k])):
                raise AssertionError(f"tp migration {transport} x{chunks} "
                                     f"{k}: the arrival differs")
        cases.append(f"{transport} x{chunks}")
    say(f"kv migration from {PREFILL_TP} prefill tp ranks ({heads} of "
        f"{cfg.num_kv_heads} KV heads each, [{cfg.stages}, 5, {heads}, "
        f"{PAGE_LEN}, {cfg.head_dim}] bf16 a rank a projection) to decode "
        f"shard 0: the arrival bitwise the plain version's (CPU ranks) "
        f"and the heads in order over {', '.join(cases)} | {card}")


def serve_trace_cli(card: str) -> None:
    """(e) ``serve --trace PATH`` through ``engine.main`` on the card on
    phase 7's trace (its seed, rate, lengths, slots, page_len, chunk and
    vocab; the CLI's own model): ``validate_chrome_trace`` must find no
    problem."""
    import tempfile

    from tpu_p2p_torch.obs.trace import validate_chrome_trace
    from tpu_p2p_torch.serve import engine as TE

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "serve_trace.json")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = TE.main(["--requests", "16", "--seed", "0", "--rate", "4",
                          "--prompt-len", "16:96", "--gen-len", "16:64",
                          "--slots", str(SLOTS), "--page-len",
                          str(PAGE_LEN), "--chunk", str(CHUNK), "--vocab",
                          str(MODEL["vocab"]), "--dtype", "bfloat16",
                          "--batching", "continuous", "--trace", path])
        problems = validate_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    lines = buf.getvalue().splitlines()
    if rc != 0 or problems or not lines[-1].startswith(
            "# wrote chrome trace"):
        raise AssertionError(f"serve --trace: rc {rc}, problems "
                             f"{problems[:5]}, {lines[-1:]}")
    lanes = {e["tid"] for e in events if e["pid"] == 4 and e["ph"] == "X"}
    say(f"serve --trace on phase 7's trace (cuda:0, the CLI's model): "
        f"{len(events)} events on {len(lanes)} slot lanes, "
        f"validate_chrome_trace: no problems | {lines[1]} | {card}")


def tp_phase(cfg, params, TK, phase7: dict, dis: dict, card: str) -> dict:
    """Phase 17: tensor- and expert-parallel serving over serve meshes of
    in-process ranks sharing cuda:0 at flagship_large's width. → the
    launches by path of rows 1, 2, 8 and 9."""
    from tpu_p2p_torch.parallel import pallas_dma as PD
    from tpu_p2p_torch.serve.engine import synthetic_trace

    t0 = time.perf_counter()
    dev = params["emb"].device
    tp = tp_serving(cfg, params, TK, phase7, card)
    torch.cuda.empty_cache()
    ep_launches = ep_decode(TK, dev, card)
    torch.cuda.empty_cache()
    zero_launches = zero_decode(cfg, params, TK, card)
    # (d) the disagg engine with a tp 2 prefill: 2 + 1 ranks of cuda:0.
    from tpu_p2p_torch.parallel.runtime import LocalMesh

    mesh = LocalMesh([dev] * (PREFILL_TP + 1))
    sc = disagg_config(cfg, 4, "pallas_dma", prefill_tp=PREFILL_TP)
    trace = synthetic_trace(sc)
    TK.reset_launches()
    PD.reset_launches()
    run = disagg_run(mesh, cfg, params, sc, trace,
                     f"{PREFILL_TP} prefill tp + 1 decode ranks on cuda:0, "
                     f"{SLOTS}+4 slots, pallas_dma x{MIGRATE_CHUNKS} "
                     "chunks", card)
    dma = dict(PD.launches)
    kv = dict(TK.launches)
    mesh.close()
    expect_launches(dma, run, PREFILL_TP + 1, MIGRATE_CHUNKS,
                    "disagg tp 2", srcs=PREFILL_TP)
    if run["kv_migrate_bytes"] != dis["kv_migrate_bytes"]:
        raise AssertionError(f"disagg tp 2: {run['kv_migrate_bytes']} "
                             f"bytes migrated, the tp 1 run "
                             f"{dis['kv_migrate_bytes']}")
    b = run["batcher"]
    say(f"disagg tp {PREFILL_TP}: migration bytes {run['kv_migrate_bytes']}"
        f" == phase 9's tp 1 run's; {b.migrate_wall_s * 1e3 / max(run['kv_migrated'], 1):.2f}"
        f" ms a migration, {run['serve_kv_migrate_gbps']} Gbps (on-card "
        f"copies) | launches dma_permute {dma['dma_permute']}, dma_ship "
        f"{dma['dma_ship']} (migrations x 2 x {PREFILL_TP} prefill ranks x "
        f"3 ranks x 1 and x {MIGRATE_CHUNKS - 1}), kv_rows_kernel "
        f"{kv['paged_kv_write']} | {card}")
    tp_migrator_check(card)
    stream_witness(cfg, params, trace,
                   {"tp 1 (phase 7)": phase7["streams"], **tp["streams"],
                    f"disagg tp {PREFILL_TP} {SLOTS}+4": run["streams"],
                    f"disagg tp 1 {SLOTS}+4 (phase 9)": dis["streams"]},
                   card)
    cli = disagg_cli_on_card(card)
    TK.reset_launches()
    serve_trace_cli(card)
    trace_launches = TK.launches["paged_kv_write"]
    say(f"phase 17 (tp/ep serving): {time.perf_counter() - t0:.1f} s")
    return {"paged_kv_write": {**tp["launches"],
                               f"disagg_tp{PREFILL_TP}": kv["paged_kv_write"],
                               "serve_trace": trace_launches},
            "cache_kv_write": {"ep_decode": ep_launches,
                               "zero_decode": zero_launches},
            "dma_permute": {f"disagg_tp{PREFILL_TP}": dma["dma_permute"],
                            "disagg_tp2_cli": cli["dma_permute"]},
            "dma_ship": {f"disagg_tp{PREFILL_TP}": dma["dma_ship"],
                         "disagg_tp2_cli": cli["dma_ship"]}}


# ----------------------------------------------------------- phase 18

# flagship_large without the vocabulary (the tick-IR step trains the MSE
# objective; its LM head has no stage axis), in 4 microbatches.
SCHED_CFG = {**{k: v for k, v in TRAIN.items() if k != "vocab"},
             "microbatches": 4}
SCHED_STEPS = 2
SCHED_VARIANTS = (  # (name, pp_schedule, tick_lowering, chunks)
    ("1f1b masked", "1f1b", "masked", 1),
    ("1f1b switch", "1f1b", "switch", 1),
    ("zb switch", "zb", "switch", 1),
    ("interleaved chunks=2", "1f1b", "masked", 2),
)
# The generic executor at flagship_large's widths: a microbatch [2,
# 1024, 2048] float32, 16 MiB a hop.
MLP_DM, MLP_FF, MLP_MB, MLP_T, MLP_M = 2048, 8192, 2, 1024, 4
MLP_LR = 5e-2
SCHED_PROGRAMS = ("gpipe", "1f1b", "interleaved", "zb")


def tick_flash_launches(lowered, layers: int, steps: int, rank: int = 0
                        ) -> dict:
    """The flash launches ``rank``'s ticks make in ``steps`` steps of a
    lowered program whose chunk holds ``layers`` blocks: under the masked
    lowering every tick runs the forward body (one forward) and the
    backward body (the remat forward, dK/dV and dq); under switch a
    ``fwd`` tick one forward, a ``bwd``/``bwd_input`` tick the remat
    forward and both backward kernels, a ``bwd_weight`` or idle tick
    none."""
    fwd = bwd = 0
    for t in range(lowered.program.num_ticks):
        if lowered.lowering == "masked":
            fwd, bwd = fwd + 2, bwd + 1
            continue
        kind = lowered.op_table[int(lowered.tables["op_code"][t, rank])]
        fwd += kind in ("fwd", "bwd", "bwd_input")
        bwd += kind in ("bwd", "bwd_input")
    f, b = fwd * layers * steps, bwd * layers * steps
    return {"flash_fwd": f, "flash_bwd_dkdv": b, "flash_bwd_dq": b}


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm()
            / b.float().norm().clamp_min(1e-30)).item()


def schedule_world_of_one(TFA, dev, card) -> dict:
    """Phase 18 (a): the flagship step under the tick-IR executor
    (``make_flagship_train_step_1f1b``) on a world of one at
    flagship_large's width without the vocabulary, 4 microbatches:
    ``SCHED_STEPS`` steps of each of ``SCHED_VARIANTS`` from the same
    params and batch, beside the GPipe-autograd step. Gates: losses and
    params bitwise across zb/1f1b and switch/masked; one step's gradients
    (``make_flagship_grad_fn_1f1b``) and loss within ``GRAD_TOL``
    (relative L2) of the GPipe step's; each flash kernel launched as the
    program's ticks call it. → the flash launches of the variants."""
    from tpu_p2p_torch.models import flagship as F
    from tpu_p2p_torch.models import schedule as S
    from tpu_p2p_torch.parallel.runtime import make_runtime

    rt = make_runtime(device=dev, mesh_shape=(1,) * len(F.AXES),
                      axis_names=F.AXES)
    mesh = rt.mesh
    cfg = F.FlagshipConfig(**SCHED_CFG)
    tokens = cfg.batch * cfg.seq
    start = card_params(cfg, dev)
    x, t = (a.to(dev) for a in F.flagship_host_batch(
        cfg, np.random.default_rng(1)))
    launches: dict = {}
    try:
        def run(step, params):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            TFA.reset_launches()
            losses, ms = [], []
            for _ in range(SCHED_STEPS):
                t0 = time.perf_counter()
                params, loss = step(params, x, t)
                losses.append(loss.float().cpu())
                ms.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            return {"params": params, "losses": torch.stack(losses),
                    "ms": ms, "launches": dict(TFA.launches),
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30}

        gp = run(F.make_flagship_train_step(cfg, mesh=mesh),
                 {k: v.clone() for k, v in start.items()})
        del gp["params"]
        g_gp, l_gp = F.make_flagship_grad_fn(cfg, mesh)(start, x, t)
        say(f"schedule world of one: GPipe autograd step (phase 5's path, "
            f"B{cfg.batch} T{cfg.seq}, {cfg.stages} blocks, bf16, flash, "
            f"{cfg.microbatches} microbatches, MSE): losses "
            f"{gp['losses'].tolist()} | step ms "
            f"{[round(v, 1) for v in gp['ms']]} = "
            f"{tokens / gp['ms'][-1] * 1e3:.0f} tokens/s | peak "
            f"{gp['peak_gib']:.2f} GiB | {card}")
        ref = None
        for name, sched, lowering, chunks in SCHED_VARIANTS:
            vcfg = dataclasses.replace(cfg, pp_schedule=sched,
                                       tick_lowering=lowering)
            prog = (S.compile_zb(cfg.microbatches, 1) if sched == "zb"
                    else S.compile_interleaved(cfg.microbatches, 1, chunks))
            want = tick_flash_launches(S.lower(prog, lowering),
                                       cfg.stages // chunks, SCHED_STEPS)
            placed = F.place_flagship_params_pipelined(start, mesh, vcfg,
                                                       chunks)
            got = run(F.make_flagship_train_step_1f1b(mesh, vcfg, lr=1e-2,
                                                      chunks=chunks), placed)
            if got["launches"] != want:
                raise AssertionError(
                    f"schedule {name}: flash launches {got['launches']}, "
                    f"the program's ticks call {want}")
            if not all(math.isfinite(v) for v in got["losses"].tolist()):
                raise AssertionError(f"schedule {name}: losses "
                                     f"{got['losses'].tolist()}")
            note = ""
            if chunks == 1 and ref is None:
                ref = got
            elif chunks == 1:
                same = torch.equal(got["losses"], ref["losses"]) and all(
                    torch.equal(got["params"][k], ref["params"][k])
                    for k in ref["params"])
                if not same:
                    raise AssertionError(
                        f"schedule {name}: losses {got['losses'].tolist()} "
                        f"or params differ from 1f1b masked's "
                        f"{ref['losses'].tolist()} (must be bitwise)")
                note = "losses and params bitwise 1f1b masked's | "
            if name in ("1f1b masked", "interleaved chunks=2"):
                g, loss = F.make_flagship_grad_fn_1f1b(
                    mesh, vcfg, chunks)(placed, x, t)
                rel = {k: rel_l2(g[k], g_gp[k]) for k in g_gp}
                worst = max(rel, key=rel.get)
                lrel = abs(loss.item() - l_gp.item()) / abs(l_gp.item())
                if not (rel[worst] <= GRAD_TOL and lrel <= GRAD_TOL
                        and torch.equal(loss.float().cpu() / (
                            tokens * cfg.model_dim), got["losses"][0])):
                    raise AssertionError(
                        f"schedule {name}: grads vs GPipe relative L2 {rel}"
                        f", loss {loss.item()} vs {l_gp.item()} (tol "
                        f"{GRAD_TOL})")
                note = (f"one step's grads vs GPipe: per-leaf relative L2 "
                        f"max {rel[worst]:.2e} ({worst}), summed loss "
                        f"{lrel:.2e} relative (tol {GRAD_TOL}) | ")
                del g
            say(f"schedule {name} (make_flagship_train_step_1f1b, world of "
                f"one, {prog.num_ticks} ticks): losses "
                f"{got['losses'].tolist()} | {note}step ms "
                f"{[round(v, 1) for v in got['ms']]} = "
                f"{tokens / got['ms'][-1] * 1e3:.0f} tokens/s (GPipe "
                f"{gp['ms'][-1]:.1f} ms) | peak {got['peak_gib']:.2f} GiB "
                f"(GPipe {gp['peak_gib']:.2f}) | flash launches "
                f"{got['launches']} (= the ticks') | {card}")
            for k, n in got["launches"].items():
                launches[k] = launches.get(k, 0) + n
            if got is not ref:
                del got["params"]
            del placed
            torch.cuda.empty_cache()
    finally:
        rt.close()
    return launches


def mlp_expected_hops(lowered, chunks: int) -> dict:
    """Per rank and step, the peer-push launches of a lowered program's
    hops: a program with backward ticks ships on each tick its
    ``ship_y``/``ship_g`` flags say; GPipe ships the activation every
    tick but the last and autograd sends each hop's gradient back. A
    ship is one ``dma_permute``, or in a wave of ``chunks`` chunks
    ``chunks - 1`` ``dma_ship`` calls and one ``dma_permute``; each chunk's
    backward is one ``dma_permute``."""
    if lowered.forward_only:
        hops = lowered.program.num_ticks - 1
        return {"dma_ship": hops * (chunks - 1),
                "dma_permute": hops * (1 + chunks)}
    hops = int(lowered.tables["ship_y"].sum() + lowered.tables["ship_g"].sum())
    return {"dma_ship": hops * (chunks - 1), "dma_permute": hops}


def schedule_rank_case() -> dict:
    """One rank of a world sharing cuda:0: ``make_tick_train_step`` with
    ``mlp_block`` at flagship_large's widths over ``transport=
    "pallas_dma"`` (``stages`` = n, 2n for interleaved), every program of
    ``SCHED_PROGRAMS`` under both lowerings and 1F1B once as a wave of 2
    chunks, each one step from the same params and batch, its peer-push
    launches counted from zero. Checks on this rank's rows: zb bitwise
    1f1b, switch bitwise masked, the wave bitwise the one-shot ship; each
    update within ``GRAD_TOL`` (relative L2) of ``pipeline_reference``'s
    autograd update in this process; the launches the hop tables give."""
    from tpu_p2p_torch.models import pipeline as PL
    from tpu_p2p_torch.models import pipeline_interleaved as IL
    from tpu_p2p_torch.models import schedule as S
    from tpu_p2p_torch.models.flagship_steps import _sgd_update
    from tpu_p2p_torch.parallel import pallas_dma as PD
    from tpu_p2p_torch.parallel.runtime import make_runtime

    rt = make_runtime(device="cuda:0", axis_names=("pp",))
    dev, n, r, mesh = rt.device, rt.world, rt.rank, rt.mesh
    b = MLP_MB * MLP_M
    x = _seeded((b, MLP_T, MLP_DM), 11, dev, torch.float32)
    tgt = _seeded((b, MLP_T, MLP_DM), 12, dev, torch.float32)
    out = {"rank": r, "world": n, "bad": [], "ms": {}, "launches": {},
           "expected": {}, "rel": {}}
    oracle, full = {}, {}
    for v in (1, 2):
        cfg = PL.PipelineConfig(d_model=MLP_DM, d_ff=MLP_FF, stages=n * v,
                                microbatches=MLP_M)
        p = {"w1": _seeded((n * v, MLP_DM, MLP_FF), 21, dev, torch.float32)
             / math.sqrt(MLP_DM),
             "w2": _seeded((n * v, MLP_FF, MLP_DM), 22, dev, torch.float32)
             / math.sqrt(MLP_FF)}
        full[v] = (cfg, p)
        leaves = {k: w.clone().requires_grad_(True) for k, w in p.items()}
        y = PL.pipeline_reference(leaves, x, cfg)
        loss = torch.sum((y - tgt) ** 2)
        grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
        oracle[v] = (loss.item() / x.numel(),
                     _sgd_update(p, grads, MLP_LR, float(x.numel())))
    cases = [(prog, low, "none") for prog in SCHED_PROGRAMS
             for low in ("masked", "switch")] + [("1f1b", "masked", "wave")]
    got = {}
    for prog, low, overlap in cases:
        v = 2 if prog == "interleaved" else 1
        cfg, p = full[v]
        program = {"gpipe": S.compile_gpipe, "1f1b": S.compile_1f1b,
                   "zb": S.compile_zb}[prog](MLP_M, n) \
            if prog != "interleaved" else S.compile_interleaved(MLP_M, n, 2)
        chunks = 2 if overlap == "wave" else 1
        step = S.make_tick_train_step(
            mesh, cfg, program, lr=MLP_LR, pp_overlap=overlap,
            pp_chunks=chunks, transport="pallas_dma", tick_lowering=low)
        placed = IL.place_interleaved_params(p, mesh, v)
        name = f"{prog} {low}" + (" wave" if overlap == "wave" else "")
        rt.barrier()
        PD.reset_launches()
        new, loss = step(placed, x, tgt)
        torch.cuda.synchronize()
        PD.check_faults()
        out["launches"][name] = dict(PD.launches)
        out["expected"][name] = mlp_expected_hops(S.lower(program, low),
                                                  chunks)
        # The same step again, timed from a barrier to the slower rank's
        # drain (the first call also made the peer-push windows).
        rt.barrier()
        t0 = time.perf_counter()
        again, _ = step(placed, x, tgt)
        torch.cuda.synchronize()
        PD.check_faults()
        out["ms"][name] = max(rt.gather((time.perf_counter() - t0) * 1e3))
        if not all(torch.equal(again[k], new[k]) for k in new):
            out["bad"].append(f"{name}: a second step from the same params "
                              "differs")
        del again
        want_loss, want_p = oracle[v]
        rows = IL.place_interleaved_params(want_p, mesh, v)
        rel = max(rel_l2(placed[k] - new[k], placed[k] - rows[k])
                  for k in new)
        out["rel"][name] = rel
        if not (rel <= GRAD_TOL
                and abs(loss.item() - want_loss) <= GRAD_TOL * want_loss):
            out["bad"].append(f"{name}: update relative L2 {rel:.3e}, loss "
                              f"{loss.item()} vs {want_loss}")
        got[name] = (loss.cpu(), new)
    pairs = [("zb masked", "1f1b masked"), ("zb switch", "1f1b masked"),
             ("1f1b masked wave", "1f1b masked")]
    pairs += [(f"{p} switch", f"{p} masked") for p in SCHED_PROGRAMS]
    for a, b2 in pairs:
        la, pa = got[a]
        lb, pb = got[b2]
        if not (torch.equal(la, lb)
                and all(torch.equal(pa[k], pb[k]) for k in pa)):
            out["bad"].append(f"{a} != {b2} (must be bitwise)")
    out["max_abs_err"] = 0.0 if not out["bad"] else float("nan")
    rt.barrier()
    rt.close()
    return out


def schedule_world(n: int, card: str) -> list:
    """Spawn :func:`schedule_rank_case` on ``n`` ranks of cuda:0; raise on
    a failed rank, a launch count off the hop tables' or a failed
    check."""
    from tpu_p2p_torch.parallel.launch import run_world

    t0 = time.perf_counter()
    res = run_world(n, f"{__file__}:schedule_rank_case", {}, timeout=600)
    for r in res:
        if r["launches"] != r["expected"] or r["bad"]:
            raise AssertionError(
                f"schedule world of {n}, rank {r['rank']}: launches "
                f"{r['launches']} (the hop tables give {r['expected']}), "
                f"failed checks {r['bad']}")
    hop = MLP_MB * MLP_T * MLP_DM * 4
    say(f"schedule world of {n} on cuda:0 (time-sliced processes, not a "
        f"link number): make_tick_train_step(mlp_block) at d_model "
        f"{MLP_DM}, d_ff {MLP_FF}, {MLP_M} microbatches of [{MLP_MB}, "
        f"{MLP_T}, {MLP_DM}] float32 ({hop} B a hop), transport="
        f"'pallas_dma', one step each: ms (slower rank) "
        + ", ".join(f"{k} {v:.1f}" for k, v in res[0]["ms"].items())
        + f" (the second step of each; the first builds the windows) | zb "
        f"== 1f1b, switch == masked, wave == one-shot bitwise on every "
        f"rank, a second step bitwise the first; updates vs pipeline_reference relative L2 max "
        f"{max(max(r['rel'].values()) for r in res):.2e} (tol {GRAD_TOL})"
        f" | peer-push launches a rank = the hop tables': "
        + ", ".join(f"{k} {v}" for k, v in res[0]["launches"].items())
        + f" | world {time.perf_counter() - t0:.1f} s | {card}")
    return res


def zb_cli_on_card(card: str) -> dict:
    """Phase 18 (c): ``python -m tpu_p2p_torch zb`` on the card (a world
    of one): its JSON line, ``loss_bitwise`` true; the ratio reported,
    the grade the program's own (exit 0 when ``ok``, else 1)."""
    from tpu_p2p_torch import cli

    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        rc = cli.main(["zb"])
    sys.stdout.write(buf.getvalue())
    lines = buf.getvalue().splitlines()
    res = json.loads(lines[-1]) if lines and lines[-1].startswith("{") \
        else None
    if res is None or rc != (0 if res["ok"] else 1) \
            or not res["loss_bitwise"]:
        raise AssertionError(f"python -m tpu_p2p_torch zb exited {rc}: "
                             f"{res} {err.getvalue()[-2000:]}")
    say(f"zb smoke on the card: fused {res['pp_step_ms_fused']} ms, zb "
        f"{res['pp_step_ms_zb']} ms, ratio {res['pp_zb_vs_fused_ratio']}, "
        f"loss_bitwise {res['loss_bitwise']}, grade ok={res['ok']} (one "
        f"device: zb within 1.10x of fused) | {card}")
    return res


def schedule_phase(TFA, dev, card) -> dict:
    """Phase 18: (a) the flagship 1F1B step on a world of one, (b) the
    generic executor on worlds of 2 and 4 processes sharing cuda:0 over
    the peer-push transport, (c) the zb smoke. → the flash launches of
    (a) and the peer-push launches of (b)'s world of 2."""
    t0 = time.perf_counter()
    flash = schedule_world_of_one(TFA, dev, card)
    torch.cuda.empty_cache()
    w2 = schedule_world(2, card)
    schedule_world(4, card)
    zb = zb_cli_on_card(card)
    say(f"phase 18 (schedules): {time.perf_counter() - t0:.1f} s")
    total = {k: sum(v[k] for v in w2[0]["launches"].values())
             for k in ("dma_permute", "dma_ship")}
    return {"flash": flash, "zb": zb, **total}


# ----------------------------------------------------------- phase 19: obs

OBS_STEPS = 4
OBS_WINDOW = 2
OBS_MSG = "32MiB"
OBS_COUNT = 8


def obs_train_case() -> dict:
    """Phase 19 (a), in a process of its own: ``run_training`` on a
    world of one at phase 5's width (``LOOP_STAGES`` blocks), with and
    without the obs stream, from the same seed. The profiled window is
    watched: its flash launches (the wrappers' counts) against the flash
    kernel events its trace holds."""
    import tempfile

    from tpu_p2p_torch.models.flagship import FlagshipConfig
    from tpu_p2p_torch.obs import health
    from tpu_p2p_torch.ops import flash_attention as TFA
    from tpu_p2p_torch.train import run_training
    from tpu_p2p_torch.utils import profiling

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = FlagshipConfig(**{**TRAIN, "stages": LOOP_STAGES})
    window = {}
    real = profiling.profile_window

    def watched(fn, directory, **kw):
        before = dict(TFA.launches)
        path = real(fn, directory, **kw)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
        window["launches"] = {k: TFA.launches[k] - before[k]
                              for k in before}
        names = [str(e.get("name", "")) for e in events
                 if e.get("cat") == "kernel"]
        window["events"] = {k: sum(1 for nm in names
                                   if k + "_kernel" in nm)
                            for k in before}
        window["names"] = sorted({nm[:80] for nm in names
                                  if "flash" in nm})
        window["nccl"] = sum(1 for e in events if e.get("cat") == "kernel"
                             and "nccl" in str(e.get("name", "")).lower())
        return path

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_obs_") as td:
        for arm in ("plain", "obs"):
            buf = io.StringIO()
            kw = {}
            if arm == "obs":
                kw = {"obs_jsonl": os.path.join(td, "obs.jsonl"),
                      "obs_window_step": OBS_WINDOW}
                profiling.profile_window = watched
            try:
                run_training(cfg, steps=OBS_STEPS, lr=LOOP_LR, seed=0,
                             log_every=1, log_stream=buf, device=dev, **kw)
            finally:
                profiling.profile_window = real
            recs = [json.loads(s) for s in buf.getvalue().splitlines()
                    if s.startswith("{")]
            steps = [r for r in recs if "loss" in r]
            out[arm] = {"losses": [r["loss"] for r in steps],
                        "wall_s": [r["wall_s"] for r in steps]}
            torch.cuda.empty_cache()
        path = os.path.join(td, "obs.jsonl")
        with open(path) as fh:
            out["stream"] = [json.loads(s) for s in fh if s.strip()]
        watch = io.StringIO()
        out["watch_rc"] = health.watch_main([path], stream=watch)
        out["watch"] = watch.getvalue()
    out["window"] = window
    return out


def obs_train_phase(card: str) -> dict:
    """Phase 19 (a): check :func:`obs_train_case`'s run → the flash
    launches of its window."""
    from tpu_p2p_torch.parallel.launch import run_world

    t0 = time.perf_counter()
    (res,) = run_world(1, f"{__file__}:obs_train_case", {}, timeout=600)
    plain, obs = res["plain"], res["obs"]
    if plain["losses"] != obs["losses"] or len(obs["losses"]) != OBS_STEPS:
        raise AssertionError(f"obs stream changed the losses: {plain} vs "
                             f"{obs}")
    stream = res["stream"]
    rows = [r for r in stream if r["obs"] == "step"]
    dev = [r for r in stream if r["obs"] == "device_window"]
    if [r["step"] for r in rows] != list(range(1, OBS_STEPS + 1)) \
            or len(dev) != 1 or stream[-1]["obs"] != "summary":
        raise AssertionError(f"obs stream kinds {[(r['obs'], r.get('step')) for r in stream]}")
    d = dev[0]
    busy = d["device_busy_frac"]
    if not (d["device_track"] and busy is not None and 0 < busy <= 1
            and d["step"] == OBS_WINDOW + 1):
        raise AssertionError(f"device window {d}")
    win = res["window"]
    if not win.get("launches") or not all(win["launches"].values()) \
            or win["launches"] != win["events"]:
        raise AssertionError(f"window flash launches {win.get('launches')}"
                             f" vs its trace's flash kernel events "
                             f"{win.get('events')} (events lost?) "
                             f"{win.get('names')}")
    if res["watch_rc"] != 0:
        raise AssertionError(f"obs watch exited {res['watch_rc']}: "
                             f"{res['watch']}")

    # The steady steps: past the first (the builds) and outside the
    # profiled window.
    steady = [s for s in range(2, OBS_STEPS + 1) if s != OBS_WINDOW + 1]
    wall = [0.0] + plain["wall_s"]
    plain_ms = statistics.median(1e3 * (wall[s] - wall[s - 1])
                                 for s in steady)
    obs_ms = statistics.median(rows[s - 1]["step_ms"] for s in steady)
    window_ms = rows[OBS_WINDOW]["step_ms"]
    say(f"obs train (world of one, phase 5's width, {LOOP_STAGES} blocks, "
        f"{OBS_STEPS} steps): losses bitwise with and without the stream "
        f"{obs['losses']}; step ms p50 of steps {steady} {plain_ms:.1f} "
        f"without, {obs_ms:.1f} with the stream (the obs cost, drained "
        f"every step); the profiled step {window_ms:.1f} ms; "
        f"device window step {d['step']}: busy {busy}, span "
        f"{d['device_span_ms']} ms, tp_overlap {d['tp_overlap_frac']}, "
        f"collectives {d.get('collectives')}, ledger issues "
        f"{d.get('ledger_issues')}, NCCL kernels {win['nccl']}; flash "
        f"launches in the window {win['launches']} = flash kernel events "
        f"{win['events']}; obs watch rc 0 | "
        f"{time.perf_counter() - t0:.1f} s | {card}")
    return {"flash_window": win["launches"], "plain_ms": plain_ms,
            "obs_ms": obs_ms, "window_ms": window_ms, "busy": busy}


def _ledger_rows(text: str) -> dict:
    """The ledger table of an ``obs`` report → ``kind/axis`` → (issues,
    payload, wire, events, gbps)."""
    out = {}
    for line in text.splitlines():
        parts = line.split()
        if len(parts) == 8 and parts[0] == "#" and parts[3].isdigit() \
                and parts[4].isdigit():
            out[f"{parts[1]}/{parts[2]}"] = (int(parts[3]), int(parts[4]),
                                             int(parts[5]), int(parts[6]),
                                             parts[7])
    return out


def obs_rank_case(artifacts_dir: str) -> dict:
    """Phase 19 (b), one rank of a world sharing cuda:0: the ``obs`` CLI
    as a launcher's rank runs it (the first rank prints and writes the
    artifact) → its output and this rank's peer-push launches."""
    from tpu_p2p_torch import cli
    from tpu_p2p_torch.parallel import pallas_dma as PD

    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        rc = cli.main(["obs", "--device", "cuda:0", "--msg-size", OBS_MSG,
                       "--count", str(OBS_COUNT), "--no-gate",
                       "--artifacts-dir", artifacts_dir])
    return {"rc": rc, "out": buf.getvalue(), "err": err.getvalue()[-3000:],
            "dma_permute": PD.launches["dma_permute"]}


def obs_cpu_world(n: int) -> subprocess.Popen:
    """Start the CPU world of ``n`` gloo ranks running phase 19 (b)'s
    command (the totals the card's worlds are held to), beside the card's
    work; its output goes to temporary files (``proc.out``,
    ``proc.err``), so a full pipe never stops it."""
    import tempfile

    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_p2p_torch", "obs", "--cpu-mesh",
         str(n), "--msg-size", OBS_MSG, "--count", str(OBS_COUNT),
         "--no-gate"], stdout=out, stderr=err, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    proc.out, proc.err = out, err
    return proc


def obs_world(n: int, card: str, cpu: subprocess.Popen) -> dict:
    """Phase 19 (b) on ``n`` processes of cuda:0, held to the CPU world
    ``cpu`` (:func:`obs_cpu_world`) of ``n`` gloo ranks."""
    import tempfile

    from tpu_p2p_torch.parallel.launch import run_world

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mc_") as td:
        res = run_world(n, f"{__file__}:obs_rank_case",
                        {"artifacts_dir": td}, timeout=600)
        arts = sorted(f for f in os.listdir(td)
                      if f.startswith("MULTICHIP_r"))
        art = None
        if arts:
            with open(os.path.join(td, arts[-1])) as fh:
                art = json.load(fh)
    first = res[0]
    if any(r["rc"] for r in res):
        raise AssertionError(f"obs world of {n}: exit codes "
                             f"{[r['rc'] for r in res]}: {first['err']}")
    if any(r["dma_permute"] != 2 * OBS_COUNT for r in res):
        raise AssertionError(
            f"obs world of {n}: dma_permute launches "
            f"{[r['dma_permute'] for r in res]}, expected {2 * OBS_COUNT} "
            "a rank (the recorded pass and the profiled one)")
    cpu.wait(timeout=300)
    cpu.out.seek(0)
    cpu.err.seek(0)
    if cpu.returncode:
        raise AssertionError(f"obs --cpu-mesh {n}: {cpu.err.read()[-2000:]}")
    want = _ledger_rows(cpu.out.read())
    out = first["out"]
    got = _ledger_rows(out)
    if {k: v[:3] for k, v in got.items()} != \
            {k: v[:3] for k, v in want.items()}:
        raise AssertionError(f"obs world of {n}: ledger totals {got} vs "
                             f"the CPU world's {want}")
    dma_issues = got["dma/d"][0]
    if art is None:
        raise AssertionError(f"obs world of {n} wrote no artifact:\n{out}")
    dma = art["per_kind"].get("dma", {})
    if (dma.get("events") != dma_issues or art["ragged"]
            or art["unmatched"]):
        raise AssertionError(
            f"obs world of {n}: dma events {dma.get('events')} for "
            f"{dma_issues} issues, ragged {art['ragged']}, unmatched "
            f"{art['unmatched']}")
    m = art.get("matrix_gbps_dma")
    ring = [m[i][(i + 1) % n] for i in range(n)] if m else []
    if len(ring) != n or not all(
            isinstance(v, (int, float)) and math.isfinite(v) and v > 0
            for v in ring):
        raise AssertionError(f"obs world of {n}: peer-push ring edges "
                             f"{ring}")
    host_rows = [k for k, v in got.items() if not k.startswith("dma/")
                 and (v[3] != 0 or v[4] != "n/a")]
    if host_rows or "# host-only:" not in out or "# time-sliced:" \
            not in out or not art.get("time_sliced"):
        raise AssertionError(f"obs world of {n}: library rows with device "
                             f"events {host_rows}, or the host-only / "
                             f"time-sliced labels missing:\n{out}")
    say(f"obs world of {n} on cuda:0 (time-sliced processes, not a link "
        f"number; {OBS_MSG} x {OBS_COUNT} rings, the peer-push ring at "
        f"64 KiB a hop): ledger totals == the CPU world's "
        f"({len(got)} rows); dma issues {dma_issues} joined one for one "
        f"to dma_permute_kernel events ({dma.get('achieved_gbps')} Gbps "
        f"per kind), none ragged or unmatched; peer-push ring edges Gbps "
        + ", ".join(f"{v:.2f}" for v in ring)
        + f"; library rows host-only; dma_permute launches a rank "
        f"{[r['dma_permute'] for r in res]} | "
        f"{time.perf_counter() - t0:.1f} s | {card}")
    return {"dma_permute": first["dma_permute"], "ring_gbps": ring}


def obs_smoke_rank_case() -> dict:
    """Phase 19 (c), one rank of a world of 4 sharing cuda:0: ``python
    -m tpu_p2p_torch obs smoke`` as a launcher's rank runs it."""
    from tpu_p2p_torch import cli

    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        rc = cli.main(["obs", "smoke", "--device", "cuda:0"])
    return {"rc": rc, "out": buf.getvalue(), "err": err.getvalue()[-3000:]}


def obs_smoke_phase(card: str) -> dict:
    from tpu_p2p_torch.parallel.launch import run_world

    t0 = time.perf_counter()
    res = run_world(4, f"{__file__}:obs_smoke_rank_case", {}, timeout=600)
    lines = res[0]["out"].strip().splitlines()
    got = json.loads(lines[-1]) if lines and lines[-1].startswith("{") \
        else None
    if (any(r["rc"] for r in res) or got is None or not got["ok"]
            or got["health_detect_steps"] > 5
            or got["heal_devices"] != 2
            or got["heal_loss_delta_rel"] > 0.05):
        raise AssertionError(f"obs smoke on 4 ranks of cuda:0: exit "
                             f"{[r['rc'] for r in res]}, {got}: "
                             f"{res[0]['out']} {res[0]['err']}")
    for line in lines[:-1]:
        say(line)
    say(f"obs smoke on 4 processes of cuda:0 (library collectives on the "
        f"host group): {json.dumps(got)} | "
        f"{time.perf_counter() - t0:.1f} s | {card}")
    return got


def obs_phase(card: str) -> dict:
    """Phase 19: (a) the obs stream on a world of one, (b) the obs
    report on worlds of 2 and 4 processes of cuda:0, (c) the health
    smoke on 4. → the flash launches of (a)'s window and the peer-push
    launches of (b)'s world of 2."""
    t0 = time.perf_counter()
    cpu = {n: obs_cpu_world(n) for n in (2, 4)}
    try:
        a = obs_train_phase(card)
        w2 = obs_world(2, card, cpu[2])
        obs_world(4, card, cpu[4])
    finally:
        for p in cpu.values():  # stop what a failure left running
            if p.poll() is None:
                p.kill()
                p.wait()
    c = obs_smoke_phase(card)
    say(f"phase 19 (obs): {time.perf_counter() - t0:.1f} s")
    return {"flash": a["flash_window"], "dma_permute": w2["dma_permute"],
            "smoke": c, "train": a}


# ------------------------------------------------------- phase 20: tools

TOPO_RANKS = 4
TRACE_RANKS = (2, 4)
TRACE_DM, TRACE_FF = 2048, 8192          # flagship_large's widths, as
# phase 18 (b)
TRACE_M = 4
TRACE_STEPS = 3


def topo_rank_case(artifacts_dir: str) -> dict:
    """Phase 20 (a), one rank of a world sharing cuda:0: ``python -m
    tpu_p2p_torch topo --smoke`` as a launcher's rank runs it (the ring
    parity over the peer-push kernels; the first rank prints) → its
    output and this rank's peer-push launches."""
    from tpu_p2p_torch import cli
    from tpu_p2p_torch.parallel import pallas_dma as PD

    PD.reset_launches()
    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        rc = cli.main(["topo", "--smoke", "--device", "cuda:0",
                       "--artifacts-dir", artifacts_dir])
    PD.check_faults()
    return {"rc": rc, "out": buf.getvalue(), "err": err.getvalue()[-3000:],
            "launches": dict(PD.launches)}


def topo_phase(card: str) -> dict:
    """Phase 20 (a): the graded topology smoke on ``TOPO_RANKS``
    processes of cuda:0, then ``topo --preset ring``'s render in this
    process (a world of one on the card) → the smoke's peer-push
    launches a rank."""
    import tempfile

    from tpu_p2p_torch import cli
    from tpu_p2p_torch.parallel.launch import run_world

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_topo_") as td:
        res = run_world(TOPO_RANKS, f"{__file__}:topo_rank_case",
                        {"artifacts_dir": td}, timeout=600)
        written = os.listdir(td)
    out = res[0]["out"]
    lines = out.strip().splitlines()
    got = json.loads(lines[-1]) if lines and lines[-1].startswith("{") \
        else None
    want = ("degraded edge avoided=True", "ring parity: wave ship + "
            "ring_allgather_matmul bitwise OK", "health verdict fired",
            "token streams bitwise OK", "dry==real migration events OK",
            "time-sliced host timings, not link numbers")
    # On 4 ranks the split has 2 decode shards of 2 slots, and most
    # migrations find only the throttled shard free: the reference's
    # smoke on its 4-device mesh places 3 of 6 there too (gain 1.00x,
    # ``ok`` false, exit 1). The grades held here are the ring's and
    # the parity pins; the migration line must not place more over the
    # throttled link than free-pages-first.
    mig = re.search(r"naive places (\d+)/\d+ .* topo places (\d+)/", out)
    rcs = {r["rc"] for r in res}
    if (got is None or rcs != {0 if got["ok"] else 1} or mig is None
            or int(mig.group(2)) > int(mig.group(1))
            or not got["topo_route_gain"] > 1
            or not all(w in out for w in want) or written):
        raise AssertionError(f"topo --smoke on {TOPO_RANKS} ranks of "
                             f"cuda:0: exit {[r['rc'] for r in res]}, "
                             f"{got}, artifacts {written}:\n{out}\n"
                             f"{res[0]['err']}")
    if not all(r["launches"]["dma_permute"] and r["launches"]["dma_ship"]
               for r in res):
        raise AssertionError(f"topo --smoke: the ring parity ran no "
                             f"peer-push kernel on some rank: "
                             f"{[r['launches'] for r in res]}")
    for line in lines[:-1]:
        say(line)
    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        rc = cli.main(["topo", "--preset", "ring"])
    if rc or "# topo model: 1 device(s), source=preset" not in \
            buf.getvalue():
        raise AssertionError(f"topo --preset ring exited {rc}: "
                             f"{buf.getvalue()} {err.getvalue()[-2000:]}")
    say(f"topo smoke on {TOPO_RANKS} processes of cuda:0 (the probe's "
        f"library hops on the host group, time-sliced, not link "
        f"numbers): {json.dumps(got)} (the smoke's own grade; migrations "
        f"over the throttled link {mig.group(1)} naive, {mig.group(2)} "
        f"topo); the ring around the throttled edge, its payloads over "
        f"the peer-push kernels bitwise the rank-order ring's, "
        f"launches a rank {[r['launches'] for r in res]}; topo "
        f"--preset ring renders on the card (a world of one) | "
        f"{time.perf_counter() - t0:.1f} s | {card}")
    return {"ok": got["ok"], "launches": res[0]["launches"],
            "route_gain": got["topo_route_gain"],
            "migrate_gain": got["topo_migrate_gbps_gain"]}


def trace_rank_case() -> dict:
    """Phase 20 (b), one rank of a world sharing cuda:0: the flight
    recorder (``run_flight_recorder``, what ``obs trace`` runs) at
    flagship_large's widths over the peer-push transport → the first
    rank's report and render, and this rank's peer-push launches."""
    from tpu_p2p_torch.obs import tickprof as TP
    from tpu_p2p_torch.parallel import pallas_dma as PD
    from tpu_p2p_torch.parallel.runtime import make_runtime

    rt = make_runtime(device="cuda:0")
    PD.reset_launches()
    rep = TP.run_flight_recorder(
        rt, schedule="zb", tick_lowering="switch", microbatches=TRACE_M,
        steps=TRACE_STEPS, d_model=TRACE_DM, d_ff=TRACE_FF)
    torch.cuda.synchronize()
    PD.check_faults()
    out = {"rank": rt.rank, "launches": dict(PD.launches), "report": rep,
           "text": None}
    if rep is not None:
        buf = io.StringIO()
        TP.render_report(rep, stream=buf)
        out["text"] = buf.getvalue()
    rt.close()
    return out


def trace_world(n: int, card: str) -> dict:
    """Phase 20 (b) on ``n`` processes of cuda:0: CUDA-event stamps, the
    device-trace join onto shipping ticks (one ``dma_permute_kernel``
    event a hop slot of the profiled step on every rank), the peer-push
    launches the program's hops give, a positive constant overhead."""
    from tpu_p2p_torch.models import schedule as S
    from tpu_p2p_torch.obs import tickprof as TP
    from tpu_p2p_torch.parallel.launch import run_world

    t0 = time.perf_counter()
    res = run_world(n, f"{__file__}:trace_rank_case", {}, timeout=600)
    rep = res[0]["report"]
    prog = S.compile_zb(TRACE_M, n)
    slots = TP.ship_slots(prog)
    hops = sum(len(v) for v in slots.values())
    runs = 1 + TRACE_STEPS + 1  # warmup, measured, profiled
    dj = rep["device_join"]
    bad = []
    if rep["transport"] != "pallas_dma":
        bad.append(f"the hops went over {rep['transport']}")
    if rep["stamp_clock"] != "cuda_event":
        bad.append(f"stamps from {rep['stamp_clock']}, not CUDA events")
    if not dj["device_track"] or not dj["joined"]:
        bad.append(f"device join n/a: {dj['reason']}")
    if any(j["tick"] not in slots.get(j["site"], ()) for j in dj["joined"]):
        bad.append("a joined hop names no shipping tick of its site")
    if dj.get("events_per_rank") != {r: hops for r in range(n)}:
        bad.append(f"dma_permute_kernel events a rank "
                   f"{dj.get('events_per_rank')}, expected {hops} (the hop "
                   f"slots of one profiled step)")
    if any("dma_permute_kernel" not in j["event"] for j in dj["joined"]):
        bad.append("a joined hop is not a dma_permute_kernel event")
    if [r["launches"] for r in res] != [
            {"dma_permute": hops * runs, "dma_ship": 0}] * n:
        bad.append(f"peer-push launches {[r['launches'] for r in res]}, "
                   f"expected {hops * runs} dma_permute a rank")
    c0 = rep["decomposition"]["constant_overhead_ms"]
    if not rep["ordering"]["ok"] or not c0 or c0 <= 0 or any(
            m["busy_s"] <= 0 or m["wait_s"] <= 0 for m in rep["measured"]):
        bad.append(f"ordering {rep['ordering']}, constant overhead {c0}, "
                   f"measured {rep['measured']}")
    if bad:
        raise AssertionError(f"obs trace on {n} ranks of cuda:0: {bad}\n"
                             f"{res[0]['text']}")
    for line in res[0]["text"].splitlines():
        say(line)
    d = rep["decomposition"]
    busy = [round(m["busy_s"] * 1e3, 3) for m in rep["measured"]]
    wait = [round(m["wait_s"] * 1e3, 3) for m in rep["measured"]]
    say(f"obs trace on {n} processes of cuda:0 (zb, switch, M={TRACE_M}, "
        f"d_model {TRACE_DM}, d_ff {TRACE_FF}, pallas_dma; time-sliced "
        f"processes, not link numbers): stamps from CUDA events; "
        f"{TRACE_STEPS} measured steps, busy ms a rank {busy}, hop-wait ms "
        f"{wait}; constant overhead {c0:.3f} ms/tick "
        f"({'fit' if d['intercept_from_fit'] else 'floor'}), "
        f"{d['ms_per_cost_unit']:.3f} ms a cost unit, "
        f"{d['ms_per_hop']:.3f} ms an effective hop; device join "
        f"{len(dj['joined'])} dma_permute_kernel events on shipping ticks "
        f"({hops} a rank; by issue label "
        f"{sum(j['how'] == 'label' for j in dj['joined'])}, by issue order "
        f"{sum(j['how'] == 'order' for j in dj['joined'])}), "
        f"{len(dj['unattributed'])} unattributed; "
        f"peer-push launches a rank {res[0]['launches']} | "
        f"{time.perf_counter() - t0:.1f} s | {card}")
    return {"launches": res[0]["launches"], "constant_ms": c0,
            "busy_ms": busy, "wait_ms": wait,
            "per_kind_ms": d["per_kind_ms"]}


def ckpt_rank_case() -> dict:
    """Phase 20 (c), a process of its own on the card: ``python -m
    tpu_p2p_torch obs ckpt-smoke`` (a world of one, its default card) →
    its output and the flash launches its steps made."""
    from tpu_p2p_torch import cli
    from tpu_p2p_torch.ops import flash_attention as TFA

    TFA.reset_launches()
    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        rc = cli.main(["obs", "ckpt-smoke"])
    return {"rc": rc, "out": buf.getvalue(), "err": err.getvalue()[-3000:],
            "flash": dict(TFA.launches)}


def ckpt_phase(card: str) -> dict:
    """Phase 20 (c): the three storage scenarios graded bitwise against
    their uninterrupted twin on the card."""
    from tpu_p2p_torch.parallel.launch import run_world

    t0 = time.perf_counter()
    (res,) = run_world(1, f"{__file__}:ckpt_rank_case", {}, timeout=600)
    lines = res["out"].strip().splitlines()
    got = json.loads(lines[-1]) if lines and lines[-1].startswith("{") \
        else None
    scen = [ln for ln in lines if ln.startswith("# ckpt ")]
    if (res["rc"] or got is None or not got["ok"] or len(scen) != 3
            or got["ckpt_recover_steps"] != 3
            or sum("bitwise=True" in ln for ln in scen) != 2):
        raise AssertionError(f"obs ckpt-smoke on the card exited "
                             f"{res['rc']}: {got}\n{res['out']}\n"
                             f"{res['err']}")
    for line in scen:
        say(line)
    say(f"obs ckpt-smoke on the card (a world of one; the smoke's model "
        f"runs dense attention, flash launches {res['flash']}): "
        f"crash_mid_write, corrupt_latest and transient_io graded ok, "
        f"bitwise against the uninterrupted twin; ckpt_recover_steps "
        f"{got['ckpt_recover_steps']}, ckpt_save_ms_p50 "
        f"{got['ckpt_save_ms_p50']} | {time.perf_counter() - t0:.1f} s | "
        f"{card}")
    return got


def native_phase(card: str) -> dict:
    """Phase 20 (d): the native support library builds with ``g++``, and
    each entry point's output equals its Python fallback's."""
    from tpu_p2p_torch.parallel import topology
    from tpu_p2p_torch.utils import native
    from tpu_p2p_torch.utils.report import MatrixReporter

    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the native support library did not build")
    samples = [5.0, 1.0, 4.0, 2.0, 3.0, 0.25, 9.5]

    def outputs() -> dict:
        buf = io.StringIO()
        rep = MatrixReporter(3, "Evaluating X", stream=buf)
        rep.header()
        for i in range(3):
            rep.row_label(i)
            for j in range(3):
                rep.diagonal(i) if i == j else rep.cell(i, j, 1.5 * i + j)
            rep.end_row()
        return {"djb2a": [native.djb2a(s) for s in ("", "gpu-0", "x" * 300)],
                "host_hash": native.host_hash(),
                "percentile": [native.percentile(samples, q)
                               for q in (0.0, 50.0, 99.0, 100.0)],
                "stats": native.stats(samples),
                "placement": [native.check_placement([7, 7, 9, 9], r)
                              for r in range(4)],
                "gbps": [native.gbps(32 << 20, 1e-3),
                         native.gbps(32 << 20, 1e-3, bidir=True)],
                "report": buf.getvalue()}

    lib = outputs()
    saved = native._lib, native._tried
    native._lib, native._tried = None, True
    try:
        fallback = outputs()
    finally:
        native._lib, native._tried = saved
    if lib != fallback or lib["djb2a"][1] != topology.djb2a_hash("gpu-0"):
        raise AssertionError(f"native != fallback: {lib} vs {fallback}")
    say(f"native: {native.library_path().name} built with g++, loaded; "
        f"clock, DJB2a, percentiles, stats, placement, Gbps and the "
        f"report's text equal the Python fallbacks' | "
        f"{time.perf_counter() - t0:.2f} s | {card}")
    return {"available": True}


def tools_phase(card: str) -> dict:
    """Phase 20: (a) the topology smoke and render, (b) the flight
    recorder on worlds of 2 and 4, (c) the checkpoint smoke, each in
    processes of their own; (d) the native library. → the peer-push
    launches of (a) and (b)'s world of 2."""
    t0 = time.perf_counter()
    topo = topo_phase(card)
    trace = {n: trace_world(n, card) for n in TRACE_RANKS}
    ckpt = ckpt_phase(card)
    native_phase(card)
    say(f"phase 20 (tools): {time.perf_counter() - t0:.1f} s")
    return {"topo": topo, "trace": trace[2], "trace4": trace[4],
            "ckpt": ckpt}


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
    built = cuda_build.build(["kvcache", "flash_attention", "p2p_dma"])
    for src, info in built.items():
        say(f"build {src}: {info['cmd'] or 'up to date: ' + str(info['path'])}"
            f" ({info['seconds']:.2f} s)")
    say(f"build: {time.perf_counter() - t0:.2f} s wall, all sources at once")
    sass_check(TFA, built["flash_attention"], card)
    p2p_resources(built["p2p_dma"], card)

    gen = torch.Generator(device=dev).manual_seed(0)
    kernels = [kernel_paged(TK, dev, gen), kernel_cache_kv(TK, dev, gen)]
    for k in kernels:
        say(f"kernel {k['name']} (K and V in one launch; {k['layout']}): "
            f"bitwise == plain, the single-destination form bitwise == "
            f"plain | {k['ms']:.5f} ms (graph replay) vs bound "
            f"{k['bound_ms']:.6f} ms, empty-kernel floor "
            f"{k['floor_ms']:.5f} ms (same grid, graph replay), plain "
            f"{k['plain_ms']:.5f} ms, index_put_ x2 (two calls) "
            f"{k['library_ms']:.5f} ms, host loop {k['host_loop_ms']:.5f} "
            f"ms | {card}")

    kernels += flash_train_shape(TFA, dev, gen, card)
    torch.cuda.empty_cache()
    flash_train_windowed(TFA, dev, gen, card)
    flash_bf16_edges(TFA, dev, gen, card)
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

    t0 = time.perf_counter()
    ring_launches_total = ring_on_one_card(TFA, dev, card)
    torch.cuda.empty_cache()
    mesh_launches = train_world_of_one(TFA, dev, card, trn["step_ms_p50"])
    torch.cuda.empty_cache()
    say(f"phase 10 (mesh): {time.perf_counter() - t0:.1f} s")
    moe_launches = moe(TFA, TK, dev, card)
    mem_launches = memory(TFA, dev, card, moe_launches["train_peak_gib"])
    row3_ms = next(k["ms"] for k in kernels if k["name"] == "flash_fwd")
    pat_launches = patterns(TFA, dev, card, row3_ms, trn["step_ms_p50"])
    loop_launches = train_loop(TFA, dev, card, trn["step_ms_p50"])

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
    torch.cuda.empty_cache()
    kernels.append(p2p(card))
    t0 = time.perf_counter()
    dis = disagg(cfg, params, srv["streams"], card)
    say(f"phase 9 (disagg, without the ship kernel checks): "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mesh_paths = serve_mesh_phase(cfg, params, TK, srv, card)
    say(f"phase 15 (serve mesh): {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    tp_paths = tp_phase(cfg, params, TK, srv, dis, card)
    t0 = time.perf_counter()
    del params
    torch.cuda.empty_cache()
    kernels.append(ship(card, dis))
    say(f"phase 9 (the ship kernel checks): "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    ovl = overlap(TFA, dev, card)
    kernels[-1]["process_mesh"] = ovl["process_mesh"]
    torch.cuda.empty_cache()
    sched = schedule_phase(TFA, dev, card)
    torch.cuda.empty_cache()
    obs = obs_phase(card)
    tools = tools_phase(card)
    launches = {"cache_kv_write": dec["launches"]["cache_kv_write"],
                "paged_kv_write": srv["launches"]["paged_kv_write"],
                "dma_permute": kernels[-2]["launches"],
                "dma_ship": dis["launches"]["dma_ship"], **trn["launches"]}
    paths = {name: {"train": n, "mesh_train": mesh_launches[name],
                    "ring": ring_launches_total[name],
                    "moe_train": moe_launches["train"][name],
                    "patterns": pat_launches[name],
                    "train_loop": loop_launches[name],
                    "overlap": ovl["flash"][name],
                    "schedule": sched["flash"][name],
                    "obs_window": obs["flash"],
                    **{f"memory_{k}": v[name]
                       for k, v in mem_launches.items()}}
             for name, n in trn["launches"].items()}
    paths["dma_permute"] = {"p2p": launches["dma_permute"],
                            "overlap_process_mesh": ovl["dma_permute"],
                            "schedule_process_mesh": sched["dma_permute"],
                            "obs_process_mesh": obs["dma_permute"],
                            "topo_process_mesh":
                                tools["topo"]["launches"]["dma_permute"],
                            "trace_process_mesh":
                                tools["trace"]["launches"]["dma_permute"],
                            **tp_paths["dma_permute"]}
    paths["dma_ship"] = {"disagg": launches["dma_ship"],
                         "overlap_process_mesh": ovl["dma_ship"],
                         "schedule_process_mesh": sched["dma_ship"],
                         "topo_process_mesh":
                             tools["topo"]["launches"]["dma_ship"],
                         **tp_paths["dma_ship"]}
    paths["cache_kv_write"] = {
        "decode": launches["cache_kv_write"],
        "moe_decode": moe_launches["decode"]["cache_kv_write"],
        **mesh_paths["cache_kv_write"], **tp_paths["cache_kv_write"]}
    paths["paged_kv_write"] = {
        "serve": launches["paged_kv_write"],
        "moe_decode": moe_launches["decode"]["paged_kv_write"],
        **mesh_paths["paged_kv_write"], **tp_paths["paged_kv_write"]}
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if not k["launches"]:
            raise AssertionError(f"{k['name']} never launched")
        if k["name"] in paths:
            k["launches_by_path"] = paths[k["name"]]
            if not all(k["launches_by_path"].values()):
                raise AssertionError(f"{k['name']}: a path launched it no "
                                     f"time: {k['launches_by_path']}")
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    say(json.dumps({"kernels": [
        {key: k[key] for key in keys + ("edge_sets", "launches_by_path",
                                        "process_mesh")
         if key in k}
        for k in kernels]}))
    say(f"card: {card}")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
