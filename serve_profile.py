#!/usr/bin/env python3
"""Where the port's serving step spends its time on the card:
``python3 serve_profile.py``.

Serves ``chip_smoke.py``'s trace (the 436 M flagship width, 32 slots,
chunk 8, continuous batching) three times on one NVIDIA GPU: once to
warm up, once with every busy step cut into parts on the host clock
and CUDA events, and once under ``torch.profiler`` for device time by
kernel. The parts of a step:

- ``host_sched_ms``: the batcher's own Python (admission, tables,
  building the slot inputs, argmax and bookkeeping);
- ``enqueue_ms``: the host issuing the model step's kernels;
- ``device_ms``: the card from the step's first command to its last
  (CUDA events), gaps included;
- ``wait_copy_ms``: the host from the end of the enqueue to holding the
  logits, i.e. waiting for the card plus the 32 MiB copy;
- ``copy_ms``: the copy alone, on CUDA events.

Prints one line per part, the device's busy share of the profiled run
(all device activity, and kernels alone without memory copies), the
top device activities by time, and one JSON line with all of it.
Exits non-zero where no CUDA device is visible.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

import chip_smoke as CS


def timed_serve(cfg, params, trace, sc):
    """Serve ``trace`` with every busy step's parts timed; → per-part
    lists of ms."""
    from tpu_p2p_torch.serve import batcher as B
    from tpu_p2p_torch.serve.engine import run_engine

    parts = {k: [] for k in ("step_ms", "host_sched_ms", "enqueue_ms",
                             "device_ms", "wait_copy_ms", "copy_ms")}
    run_step, step = B.Batcher._run_step, B.Batcher.step

    def timed_run_step(self, tokens, pos, n_active):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        t0 = time.perf_counter()
        ev[0].record()
        self.pool, logits = self._step(
            self.params, self.pool,
            *(torch.from_numpy(a).to(self.device, torch.int64)
              for a in (tokens, pos, n_active, self.tables)))
        ev[1].record()
        t1 = time.perf_counter()
        host = logits.cpu().numpy()
        ev[2].record()
        ev[2].synchronize()
        t2 = time.perf_counter()
        parts["enqueue_ms"].append((t1 - t0) * 1e3)
        parts["wait_copy_ms"].append((t2 - t1) * 1e3)
        parts["device_ms"].append(ev[0].elapsed_time(ev[1]))
        parts["copy_ms"].append(ev[1].elapsed_time(ev[2]))
        return host

    def timed_step(self):
        n = len(parts["enqueue_ms"])
        t0 = time.perf_counter()
        out = step(self)
        dt = (time.perf_counter() - t0) * 1e3
        if len(parts["enqueue_ms"]) > n:          # a busy step
            parts["step_ms"].append(dt)
            parts["host_sched_ms"].append(
                dt - parts["enqueue_ms"][-1] - parts["wait_copy_ms"][-1])
        return out

    B.Batcher._run_step, B.Batcher.step = timed_run_step, timed_step
    try:
        run_engine(cfg, params, trace, sc=sc, mode="continuous")
    finally:
        B.Batcher._run_step, B.Batcher.step = run_step, step
    return parts


def busy_ms(spans) -> float:
    """Length of the union of ``(start, end)`` µs intervals, in ms."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def profiled_serve(cfg, params, trace, sc, top: int = 12):
    """One run under ``torch.profiler``; → (wall ms, device busy ms,
    device busy ms without memory copies, top device activities as
    (name, calls, ms))."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_p2p_torch.serve.engine import run_engine

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_engine(cfg, params, trace, sc=sc, mode="continuous")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in dev:
        calls, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (calls + 1, us + e.time_range.elapsed_us())
    rows = sorted(((n, c, us / 1e3) for n, (c, us) in by_name.items()),
                  key=lambda r: -r[2])
    spans = [(e.time_range.start, e.time_range.end) for e in dev]
    compute = [(e.time_range.start, e.time_range.end) for e in dev
               if not e.name.startswith("Memcpy")]
    return wall, busy_ms(spans), busy_ms(compute), rows[:top]


def main() -> int:
    if not torch.cuda.is_available():
        print("serve_profile: no CUDA device visible; this profile runs "
              "on an NVIDIA GPU", file=sys.stderr)
        return 2
    from tpu_p2p_torch.models.flagship import (
        FlagshipConfig, init_flagship_params)
    from tpu_p2p_torch.serve.engine import run_engine, synthetic_trace

    torch.backends.cuda.matmul.allow_tf32 = False
    card = CS.card_line()
    cfg = FlagshipConfig(batch=CS.SLOTS, **CS.MODEL)
    params = init_flagship_params(cfg, seed=0, device="cuda")
    sc = CS.serve_config(cfg)
    trace = synthetic_trace(sc)
    run_engine(cfg, params, trace, sc=sc, mode="continuous")  # warm-up
    parts = timed_serve(cfg, params, trace, sc)
    result = {"card": card, "busy_steps": len(parts["step_ms"])}
    for k, v in parts.items():
        result[k + "_p50"] = float(np.median(v))
        result[k + "_mean"] = float(np.mean(v))
        print(f"{k}: p50 {np.median(v):.3f} mean {np.mean(v):.3f} over "
              f"{len(v)} busy steps | {card}", flush=True)
    wall, busy, compute, top = profiled_serve(cfg, params, trace, sc)
    result.update(profiled_wall_ms=wall, device_busy_ms=busy,
                  device_compute_ms=compute,
                  device_idle_share=1 - busy / wall,
                  top_device=[{"name": n, "calls": c, "device_ms": ms}
                              for n, c, ms in top])
    print(f"profiled run: wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"(idle share {1 - busy / wall:.4f}), of which kernels "
          f"{compute:.3f} ms | {card}")
    for n, c, ms in top:
        print(f"  {ms:10.3f} ms {c:6d} calls  {n[:100]}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
