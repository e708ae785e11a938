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
kernel launches per busy step (the profiler's kernel count over the
busy steps), the top device activities by time, and one JSON line with
all of it. Exits non-zero where no CUDA device is visible.

``--parent DIR`` compares another checkout (``DIR/tpu_p2p_torch``,
built into ``DIR/build``, and its ``chip_smoke.py``) with this one in
one call, each turn a process of its own (``--root DIR --part P``):

- ``kernels``: each tree's ``chip_smoke.py`` phase 3 (its KV-cache
  write kernels, timed as that tree times them), parent, change,
  change, parent;
- ``streams``: each tree's phases 6, 7 and 9 (``decode_parity``,
  ``serve``, ``disagg``) with their token streams, migrations and
  launch counts kept; exits 1 unless the streams, migrations and
  peer-push launches of the two trees are equal;
- ``profile``: this profile of each tree, parent, change, change,
  parent: ``enqueue_ms``, ``device_ms`` and launches per busy step. It
  serves through ``serve_mesh`` and ``Batcher._issue``, so the parent
  must be a tree that serves over the serve mesh.

Then one JSON line of it all (the streams as a verdict)::

    git archive <commit> | tar -x -C trees/parent
    python3 serve_profile.py --parent trees/parent
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
TURN_KEYS = ("enqueue_ms_p50", "enqueue_ms_mean", "device_ms_p50",
             "device_ms_mean", "step_ms_p50", "launches_per_busy_step")


def serve_once(cfg, params, trace, sc):
    """``run_engine`` in continuous batching on one rank, the params'
    card."""
    from tpu_p2p_torch.serve.engine import run_engine, serve_mesh

    mesh = serve_mesh(1, [params["emb"].device])
    return run_engine(mesh, cfg, params, trace, sc=sc, mode="continuous")


def timed_serve(cfg, params, trace, sc):
    """Serve ``trace`` on one rank with every busy step's parts timed; →
    per-part lists of ms."""
    from tpu_p2p_torch.serve import batcher as B

    parts = {k: [] for k in ("step_ms", "host_sched_ms", "enqueue_ms",
                             "device_ms", "wait_copy_ms", "copy_ms")}
    run_step, step = B.Batcher._run_step, B.Batcher.step

    def timed_run_step(self, tokens, pos, n_active):
        stream = self.mesh.stream(0)     # the rank's own stream
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        t0 = time.perf_counter()
        ev[0].record(stream)
        logits = self._issue(0, tokens, pos, n_active, self.tables)
        ev[1].record(stream)
        t1 = time.perf_counter()
        host = self._host(0, logits)
        ev[2].record(stream)
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
        serve_once(cfg, params, trace, sc)
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
    device busy ms without memory copies, kernel launches, top device
    activities as (name, calls, ms))."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve_once(cfg, params, trace, sc)
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
    kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    compute = [(e.time_range.start, e.time_range.end) for e in kernels]
    return (wall, busy_ms(spans), busy_ms(compute), len(kernels),
            rows[:top])


def _smoke(root: str):
    """``root``'s ``chip_smoke`` module, with ``root``'s package first
    on the import path."""
    sys.path.insert(0, os.path.abspath(root))
    import chip_smoke as CS

    return CS


def profile(root: str) -> dict:
    """The whole profile of ``root``'s package; prints as it goes and
    returns the JSON record."""
    CS = _smoke(root)
    from tpu_p2p_torch.models.flagship import (
        FlagshipConfig, init_flagship_params)
    from tpu_p2p_torch.serve.engine import synthetic_trace

    torch.backends.cuda.matmul.allow_tf32 = False
    card = CS.card_line()
    cfg = FlagshipConfig(batch=CS.SLOTS, **CS.MODEL)
    params = init_flagship_params(cfg, seed=0, device="cuda")
    sc = CS.serve_config(cfg)
    trace = synthetic_trace(sc)
    serve_once(cfg, params, trace, sc)                      # warm-up
    parts = timed_serve(cfg, params, trace, sc)
    steps = len(parts["step_ms"])
    result = {"card": card, "root": os.path.abspath(root),
              "busy_steps": steps}
    for k, v in parts.items():
        result[k + "_p50"] = float(np.median(v))
        result[k + "_mean"] = float(np.mean(v))
        print(f"{k}: p50 {np.median(v):.3f} mean {np.mean(v):.3f} over "
              f"{len(v)} busy steps | {card}", flush=True)
    wall, busy, compute, launches, top = profiled_serve(cfg, params, trace,
                                                         sc)
    result.update(profiled_wall_ms=wall, device_busy_ms=busy,
                  device_compute_ms=compute,
                  device_idle_share=1 - busy / wall,
                  kernel_launches=launches,
                  launches_per_busy_step=launches / steps,
                  top_device=[{"name": n, "calls": c, "device_ms": ms}
                              for n, c, ms in top])
    print(f"profiled run: wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"(idle share {1 - busy / wall:.4f}), of which kernels "
          f"{compute:.3f} ms | {launches} kernel launches, "
          f"{launches / steps:.1f} per busy step | {card}")
    for n, c, ms in top:
        print(f"  {ms:10.3f} ms {c:6d} calls  {n[:100]}")
    return result


# Phase-3 functions of chip_smoke.py; kernel_cache_row is the dense
# write's before the fused K+V write (a parent checkout's).
PHASE3 = ("kernel_paged", "kernel_cache_kv", "kernel_cache_row")


def kernels(root: str) -> dict:
    """``root``'s ``chip_smoke.py`` phase 3: its KV-cache write kernels
    against their plain versions, timed as that tree times them."""
    CS = _smoke(root)
    from tpu_p2p_torch.ops import kvcache as TK
    from tpu_p2p_torch.utils import cuda_build

    cuda_build.build(["kvcache"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = [getattr(CS, f)(TK, dev, gen) for f in PHASE3 if hasattr(CS, f)]
    for k in out:
        k.pop("layout", None)
    return {"card": CS.card_line(), "kernels": out}


def streams(root: str) -> dict:
    """``root``'s ``chip_smoke.py`` phases 6, 7 and 9 at the full width:
    the serve phase's streams, every disagg run's streams and
    migrations, and the launch counts."""
    CS = _smoke(root)
    from tpu_p2p_torch.models.flagship import (
        FlagshipConfig, init_flagship_params)
    from tpu_p2p_torch.ops import kvcache as TK
    from tpu_p2p_torch.utils import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.build(["kvcache", "p2p_dma"])
    card, dev = CS.card_line(), torch.device("cuda")
    cfg = FlagshipConfig(batch=CS.SLOTS, **CS.MODEL)
    params = init_flagship_params(cfg, seed=0, device=dev)
    rec = {"card": card, "disagg": {}, "migrations": {},
           "decode_launches": CS.decode_parity(cfg, params, dev,
                                               TK)["launches"]}
    srv = CS.serve(cfg, params, TK, card)
    rec["serve"], rec["serve_launches"] = srv["streams"], srv["launches"]
    run = CS.disagg_run

    def kept(mesh, c, p, sc, trace, what, cd):
        out = run(mesh, c, p, sc, trace, what, cd)
        rec["disagg"][what] = out["streams"]
        rec["migrations"][what] = out["kv_migrated"]
        return out

    CS.disagg_run = kept
    rec["disagg_launches"] = CS.disagg(cfg, params, srv["streams"],
                                       card)["launches"]
    return rec


def _turn(part: str, root: str) -> dict:
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--root", root,
         "--part", part], capture_output=True, text=True, timeout=900)
    if proc.returncode:
        sys.stderr.write(proc.stdout + proc.stderr)
        raise RuntimeError(f"{part} turn of {root} exited "
                           f"{proc.returncode}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def turns(parent: str) -> dict:
    """The parent and this checkout in turns, a process each; → the
    kernel and profile records of every turn and the streams verdict."""
    four = (("parent", parent), ("change", HERE), ("change", HERE),
            ("parent", parent))
    result = {"kernels": [], "turns": []}
    for name, root in four:
        rec = _turn("kernels", root)
        for k in rec["kernels"]:
            k["turn"] = name
            result["kernels"].append(k)
            print(f"kernel turn {name}: {k['name']} {k['ms']:.6f} ms "
                  f"(graph replay), floor {k.get('floor_ms')}, bound "
                  f"{k['bound_ms']:.7f}, plain {k['plain_ms']:.5f}, "
                  f"library {k['library_ms']:.5f}, host loop "
                  f"{k['host_loop_ms']:.5f} | {rec['card']}", flush=True)
    old, new = (_turn("streams", root) for root in (parent, HERE))
    same = {"serve": old["serve"] == new["serve"],
            "disagg": old["disagg"] == new["disagg"],
            "migrations": old["migrations"] == new["migrations"],
            "disagg_launches": old["disagg_launches"]
            == new["disagg_launches"]}
    result["streams_equal"] = same
    print(f"streams parent vs change: {same} | serve {len(new['serve'])} "
          f"requests, disagg runs {sorted(new['migrations'].items())}, "
          f"launches parent {old['serve_launches']} "
          f"{old['decode_launches']} {old['disagg_launches']}, change "
          f"{new['serve_launches']} {new['decode_launches']} "
          f"{new['disagg_launches']} | {new['card']}", flush=True)
    for name, root in four:
        rec = _turn("profile", root)
        rec["turn"] = name
        result["turns"].append(rec)
        print(f"profile turn {name}: " + ", ".join(
            f"{k} {rec[k]:.3f}" for k in TURN_KEYS)
            + f" over {rec['busy_steps']} busy steps | {rec['card']}",
            flush=True)
    if not all(same.values()):
        raise RuntimeError(f"the parent's and this tree's outputs differ: "
                           f"{same}")
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose tpu_p2p_torch to measure")
    ap.add_argument("--part", default="profile",
                    choices=("profile", "kernels", "streams"),
                    help="what to measure of --root (one turn)")
    ap.add_argument("--parent", default=None,
                    help="compare this checkout with DIR in turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("serve_profile: no CUDA device visible; this profile runs "
              "on an NVIDIA GPU", file=sys.stderr)
        return 2
    if args.parent:
        result = turns(args.parent)
    else:
        result = {"profile": profile, "kernels": kernels,
                  "streams": streams}[args.part](args.root)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
