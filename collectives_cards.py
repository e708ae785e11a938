#!/usr/bin/env python3
"""The benchmark's patterns across the cards of one host: ``python3
collectives_cards.py [--set transfers|model]`` runs one ``torchrun``
world of every card for each cell of the set, in turn, and prints each
cell's output under its label, the card's name and power limit first.

``--set transfers`` (the default), at the reference's 32 MiB x 128
iterations of int8, each cell with ``--check`` (its payload verified
once after the timed loop):

- ``ring`` and ``torus2d --mesh-shape 2x2`` over NCCL (``--transport
  xla``) and over the peer-push kernel (``--transport pallas_dma``);
- ``all_to_all``, ``allreduce``, ``reduce_scatter`` and ``all_gather``
  over NCCL (the library collectives run under either transport);
- ``allreduce``, ``ring`` (both transports) and ``all_gather`` in
  ``--mode device`` (the per-op time on the card's clock).

``--set model``, the model patterns at the CLI's defaults:
``ring_attention --flash`` without and with ``--attn-window 128``,
``ulysses_attention --flash``, ``flagship_step`` plain and with
``--zero-dp --overlap prefetch``; then, in one more world, both SP
patterns' workloads at flagship_large's attention width (B 4, H 16, T
4096, D 128, bf16, causal: T 1024 a rank on 4 cards; the ring also with
a window of 1024), called with that model config, and one call of
each under ``torch.profiler`` (every rank's wall, busy and device time
by kernel family).

The world is every visible card. ``--cpu`` runs the same cells as a
gloo world of 4 CPU ranks at 64 KiB x 4 (the model set at 2 iterations,
the wide world at a small width): a rehearsal of the commands, whose
numbers are host speeds. Exits non-zero when a cell fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

NCCL_ONLY = ("all_to_all", "allreduce", "reduce_scatter", "all_gather")
CELL_TIMEOUT_S = 600.0
SP_WIDTH_CPU = dict(batch=1, heads=4, seq=256, head_dim=16)
WIDE = "--wide-rank"  # the rank side of the wide world


def transfer_cells(n: int):
    """(label, arguments) of every cell on a world of ``n``."""
    side = int(n ** 0.5)
    torus = ["--pattern", "torus2d", "--mesh-shape", f"{side}x{n // side}"]
    out = []
    for transport in ("xla", "pallas_dma"):
        t = ["--transport", transport]
        out.append((f"ring {transport}", ["--pattern", "ring", *t]))
        out.append((f"torus2d {side}x{n // side} {transport}", [*torus, *t]))
    for pattern in NCCL_ONLY:
        out.append((pattern, ["--pattern", pattern]))
    out.append(("allreduce device", ["--pattern", "allreduce", "--mode",
                                     "device"]))
    out.append(("all_gather device", ["--pattern", "all_gather", "--mode",
                                      "device"]))
    for transport in ("xla", "pallas_dma"):
        out.append((f"ring device {transport}",
                    ["--pattern", "ring", "--mode", "device",
                     "--transport", transport]))
    return out


def model_cells(n: int):
    """(label, arguments) of the model patterns at the CLI's defaults."""
    ring = ["--pattern", "ring_attention", "--flash"]
    step = ["--pattern", "flagship_step"]
    return [("ring_attention flash", ring),
            ("ring_attention flash window 128",
             [*ring, "--attn-window", "128"]),
            ("ulysses_attention flash",
             ["--pattern", "ulysses_attention", "--flash"]),
            ("flagship_step", step),
            ("flagship_step zero prefetch",
             [*step, "--zero-dp", "--overlap", "prefetch"])]


def wide_rank(cpu: bool) -> int:
    """One rank of the wide world: the SP patterns' workloads at
    flagship_large's attention width (``chip_smoke.SP_WIDTH``), flash,
    causal; then one call of each under ``torch.profiler``, every rank's
    breakdown printed by rank 0 as a ``{"profile": ...}`` line."""
    from chip_smoke import SP_WIDTH, sp_runs
    from tpu_p2p_torch.config import BenchConfig
    from tpu_p2p_torch.models.ring_transformer import ModelConfig
    from tpu_p2p_torch.parallel.runtime import make_runtime
    from tpu_p2p_torch.workloads.base import WorkloadContext

    mc = ModelConfig(**(SP_WIDTH_CPU if cpu else SP_WIDTH))
    rt = make_runtime(device="cpu" if cpu else None)
    runs = sp_runs()
    for pattern, run, _, window in runs:
        cfg = BenchConfig(pattern=pattern, use_flash=True,
                          attn_window=window, iters=2 if cpu else 32)
        run(WorkloadContext(rt=rt, cfg=cfg), mc)
    for pattern, _, build, window in runs:
        profile_call(rt, mc, f"{pattern} W{window}" if window else pattern,
                     build(rt.mesh, "d", True, use_flash=True,
                           window=window or None))
    rt.close()
    return 0


def profile_call(rt, mc, label: str, fn) -> None:
    """``fn`` on this rank's ``T`` blocks: one warm call, a barrier, then
    one call under ``torch.profiler``: wall ms, the card's busy ms and
    idle share, device ms by kernel family (``flagship_cards.py``'s);
    rank 0 prints every rank's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from flagship_cards import FAMILIES, union_ms

    card = rt.device.type == "cuda"
    g = torch.Generator(device=rt.device).manual_seed(rt.rank)
    q, k, v = (torch.randn((mc.batch, mc.heads, mc.seq // rt.world,
                            mc.head_dim), generator=g, device=rt.device,
                           dtype=torch.bfloat16) for _ in range(3))
    fn(q, k, v)
    rt.barrier()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn(q, k, v)
        if card:
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans, fam = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        spans.append((ev.time_range.start, ev.time_range.end))
        family = next((f for f, keys in FAMILIES
                       if any(key in ev.name for key in keys)), "other")
        fam[family] = fam.get(family, 0.0) + ev.time_range.elapsed_us() / 1e3
    busy = union_ms(spans)
    rows = rt.gather({"rank": rt.rank, "wall_ms": wall, "busy_ms": busy,
                      "idle_share": 1 - busy / wall,
                      "device_ms_by_family": fam})
    if rt.rank == 0:
        print(json.dumps({"profile": label, "ranks": rows}), flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    return "; ".join(out.stdout.strip().splitlines())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cpu", action="store_true",
                   help="a gloo world of 4 CPU ranks at 64 KiB x 4")
    p.add_argument("--set", choices=("transfers", "model"),
                   default="transfers", help="which cells to run")
    p.add_argument(WIDE, action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.wide_rank:
        return wide_rank(args.cpu)
    if args.cpu:
        n = 4
    else:
        import torch

        n = torch.cuda.device_count()
        if n < 2:
            print("collectives_cards: needs 2 or more cards (or --cpu)",
                  file=sys.stderr)
            return 2
    torchrun = [sys.executable, "-m", "torch.distributed.run",
                "--standalone", "--nproc-per-node", str(n)]
    if args.set == "transfers":
        extra = ["--check"]
        if args.cpu:
            extra += ["--cpu-mesh", str(n), "--msg-size", "64KiB",
                      "--iters", "4"]
        runs = [(label, [*torchrun, "-m", "tpu_p2p_torch"], cell, extra)
                for label, cell in transfer_cells(n)]
    else:
        extra = ["--cpu-mesh", str(n), "--iters", "2"] if args.cpu else []
        wide = [os.path.abspath(__file__), WIDE] + (["--cpu"] if args.cpu
                                                    else [])
        runs = [(label, [*torchrun, "-m", "tpu_p2p_torch"], cell, extra)
                for label, cell in model_cells(n)]
        runs.append(("flagship_large attention width", torchrun, wide, []))
    print(f"cards: {card_line()} | world of {n}", flush=True)
    bad = []
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.path.dirname(os.path.abspath(__file__)),
                    os.environ.get("PYTHONPATH")) if p))
    for label, launcher, cell, extra in runs:
        cmd = [*launcher, *cell, *extra]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=CELL_TIMEOUT_S, env=env)
            rc, out, err = proc.returncode, proc.stdout, proc.stderr
        except subprocess.TimeoutExpired as e:
            rc, out, err = 124, e.stdout or "", f"timed out: {e}"
        print(f"== {label} (rc {rc}, {time.perf_counter() - t0:.1f} s): "
              f"{' '.join(cell + extra)}", flush=True)
        sys.stdout.write(out if isinstance(out, str) else out.decode())
        if rc:
            bad.append(label)
            tail = err if isinstance(err, str) else err.decode()
            print(tail[-3000:], flush=True)
    print(f"cards: {card_line()}", flush=True)
    if bad:
        print(f"failed cells: {bad}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
