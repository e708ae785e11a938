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

``--set mesh_order``, one world of every card (3 or more) that holds
a ring-ordered 1-D mesh (``Runtime.axis_mesh(ranks=)`` over the
permutation ``0, n-1, ..., 1``) against the rank-order one, each result
compared bitwise across the two:

- ``psum`` and ``reduce_scatter`` of seeded float32 operands at 1, 32
  and 256 MiB a rank (on the permuted mesh each sum takes one
  mesh-order hop first, a reduce-scatter a second after), and the
  shift-by-1 ``ppermute`` ring at 32 MiB: per-call ms of each arm (CUDA
  events around ``ORDER_ITERS`` calls, the best of ``ORDER_ROUNDS``
  rounds taken in turns rank, perm, perm, rank);
- one dp SGD step of the flagship at flagship_large's widths, 2 of its
  8 blocks (B 4 x T 4096, bf16, flash, MSE), on the dp mesh of every
  card in each order: step ms (a barrier to the slower rank's drain)
  and whether every step's params and loss are bitwise across the runs
  and the orders;
- three profiled windows over NCCL (each the work's second call, its
  measured part between two barriers of the mesh, joined to the ledger
  of its first call): the ``CollectiveCache`` all-reduce and
  reduce-scatter at 32 MiB on the permuted mesh (the hops' events on
  their own ``sum_mesh_order`` entries); a GPipe step through the tick
  executor at d_model 2048, d_ff 8192 (4 microbatches of [2, 1024,
  2048] float32) over the library transport, whose autograd backward
  sends each hop's reverse hop; an MoE layer's forward and backward
  over an ep line (4096 tokens of 2048 a rank, an expert of 8192 a
  card), whose backward sends each all-to-all's inverse. Each: ragged
  kinds, unmatched events and the events on each entry.

Rank 0 prints one JSON line a part.

The world is every visible card. ``--cpu`` runs the same cells as a
gloo world of 4 CPU ranks at 64 KiB x 4 (the model set at 2 iterations,
the wide world and the mesh-order set at a small width): a rehearsal of
the commands, whose numbers are host speeds (there is no device track
to join). Exits non-zero when a cell fails.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

NCCL_ONLY = ("all_to_all", "allreduce", "reduce_scatter", "all_gather")
CELL_TIMEOUT_S = 600.0
SP_WIDTH_CPU = dict(batch=1, heads=4, seq=256, head_dim=16)
WIDE = "--wide-rank"  # the rank side of the wide world
ORDER = "--order-rank"  # the rank side of the mesh-order world
ORDER_MIB = (1, 32, 256)
ORDER_CPU_KIB = (64, 1024)
ORDER_ITERS, ORDER_ROUNDS = 20, 3
ORDER_STEP_CPU = dict(batch=4, seq=64, heads=4, kv_heads=2, head_dim=16)
ORDER_PP_CPU = dict(dm=64, ff=128, mb=2, t=16)


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


def order_rank(cpu: bool) -> int:
    """One rank of the mesh-order world (module docstring)."""
    import torch

    from tpu_p2p_torch.parallel import collectives as C
    from tpu_p2p_torch.parallel.runtime import make_runtime

    rt = make_runtime(device="cpu" if cpu else None, apply_ring_order=False)
    n, dev = rt.world, rt.device
    perm = (0,) + tuple(range(n - 1, 0, -1))
    line = {"rank": rt.axis_mesh((n,), ("d",)),
            "perm": rt.axis_mesh((n,), ("d",), ranks=perm)}
    iters = 2 if cpu else ORDER_ITERS

    def per_call_ms(fn) -> float:
        rt.barrier()
        if dev.type == "cuda":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            for _ in range(iters):
                fn()
            ev[1].record()
            ev[1].synchronize()
            return ev[0].elapsed_time(ev[1]) / iters
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters

    def say(row) -> None:
        if rt.rank == 0:
            print(json.dumps(row), flush=True)

    ok = True
    sizes = ([k << 10 for k in ORDER_CPU_KIB] if cpu
             else [m << 20 for m in ORDER_MIB])
    sites = {"psum": lambda x, m: C.psum(x, m),
             "reduce_scatter": lambda x, m: C.reduce_scatter(x, m),
             "ring": lambda x, m: C.ppermute(x, m, C.ring_edges(n))}
    for size in sizes:
        for site, fn in sites.items():
            if site == "ring" and size != sizes[-2]:
                continue
            xs, got = {}, {}
            for arm, m in line.items():
                g = torch.Generator(device=dev).manual_seed(1000 + m.index)
                xs[arm] = torch.randn((1, size // 4), generator=g,
                                      device=dev)
                got[arm] = (m.index, _digest(fn(xs[arm], m)))
            ms = {"rank": [], "perm": []}
            for arm in ("rank", "perm", "perm", "rank") * ORDER_ROUNDS:
                ms[arm].append(per_call_ms(
                    lambda a=arm: fn(xs[a], line[a])))
            every = rt.gather(got)
            same = all(dict(d["rank"] for d in every)[p] ==
                       dict(d["perm"] for d in every)[p] for p in range(n))
            ok = ok and same
            slow = rt.gather({a: min(v) for a, v in ms.items()})
            say({"sum" if site != "ring" else "ring": site, "bytes": size,
                 "perm": list(perm), "iters": iters, "bitwise": same,
                 "rank_ms": max(r["rank"] for r in slow),
                 "perm_ms": max(r["perm"] for r in slow),
                 "every_rank": slow})
    step = _order_step(rt, perm, cpu)
    ok = ok and step["bitwise"]
    say(step)
    joins = _order_joins(rt, line["perm"], cpu)
    for row in joins:
        ok = ok and row["ok"]
        say(row)
    rt.close()
    return 0 if ok else 1


def _digest(t) -> str:
    import torch

    return hashlib.sha1(t.detach().contiguous().view(-1).view(
        torch.uint8).cpu().numpy().tobytes()).hexdigest()


def _order_step(rt, perm, cpu: bool) -> dict:
    """One flagship dp SGD step on the dp mesh of every rank in rank
    order and over ``perm``, from the same params and global batch: ms
    of each run (rounds rank, perm, perm, rank), the slower rank's, and
    whether every run's new params and loss are bitwise on every rank."""
    import numpy as np
    import torch

    from chip_smoke import TRAIN
    from tpu_p2p_torch.models import flagship as F
    from tpu_p2p_torch.parallel.runtime import local_shard

    n, dev = rt.world, rt.device
    cfg = F.FlagshipConfig(**{
        **{k: v for k, v in TRAIN.items() if k != "vocab"}, "stages": 2,
        **(ORDER_STEP_CPU if cpu else {})})
    start = F.init_flagship_params(cfg, device=dev)
    host = F.flagship_host_batch(cfg, np.random.default_rng(1))
    dims = (n, 1, 1, 1, 1)
    arms = {}
    for arm, ranks in (("rank", None), ("perm", perm)):
        mesh = rt.axis_mesh(dims, F.AXES, ranks=ranks)
        spec = F.flagship_data_spec(mesh)
        params = F.place_flagship_params(start, mesh, cfg)
        batch = [local_shard(a, mesh, spec[:a.ndim]).to(dev) for a in host]
        arms[arm] = (F.make_flagship_train_step(cfg, lr=1e-2, mesh=mesh),
                     params, batch)
    digests, ms = set(), {"rank": [], "perm": []}
    for arm in ("rank*", "perm*") + ("rank", "perm", "perm", "rank") * 2:
        fn, params, (x, t) = arms[arm.rstrip("*")]
        rt.barrier()
        t0 = time.perf_counter()
        new, loss = fn({k: v.clone() for k, v in params.items()}, x, t)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        if arm in ms:  # the first call of each is a warm-up
            ms[arm].append(max(rt.gather(wall)))
        digests.add(_digest(torch.cat(
            [loss.reshape(-1).float()] +
            [new[k].reshape(-1).float() for k in sorted(new)])))
        del new
    same = all(len(d) == 1 for d in rt.gather(digests))
    return {"step": "flagship dp", "dp": n, "perm": list(perm),
            "batch": cfg.batch, "seq": cfg.seq, "blocks": cfg.stages,
            "dtype": cfg.dtype, "bitwise": same, "rank_ms": ms["rank"],
            "perm_ms": ms["perm"]}


def _order_joins(rt, perm_line, cpu: bool) -> list:
    """The three profiled windows of the module docstring → one row each:
    every rank's ragged kinds, unmatched events, device collective events
    launched outside every issue range (``unlabelled``), the events on
    each ``kind|label|edges`` entry, and the checks (``ok``; on the CPU
    there is no device track to join, and nothing is checked)."""
    import tempfile

    import torch

    from chip_smoke import MLP_DM, MLP_FF, MLP_M, MLP_MB, MLP_T, _seeded
    from tpu_p2p_torch.models import moe as M
    from tpu_p2p_torch.models import pipeline as PL
    from tpu_p2p_torch.models import schedule as SCH
    from tpu_p2p_torch.obs import ledger as L
    from tpu_p2p_torch.parallel import collectives as C
    from tpu_p2p_torch.utils.profiling import (
        labelled_collective_intervals, profile_window)

    n, dev = rt.world, rt.device
    card = dev.type == "cuda"

    def joined(name, run, check, world_check=lambda every: True) -> dict:
        led = L.CollectiveLedger()
        with L.recording(led):
            run()
        with tempfile.TemporaryDirectory(prefix="order_join_") as td:
            with L.recording(L.CollectiveLedger()):
                path = profile_window(run, td, host=True,
                                      barrier=rt.mesh.barrier)
            join = L.join_trace(led, path)
            ivs = labelled_collective_intervals(path) or []
        on = {}
        for j in join.joined:
            key = f"{j.issue.kind}|{j.issue.label}|{j.issue.edges}"
            on[key] = on.get(key, 0) + 1
        mine = {"rank": rt.rank, "ragged": list(join.ragged),
                "unmatched": join.unmatched,
                "unlabelled": sum(not iv[3] for iv in ivs), "events": on,
                "rows": len(led.issues), "unrowed": len(led.unrowed)}
        mine["ok"] = (not card) or (
            not join.no_device_track and not join.ragged
            and not join.unmatched and not mine["unlabelled"]
            and check(led, join))
        every = rt.gather(mine)
        return {"join": name, "ok": all(r["ok"] for r in every)
                and (not card or world_check(every)), "ranks": every}

    # the sums of the permuted line: the hops' events on their own entries
    cache = C.CollectiveCache()
    fns = (cache.all_reduce(perm_line, "d"),
           cache.reduce_scatter(perm_line, "d"))
    x = torch.randn((1, (64 << 10 if cpu else 32 << 20) // 4),
                    generator=torch.Generator(device=dev).manual_seed(7),
                    device=dev)

    def sums():
        for fn in fns:
            fn(x)
        if card:
            torch.cuda.synchronize()

    def sums_ok(led, join) -> bool:
        kinds = {j.issue.kind for j in join.joined}
        return (len(led.unrowed) == 2 and kinds >= {"all_reduce",
                                                    "reduce_scatter"}
                and all(j.issue.label == "sum_mesh_order"
                        for j in join.joined if j.issue.kind == "ppermute"))

    def hops_seen(every) -> bool:  # ranks that swap send; others copy
        return sum(v for r in every for k, v in r["events"].items()
                   if k.startswith("ppermute|sum_mesh_order")) > 0

    rows = [joined("sums on the permuted line", sums, sums_ok, hops_seen)]

    # GPipe over the library transport: autograd's reverse hops
    w = ORDER_PP_CPU if cpu else dict(dm=MLP_DM, ff=MLP_FF, mb=MLP_MB,
                                      t=MLP_T)
    pp = rt.axis_mesh((n,), ("pp",))
    cfg = PL.PipelineConfig(d_model=w["dm"], d_ff=w["ff"], stages=n,
                            microbatches=MLP_M)
    placed = PL.place_pipeline_params(PL.init_pipeline_params(cfg), pp,
                                      device=dev)
    xb = _seeded((w["mb"] * MLP_M, w["t"], w["dm"]), 11, dev, torch.float32)
    tb = _seeded((w["mb"] * MLP_M, w["t"], w["dm"]), 12, dev, torch.float32)
    step = SCH.make_tick_train_step(pp, cfg, SCH.compile_gpipe(MLP_M, n),
                                    transport="xla")

    def pp_step():
        step({k: v.clone() for k, v in placed.items()}, xb, tb)
        if card:
            torch.cuda.synchronize()

    def pp_ok(led, join) -> bool:
        ship = {it.edges for it in led.issues if it.label == "pp_stage_ship"}
        if len(ship) != 1 or not led.unrowed:
            return False
        fwd = ship.pop()
        rev = tuple((d, s) for s, d in fwd)
        on = [j.issue.edges for j in join.joined
              if j.issue.label == "pp_stage_ship"]
        return on.count(fwd) == on.count(rev) > 0

    rows.append(joined("gpipe over NCCL", pp_step, pp_ok))

    # an MoE layer's forward and backward: autograd's inverse all-to-alls
    ep = rt.axis_mesh((n,), ("ep",)).line("ep")
    d = 64 if cpu else 2048
    mcfg = M.MoEConfig(d_model=d, d_ff=4 * d, num_experts=n,
                       capacity_factor=2.0, group_size=0)
    full = M.init_moe_params(mcfg)
    mp = {"router": full["router"].to(dev),
          "w1": full["w1"][ep.index:ep.index + 1].to(dev),
          "w2": full["w2"][ep.index:ep.index + 1].to(dev)}
    mp = {k: v.requires_grad_(True) for k, v in mp.items()}
    mx = _seeded((64 if cpu else 4096, d), 13 + ep.index, dev,
                 torch.float32).requires_grad_(True)

    def moe_step():
        M.moe_layer_local(mp, mx, mcfg, ep).square().sum().backward()
        if card:
            torch.cuda.synchronize()

    def moe_ok(led, join) -> bool:
        rows_a2a = sum(it.kind == "all_to_all" for it in led.issues)
        got = sum(j.issue.kind == "all_to_all" for j in join.joined)
        return bool(led.unrowed) and rows_a2a > 0 and got >= 2 * rows_a2a

    rows.append(joined("moe forward and backward over NCCL", moe_step,
                       moe_ok))
    return rows


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
    p.add_argument("--set", choices=("transfers", "model", "mesh_order"),
                   default="transfers", help="which cells to run")
    p.add_argument(WIDE, action="store_true", help=argparse.SUPPRESS)
    p.add_argument(ORDER, action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.wide_rank:
        return wide_rank(args.cpu)
    if args.order_rank:
        return order_rank(args.cpu)
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
    elif args.set == "mesh_order":
        if n < 3:
            print("collectives_cards: the mesh-order set needs 3 or more "
                  "cards (a sum of 2 takes no hop)", file=sys.stderr)
            return 2
        runs = [("mesh order", torchrun,
                 [os.path.abspath(__file__), ORDER], ["--cpu"] if args.cpu
                 else [])]
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
