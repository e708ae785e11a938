"""Command-line entry point of the port: ``python -m tpu_p2p_torch``.

With no subcommand it runs the reference program's benchmark — by
default the uni- then bi-directional all-pairs Gbps matrix at 32 MiB ×
128 iterations of int8 — on a world of ranks, one process per card:

    torchrun --nproc-per-node N -m tpu_p2p_torch [flags]
    python -m tpu_p2p_torch --cpu-mesh N [flags]     # N gloo CPU ranks

``--cpu-mesh N`` spawns the N ranks itself (the counterpart of the
reference's N simulated devices); rank 0 alone prints, and the command
exits with the worst rank's code. ``--pattern`` runs every pattern of
the reference: the transfers (pairwise, latency, loopback, ring,
torus2d over ``--mesh-shape AxB``, all_to_all, allreduce,
reduce_scatter, all_gather) and the model patterns (ring_attention and
ulysses_attention, with ``--flash`` and ``--attn-window``;
flagship_step, with ``--zero-dp``, ``--overlap``, the ``--tp-overlap``
/ ``--ep-overlap`` / ``--pp-overlap`` knobs, and ``--pp-schedule zb`` /
``--tick-lowering switch`` on the tick-IR executor); ``--mode device``
publishes the card's clock, ``--validate-timing`` cross-checks it
against the host clock after the run, ``--profile-dir DIR`` writes a
``torch.profiler`` trace of the run. ``serve`` runs the serving engine,
``train`` the training loop and ``zb`` the graded zero-bubble smoke. The
reference's flags and subcommands the port does not run yet
(``--hybrid``, ``obs``, ``topo``) parse and exit 2 with "not ported
yet".
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from tpu_p2p_torch.config import (
    DIRECTIONS,
    ISOLATIONS,
    MODES,
    PATTERNS,
    PP_SCHEDULES,
    TICK_LOWERINGS,
    TRANSPORTS,
    BenchConfig,
    parse_size,
    parse_sweep,
)
from tpu_p2p_torch.utils.errors import fail_fast

# Flags of the reference CLI that the port parses but does not run.
UNPORTED_FLAGS = ("hybrid",)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu_p2p_torch",
        description=(
            "Interconnect microbenchmarks on NVIDIA GPUs: the all-pairs "
            "P2P bandwidth matrices (the reference workload), ring / "
            "2-D torus shifts, all_to_all and the NCCL reductions, and "
            "small-message latency, over NCCL or the hand-written "
            "peer-push kernel; ring and Ulysses sequence-parallel "
            "attention and the five-axis flagship train step."
        ),
    )
    p.add_argument("--pattern", choices=PATTERNS, default="pairwise",
                   help="workload to run (default: the reference's "
                        "all-pairs matrix)")
    p.add_argument("--msg-size", default=None, metavar="SIZE",
                   help="payload per message, e.g. 4KiB, 32MiB, 1GiB "
                        "(default: 32MiB per the reference; latency/"
                        "loopback default to their metric sizes 8B/4KiB)")
    p.add_argument("--sweep", default=None, metavar="LO:HI|A,B,...",
                   help="message-size sweep: power-of-two range "
                        "'1KiB:1GiB' or explicit list")
    p.add_argument("--iters", type=int, default=128,
                   help="messages per measured cell (reference: 128)")
    p.add_argument("--warmup", type=int, default=1,
                   help="untimed warm-up calls per cell (reference: 0)")
    p.add_argument("--dtype", default="int8",
                   help="payload dtype (reference: int8)")
    p.add_argument("--direction", choices=DIRECTIONS, default="both",
                   help="pairwise sweeps to run (reference runs uni then bi)")
    p.add_argument("--mode", choices=MODES, default="serialized",
                   help="serialized = one message in flight (reference "
                        "semantics); fused = dependent hops launched back "
                        "to back, drained once; differential = slope "
                        "between two chain lengths; device = that slope "
                        "on the card's clock (kernel spans of a "
                        "torch.profiler trace)")
    p.add_argument("--transport", choices=TRANSPORTS, default="xla",
                   help="xla = the library collective (NCCL send/recv; "
                        "gloo on the CPU); pallas_dma = the hand-written "
                        "CUDA peer-push kernel over CUDA IPC windows")
    p.add_argument("--isolation", choices=ISOLATIONS, default="full",
                   help="full = every rank takes part in each pair's "
                        "transfer; submesh = a process group per pair")
    p.add_argument("--num-devices", type=int, default=None,
                   help="use N devices (with --cpu-mesh: a world of N)")
    p.add_argument("--mesh-shape", default=None, metavar="AxB",
                   help="2D rank mesh, e.g. 4x2 (required for torus2d)")
    p.add_argument("--hybrid", action="store_true",
                   help="multi-slice mesh (not ported yet)")
    p.add_argument("--fused-repeats", type=int, default=3,
                   help="timed chain executions in fused mode")
    p.add_argument("--timeout", type=float, default=None, metavar="SECONDS",
                   help="per-transfer watchdog; wedged cells report NaN "
                        "instead of hanging")
    p.add_argument("--check", action="store_true",
                   help="verify payload contents after transfer")
    p.add_argument("--jsonl", default=None, metavar="PATH",
                   help="append per-cell JSONL records")
    p.add_argument("--resume", action="store_true",
                   help="skip cells already recorded in --jsonl")
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the run into DIR "
                        "(one Chrome-trace file a rank)")
    p.add_argument("--validate-timing", action="store_true",
                   help="after the run, cross-check the host differential "
                        "slope against the card's clock on a canonical "
                        "chain (loopback on 1 rank, ring otherwise); "
                        "MISMATCH exits nonzero")
    p.add_argument("--flash", action="store_true",
                   help="ring_attention / ulysses_attention: attention "
                        "in the hand-written flash kernels")
    p.add_argument("--attn-window", type=int, default=0, metavar="W",
                   help="ring/ulysses_attention: sliding-window "
                        "attention; windowed contiguous rings drop their "
                        "dead hops")
    p.add_argument("--zero-dp", action="store_true",
                   help="flagship_step: ZeRO-3 parameter sharding over "
                        "the dp axis")
    p.add_argument("--overlap", choices=("none", "prefetch"), default="none",
                   help="flagship_step + --zero-dp: the ZeRO gather "
                        "schedule (prefetch = each block's gather issued "
                        "one block ahead)")
    p.add_argument("--tp-overlap", choices=("none", "ring"), default="none",
                   help="flagship_step: the tp-join schedule (ring = ring "
                        "collective-matmuls, each chunk's hop in flight "
                        "beside its neighbour's product)")
    p.add_argument("--ep-overlap", choices=("none", "ring"), default="none",
                   help="flagship_step: the MoE reshard schedule (ring = "
                        "shift hops beside the expert products)")
    p.add_argument("--pp-overlap", choices=("none", "wave"), default="none",
                   help="flagship_step: the stage-hop schedule (wave = the "
                        "hop as token-chunk hops)")
    p.add_argument("--pp-schedule", choices=PP_SCHEDULES, default="1f1b",
                   help="flagship_step: the pipeline tick schedule (zb = "
                        "the zero-bubble dB/dW split on the tick-IR "
                        "executor)")
    p.add_argument("--tick-lowering", choices=TICK_LOWERINGS,
                   default="masked",
                   help="flagship_step: the tick lowering (switch = each "
                        "rank dispatches its own tick, idle ranks skip "
                        "the compute)")
    p.add_argument("--cpu-mesh", type=int, default=None, metavar="N",
                   help="run as a gloo world of N CPU ranks (spawned here)")
    p.add_argument("--list-devices", action="store_true",
                   help="print the validated device/placement table and exit")
    return p


def unported(args: argparse.Namespace) -> Optional[str]:
    """The first flag of the reference CLI this run sets that the port
    does not run yet, or None."""
    defaults = build_parser().parse_args([])
    for flag in UNPORTED_FLAGS:
        if getattr(args, flag) != getattr(defaults, flag):
            return "--" + flag.replace("_", "-")
    return None


def config_from_args(args: argparse.Namespace) -> BenchConfig:
    mesh_shape = None
    if args.mesh_shape:
        try:
            mesh_shape = tuple(int(d)
                               for d in args.mesh_shape.lower().split("x"))
        except ValueError:
            raise SystemExit(
                f"--mesh-shape must look like 4x2, got {args.mesh_shape!r}"
            )
    return BenchConfig(
        pattern=args.pattern,
        msg_size=(parse_size(args.msg_size) if args.msg_size is not None
                  else None),
        iters=args.iters,
        warmup=args.warmup,
        dtype=args.dtype,
        direction=args.direction,
        mode=args.mode,
        isolation=args.isolation,
        transport=args.transport,
        num_devices=args.num_devices,
        mesh_shape=mesh_shape,
        sweep=parse_sweep(args.sweep) if args.sweep else None,
        fused_repeats=args.fused_repeats,
        timeout_s=args.timeout,
        check=args.check,
        jsonl=args.jsonl,
        resume=args.resume,
        profile_dir=args.profile_dir,
        use_flash=args.flash,
        attn_window=args.attn_window,
        zero_dp=args.zero_dp,
        overlap=args.overlap,
        tp_overlap=args.tp_overlap,
        ep_overlap=args.ep_overlap,
        pp_overlap=args.pp_overlap,
        pp_schedule=args.pp_schedule,
        tick_lowering=args.tick_lowering,
    )


def _print_devices(rt) -> None:
    import torch

    name = (torch.cuda.get_device_name(rt.device)
            if rt.device.type == "cuda" else "cpu")
    names = rt.gather(f"{name} ({rt.device})")
    if rt.rank != 0:
        return
    print(f"{rt.num_devices} devices on {rt.placement.num_hosts} host(s), "
          f"{rt.placement.devices_per_host} per host; mesh axes "
          f"{rt.mesh.shape}")
    for i, kind in enumerate(names):
        print(f"  [{i}] {kind} host={rt.placement.host_of[i]} "
              f"local={rt.placement.local_ids[i]}")


def _validate_timing(rt, cfg: BenchConfig) -> int:
    """Cross-check the host differential slope against the card's clock
    on one canonical chain of this mesh (reference ``cli.py:224``): a
    ring along the first axis over ``cfg.transport`` on 2 or more ranks,
    the loopback rewrite on 1. Rank 0 prints one line; a MISMATCH exits
    1 on the rank that saw it."""
    import numpy as np

    from tpu_p2p_torch.parallel import collectives as C
    from tpu_p2p_torch.utils import timing
    from tpu_p2p_torch.utils.profiling import validate_differential

    cache = C.CollectiveCache()
    msg = cfg.msg_size or 4 * 1024 * 1024
    x = C.make_payload(rt.mesh, msg, dtype=np.dtype(cfg.dtype))
    n = rt.num_devices
    if n >= 2:
        axis = rt.mesh.axis_names[0]
        edges = C.ring_edges(rt.mesh.shape[axis])
        chain_of = lambda k: cache.permute_chain(  # noqa: E731
            rt.mesh, axis, edges, k, transport=cfg.transport)
        label = f"ring ppermute x{n}"
    else:
        chain_of = lambda k: cache.loopback_chain(rt.mesh, k)  # noqa: E731
        label = "loopback rewrite"
    # 128-op chains: the long-short difference must clear the host
    # clock's jitter for the host slope to mean anything.
    v = validate_differential(chain_of, x, max(128, cfg.iters),
                              timing=timing, repeats=5,
                              timeout_s=cfg.timeout_s, barrier=rt.barrier)
    if rt.rank == 0:
        print(f"# {v.describe()}  [{label}, {msg} B]", flush=True)
    return 0 if v.ok in (True, None) else 1


def _profiled(rt, cfg: BenchConfig, run) -> None:
    """``run()`` under ``torch.profiler`` (the card's kernels too on a
    card), the trace written to ``cfg.profile_dir`` as
    ``rank{R}.trace.json``."""
    import os

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if rt.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(cfg.profile_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        run()
    prof.export_chrome_trace(
        os.path.join(cfg.profile_dir, f"rank{rt.rank}.trace.json"))


def run_benchmark(rt, cfg: BenchConfig) -> None:
    """What ``main`` runs once the world exists: the configured pattern
    on every rank, rank 0 printing, under the profiler when
    ``cfg.profile_dir`` is set. Library callers that build their own
    runtime (``make_runtime(device=...)``) call this."""
    from tpu_p2p_torch.utils.report import JsonlWriter, load_done_cells
    from tpu_p2p_torch.workloads import WORKLOADS
    from tpu_p2p_torch.workloads.base import WorkloadContext

    ctx = WorkloadContext(
        rt=rt, cfg=cfg,
        jsonl=JsonlWriter(cfg.jsonl) if cfg.jsonl else None,
        done=load_done_cells(cfg.jsonl) if cfg.resume else {},
    )
    done_sets = rt.gather(sorted(map(repr, ctx.done)))
    if any(d != done_sets[0] for d in done_sets):
        raise RuntimeError(
            "ranks disagree on the --resume done-cell set; put the "
            "--jsonl log on a filesystem shared by every process")
    try:
        if cfg.profile_dir:
            _profiled(rt, cfg, lambda: WORKLOADS[cfg.pattern](ctx))
        else:
            WORKLOADS[cfg.pattern](ctx)
    finally:
        if ctx.jsonl is not None:
            ctx.jsonl.close()


def bench_main(argv: Sequence[str]) -> int:
    import os

    args = build_parser().parse_args(argv)
    what = unported(args)
    if what is not None:
        print(f"python -m tpu_p2p_torch: {what} is not ported yet",
              file=sys.stderr)
        return 2
    try:
        cfg = config_from_args(args)
    except ValueError as e:
        return fail_fast(e)
    if args.cpu_mesh and "RANK" not in os.environ:
        n = args.cpu_mesh
        if args.num_devices is not None:
            if args.num_devices > n:
                print(f"Failed: requested {args.num_devices} devices but "
                      f"only {n} visible", file=sys.stderr)
                return 1
            n = args.num_devices
        from tpu_p2p_torch.parallel.launch import spawn

        return max(spawn(n, ["-m", "tpu_p2p_torch", *argv]))
    try:
        from tpu_p2p_torch.parallel.runtime import make_runtime

        rt = make_runtime(num_devices=cfg.num_devices,
                          device="cpu" if args.cpu_mesh else None,
                          mesh_shape=cfg.mesh_shape)
        rc = 0
        if args.list_devices:
            _print_devices(rt)
        else:
            run_benchmark(rt, cfg)
            if args.validate_timing:
                rc = _validate_timing(rt, cfg)
        rt.close()
        return rc
    except KeyboardInterrupt:
        print("interrupted", file=sys.stderr)
        return 130
    except SystemExit:
        raise
    except BaseException as e:  # noqa: BLE001 — single fail-fast handler
        return fail_fast(e)
    finally:
        # A failed rank leaves the world too, so its groups' threads end
        # before the interpreter does.
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "serve":
        from tpu_p2p_torch.serve.engine import main as serve_main

        return serve_main(argv[1:])
    if argv and argv[0] == "train":
        from tpu_p2p_torch.train import main as train_main

        return train_main(argv[1:])
    if argv and argv[0] == "zb":
        from tpu_p2p_torch.models.zb_smoke import main as zb_main

        return zb_main(argv[1:])
    if argv and argv[0] in ("obs", "topo"):
        print(f"python -m tpu_p2p_torch: {argv[0]} is not ported yet; "
              "available: the benchmark (no subcommand), serve, train, zb",
              file=sys.stderr)
        return 2
    return bench_main(argv)
