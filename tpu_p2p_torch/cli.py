"""Command-line entry point of the port: ``python -m tpu_p2p_torch``.

With no subcommand it runs the reference program's benchmark — by
default the uni- then bi-directional all-pairs Gbps matrix at 32 MiB ×
128 iterations of int8 — on a world of ranks, one process per card:

    torchrun --nproc-per-node N -m tpu_p2p_torch [flags]
    python -m tpu_p2p_torch --cpu-mesh N [flags]     # N gloo CPU ranks

``--cpu-mesh N`` spawns the N ranks itself (the counterpart of the
reference's N simulated devices); rank 0 alone prints, and the command
exits with the worst rank's code. ``serve`` runs the serving engine and
``train`` the training loop. The reference's other flags and
subcommands parse and exit 2 with "not ported yet".
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

PORTED_PATTERNS = ("pairwise", "latency", "loopback")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu_p2p_torch",
        description=(
            "Interconnect microbenchmarks on NVIDIA GPUs: the all-pairs "
            "P2P bandwidth matrices (the reference workload) and "
            "small-message latency, over NCCL or the hand-written "
            "peer-push kernel."
        ),
    )
    p.add_argument("--pattern", choices=PATTERNS, default="pairwise",
                   help="workload to run (default: the reference's "
                        "all-pairs matrix); ported: "
                        + ", ".join(PORTED_PATTERNS))
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
                        "between two chain lengths (device: not ported)")
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
                   help="2D mesh (not ported yet)")
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
                   help="profiler trace of the run (not ported yet)")
    p.add_argument("--validate-timing", action="store_true",
                   help="host vs device timeline check (not ported yet)")
    p.add_argument("--flash", action="store_true",
                   help="ring_attention flash kernel (not ported yet)")
    p.add_argument("--attn-window", type=int, default=0, metavar="W",
                   help="sliding-window attention (not ported yet)")
    p.add_argument("--zero-dp", action="store_true",
                   help="flagship_step ZeRO-3 (not ported yet)")
    p.add_argument("--overlap", choices=("none", "prefetch"), default="none",
                   help="flagship_step FSDP gather schedule (not ported yet)")
    p.add_argument("--tp-overlap", choices=("none", "ring"), default="none",
                   help="flagship_step tp-join schedule (not ported yet)")
    p.add_argument("--ep-overlap", choices=("none", "ring"), default="none",
                   help="flagship_step MoE reshard schedule (not ported yet)")
    p.add_argument("--pp-overlap", choices=("none", "wave"), default="none",
                   help="flagship_step stage-hop schedule (not ported yet)")
    p.add_argument("--pp-schedule", choices=PP_SCHEDULES, default="1f1b",
                   help="flagship_step tick schedule (not ported yet)")
    p.add_argument("--tick-lowering", choices=TICK_LOWERINGS,
                   default="masked",
                   help="flagship_step tick lowering (not ported yet)")
    p.add_argument("--cpu-mesh", type=int, default=None, metavar="N",
                   help="run as a gloo world of N CPU ranks (spawned here)")
    p.add_argument("--list-devices", action="store_true",
                   help="print the validated device/placement table and exit")
    return p


def unported(args: argparse.Namespace) -> Optional[str]:
    """The first flag of the reference CLI this run sets that the port
    does not run yet, or None."""
    if args.pattern not in PORTED_PATTERNS:
        return f"--pattern {args.pattern}"
    if args.mode == "device":
        return "--mode device"
    defaults = build_parser().parse_args([])
    for flag in ("mesh_shape", "hybrid", "profile_dir", "validate_timing",
                 "flash", "attn_window", "zero_dp", "overlap",
                 "tp_overlap", "ep_overlap", "pp_overlap", "pp_schedule",
                 "tick_lowering"):
        if getattr(args, flag) != getattr(defaults, flag):
            return "--" + flag.replace("_", "-")
    return None


def config_from_args(args: argparse.Namespace) -> BenchConfig:
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
        sweep=parse_sweep(args.sweep) if args.sweep else None,
        fused_repeats=args.fused_repeats,
        timeout_s=args.timeout,
        check=args.check,
        jsonl=args.jsonl,
        resume=args.resume,
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


def run_benchmark(rt, cfg: BenchConfig) -> None:
    """What ``main`` runs once the world exists: the configured pattern
    on every rank, rank 0 printing. Library callers that build their own
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
        cfg = config_from_args(args)
        from tpu_p2p_torch.parallel.runtime import make_runtime

        rt = make_runtime(num_devices=cfg.num_devices,
                          device="cpu" if args.cpu_mesh else None)
        if args.list_devices:
            _print_devices(rt)
        else:
            run_benchmark(rt, cfg)
        rt.close()
        return 0
    except KeyboardInterrupt:
        print("interrupted", file=sys.stderr)
        return 130
    except SystemExit:
        raise
    except BaseException as e:  # noqa: BLE001 — single fail-fast handler
        return fail_fast(e)


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "serve":
        from tpu_p2p_torch.serve.engine import main as serve_main

        return serve_main(argv[1:])
    if argv and argv[0] == "train":
        from tpu_p2p_torch.train import main as train_main

        return train_main(argv[1:])
    if argv and argv[0] in ("obs", "topo", "zb"):
        print(f"python -m tpu_p2p_torch: {argv[0]} is not ported yet; "
              "available: the benchmark (no subcommand), serve, train",
              file=sys.stderr)
        return 2
    return bench_main(argv)
