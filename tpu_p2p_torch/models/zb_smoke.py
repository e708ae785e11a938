"""``python -m tpu_p2p_torch zb`` — the graded zero-bubble schedule smoke,
the port of ``tpu_p2p/models/zb_smoke.py``.

Builds both schedule routes of the flagship step on a pure-pp mesh over
the whole world (one transformer block a pp rank, dense FFN): the fused
step as ``pp_schedule="1f1b"`` runs it (masked lowering) and the zb
route under the switch lowering (the ZB-H1 weight split of
:mod:`tpu_p2p_torch.models.zb_split`), then

1. holds the two losses bitwise equal (the same arithmetic in the same
   per-stage order: a difference is a broken executor, not noise), and
2. grades the time a step: zb must beat the fused step on a real
   pipeline (pp > 1); on one device ``compile_zb`` is the fused
   schedule, so zb must not lose by more than 10 %.

Each arm's step time is the slope of :func:`~tpu_p2p_torch.utils.timing.
measure_differential` between two chain lengths, rank 0's, shared with
every rank so the verdict and the exit code agree. Exit 1 unless both
hold; the last stdout line (rank 0) is a JSON object with the measured
pair and ``pp_zb_vs_fused_ratio``.

    python -m tpu_p2p_torch zb                 # one card (or torchrun N)
    python -m tpu_p2p_torch zb --cpu-mesh 8    # a gloo world of 8 ranks
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import Optional, Sequence

__all__ = ["run_smoke", "main"]


def _arm(mesh, n: int, mode: str, lowering: str, *, microbatches: int,
         seq: int, iters: int, repeats: int):
    """Build and time one arm: ``(step_ms, loss)`` of the flagship step
    under ``pp_schedule=mode`` and ``tick_lowering=lowering``."""
    import numpy as np

    from tpu_p2p_torch.models import flagship as F
    from tpu_p2p_torch.utils import timing

    cfg = F.FlagshipConfig(
        batch=4, seq=seq, heads=4, head_dim=32, stages=n,
        microbatches=microbatches, dense_ffn=True, moe_mult=2,
        dtype="float32", pp_schedule=mode, tick_lowering=lowering,
    )
    params = F.place_flagship_params_pipelined(
        F.init_flagship_params(cfg, device="cpu"), mesh, cfg)
    spec = F.flagship_data_spec(mesh)
    x, t = (F.local_shard(a, mesh, spec).contiguous().to(mesh.device)
            for a in F.flagship_host_batch(cfg, np.random.default_rng(1)))
    step = F.make_flagship_train_step_1f1b(mesh, cfg, lr=1e-2)
    loss = float(step(params, x, t)[1])
    if not math.isfinite(loss):
        raise RuntimeError(
            f"pp_schedule={mode}/{lowering} loss non-finite")

    def make_chain(k):
        def chain(p):
            out = None
            for _ in range(k):
                p, out = step(p, x, t)
            return out

        return chain

    s = timing.measure_differential(make_chain, params, iters,
                                    repeats=repeats, barrier=mesh.barrier)
    # Rank 0's slope, on every rank: the verdict must be one.
    per_op = _from_first(mesh, None if s.timed_out else s.mean_region)
    if per_op is None or not (per_op > 0 and math.isfinite(per_op)):
        raise RuntimeError(
            f"pp_schedule={mode}/{lowering} slope was not positive")
    return round(per_op * 1e3, 3), loss


def _from_first(mesh, value):
    """The first rank's ``value`` on every rank of ``mesh``."""
    import torch.distributed as dist

    if mesh.size == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=mesh.ranks[0],
                               group=mesh.host_group)
    return box[0]


def run_smoke(mesh, out=None, *, microbatches: int = 4, seq: int = 64,
              iters: int = 8, repeats: int = 2) -> dict:
    """The graded fused-vs-zb comparison on ``mesh`` (1-D, axis "pp",
    every rank of the world) → the result dict; ``ok`` carries the
    grade. Rank 0 writes to ``out`` (default stdout)."""
    out = out if out is not None else sys.stdout
    n = mesh.size
    printer = mesh.index == 0

    def say(line: str) -> None:
        if printer:
            out.write(line + "\n")
            out.flush()

    say(f"# zb smoke: {n} device(s), stages={n} "
        f"microbatches={microbatches} seq={seq} (one transformer "
        "block per pp rank, dense FFN)")
    ms_fused, loss_fused = _arm(mesh, n, "1f1b", "masked",
                                microbatches=microbatches, seq=seq,
                                iters=iters, repeats=repeats)
    say(f"# fused production step (masked lowering): "
        f"{ms_fused} ms, loss {loss_fused}")
    ms_zb, loss_zb = _arm(mesh, n, "zb", "switch",
                          microbatches=microbatches, seq=seq,
                          iters=iters, repeats=repeats)
    say(f"# zb route (switch lowering, ZB-H1 weight split): "
        f"{ms_zb} ms, loss {loss_zb}")

    # Bitwise, not approximate: both arms run the same arithmetic in
    # the same per-stage order, so the time is not graded off diverging
    # computations.
    bitwise = loss_fused == loss_zb
    if not bitwise:
        say(f"# FAIL: loss divergence (fused {loss_fused!r} vs "
            f"zb {loss_zb!r}) — executor broken, wall clock "
            "not graded")
    ratio = round(ms_zb / ms_fused, 4) if ms_fused else None
    # A strict win on a real pipeline; one device runs the fused
    # schedule under both names and only has to not lose beyond 10 %.
    limit = ms_fused * (1.10 if n == 1 else 1.0)
    beats = ms_zb < limit
    if not beats:
        say(f"# FAIL: zb did not beat the fused step "
            f"({ms_zb} ms vs {ms_fused} ms, ratio {ratio})")
    res = {
        "zb_devices": n,
        "pp_step_ms_fused": ms_fused,
        "pp_step_ms_zb": ms_zb,
        "pp_zb_vs_fused_ratio": ratio,
        "loss_bitwise": bitwise,
        "ok": bool(bitwise and beats),
    }
    say(json.dumps(res))
    return res


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_p2p_torch zb",
        description="Graded zero-bubble schedule smoke: the fused step "
                    "vs the zb route under the switch tick lowering "
                    "(ZB-H1 weight split) — bitwise loss parity plus "
                    "the wall-clock grade; nonzero exit unless zb beats "
                    "the fused step where the analytic model says it "
                    "must.",
    )
    p.add_argument("--microbatches", type=int, default=4,
                   help="pipeline microbatches (the zb split needs a "
                        "real warmup/drain to fill)")
    p.add_argument("--seq", type=int, default=64,
                   help="sequence length of the smoke flagship")
    p.add_argument("--iters", type=int, default=8,
                   help="steps per timed chain (differential slope)")
    p.add_argument("--repeats", type=int, default=2,
                   help="timing repeats per chain length")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default): a card a rank, cuda:LOCAL_RANK; "
                        "cpu: a world of CPU ranks")
    p.add_argument("--cpu-mesh", type=int, default=None, metavar="N",
                   help="run as a gloo world of N CPU ranks (spawned "
                        "here)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _build_parser().parse_args(argv)
    if args.cpu_mesh and "RANK" not in os.environ:
        from tpu_p2p_torch.parallel.launch import spawn

        return max(spawn(args.cpu_mesh, ["-m", "tpu_p2p_torch", "zb",
                                         *argv]))
    from tpu_p2p_torch.utils.errors import fail_fast

    rt = None
    try:
        from tpu_p2p_torch.parallel.runtime import make_runtime

        cpu = bool(args.cpu_mesh) or args.device == "cpu"
        rt = make_runtime(device="cpu" if cpu else None,
                          axis_names=("pp",))
        res = run_smoke(rt.mesh, microbatches=args.microbatches,
                        seq=args.seq, iters=args.iters,
                        repeats=args.repeats)
        rt.close()
        rt = None
        return 0 if res["ok"] else 1
    except KeyboardInterrupt:
        print("interrupted", file=sys.stderr)
        return 130
    except Exception as e:  # noqa: BLE001 — the CLI's one fail-fast exit
        return fail_fast(e)
    finally:
        if rt is not None:  # a failed rank leaves the world too
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
