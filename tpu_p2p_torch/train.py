"""The flagship training loop over the five-axis mesh — the port of
``tpu_p2p/train.py``'s plain-SGD path.

``python -m tpu_p2p_torch train --steps 4 ...`` (or ``python -m
tpu_p2p_torch.train``) trains the flagship model (the MoE FFN, or the
dense one with ``--dense-ffn``) on seeded synthetic data on
``build_mesh(world)``: one rank a card under ``torchrun
--nproc-per-node N`` (NCCL), ``--cpu-mesh N`` spawned gloo CPU ranks,
or a world of one. Rank 0 prints the reference's JSONL records
(``step``, ``loss``, ``wall_s``, ``tokens_per_s_wall``) and its closing
``{"summary": ...}`` line. It runs on the card unless ``--device cpu``
(or ``--cpu-mesh``) is given; ``--device cuda`` without a card raises,
nothing falls back.

Batches are generated per step from ``seed`` and the global step index
(byte-identical to the reference's stream); each rank's
:class:`tpu_p2p_torch.utils.data.DeviceLoader` keeps its (dp·ep, sp)
block, and the step updates the rank's param shards in place (the
reference donates them). ``--zero-dp`` keeps each rank's dp shard of
the params (ZeRO-3, gathered on use; ``--overlap prefetch`` gathers one
block ahead) and ``--remat`` recomputes each block inside the backward.
Every reference flag parses; the flags whose machinery is not ported
(optax optimizers and schedules, evaluation, checkpoints and recovery,
fault injection, observability, the tp/ep/pp overlaps and the pipeline
schedules) exit with "not ported yet" when set. ``--mesh-shape`` (dp x pp x sp x tp x ep) and ``--moe-mult`` are
the port's own: a mesh other than ``build_mesh``'s
factoring, and the FFN width of the 4x-FFN configurations.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Iterator, Optional

import numpy as np

CKPT_KEEP = 3                      # reference: tpu_p2p/config.py
PP_SCHEDULES = ("1f1b", "zb")
TICK_LOWERINGS = ("masked", "switch")

# run_training keywords whose machinery is not ported, with the
# reference's defaults (a non-default value raises).
_RUN_NOT_PORTED = {
    "ckpt_dir": None, "ckpt_every": 0, "ckpt_keep": None, "resume": False,
    "optimizer": "sgd", "weight_decay": 0.0, "eval_every": 0,
    "eval_batches": 2, "clip_norm": 0.0, "warmup_steps": 0,
    "schedule": "constant", "obs_jsonl": None, "fault_plan": None,
    "heal": False, "health_config": None, "obs_window_step": None,
}

# CLI flags whose machinery is not ported: (argparse dest, flag).
_FLAGS_NOT_PORTED = (
    ("optimizer", "--optimizer"), ("weight_decay", "--weight-decay"),
    ("clip_norm", "--clip-norm"), ("warmup_steps", "--warmup-steps"),
    ("schedule", "--schedule"), ("eval_every", "--eval-every"),
    ("eval_batches", "--eval-batches"), ("ckpt_dir", "--ckpt-dir"),
    ("ckpt_every", "--ckpt-every"), ("ckpt_keep", "--ckpt-keep"),
    ("resume", "--resume"), ("supervise", "--supervise"),
    ("max_restarts", "--max-restarts"), ("heal", "--heal"),
    ("fault_degrade_edge", "--fault-degrade-edge"),
    ("fault_degrade_factor", "--fault-degrade-factor"),
    ("fault_slow_rank", "--fault-slow-rank"),
    ("fault_slow_ms", "--fault-slow-ms"),
    ("fault_lost_host", "--fault-lost-host"),
    ("fault_at_step", "--fault-at-step"),
    ("fault_ckpt_crash_bytes", "--fault-ckpt-crash-bytes"),
    ("fault_ckpt_corrupt_seed", "--fault-ckpt-corrupt-seed"),
    ("fault_ckpt_io_errors", "--fault-ckpt-io-errors"),
    ("obs_jsonl", "--obs-jsonl"), ("obs_window_step", "--obs-window-step"),
    ("trace", "--trace"), ("tp_overlap", "--tp-overlap"),
    ("ep_overlap", "--ep-overlap"), ("pp_overlap", "--pp-overlap"),
    ("pp_chunks", "--pp-chunks"),
    ("pp_schedule", "--pp-schedule"), ("tick_lowering", "--tick-lowering"),
)


def _per_step_batches(cfg, seed: int, start_step: int) -> Iterator:
    """Host batches keyed by (seed, global step) — the reference's
    stream, byte for byte."""
    from tpu_p2p_torch.models.flagship import flagship_host_batch

    step = start_step
    while True:
        rng = np.random.default_rng((seed + 1) * 1_000_003 + step)
        if cfg.vocab:
            toks = rng.integers(0, cfg.vocab, (cfg.batch, cfg.seq + 1))
            toks = toks.astype(np.int32)
            yield toks[:, :-1], toks[:, 1:]
        else:
            yield flagship_host_batch(cfg, rng)
        step += 1


def run_training(cfg, *, steps: int, lr: float = 1e-2, seed: int = 0,
                 log_every: int = 10, log_path: Optional[str] = None,
                 log_stream=None, device="cuda", mesh=None,
                 **unported) -> dict:
    """Train the flagship for ``steps`` steps of plain SGD; returns a
    summary dict (``final_loss``, ``steps_run``, ``start_step``,
    ``params``: this rank's shards).

    ``mesh`` (:func:`tpu_p2p_torch.models.flagship.build_mesh`): train
    this rank's shards on ``mesh.device``; every rank of the mesh calls
    this. ``mesh=None``: the whole model on ``device``. Every
    ``log_every`` steps (and at the last) rank 0 sends one JSONL record
    to ``log_stream`` and/or appends it to ``log_path``; reading its loss
    waits for the device, so ``wall_s`` is real elapsed time. The
    reference's other keywords (checkpoints, optax, eval, obs, faults)
    are accepted at their defaults and raise otherwise.
    """
    import torch

    from tpu_p2p_torch.models import flagship as F
    from tpu_p2p_torch.utils.data import DeviceLoader
    from tpu_p2p_torch.utils.device import resolve_device

    for name, value in unported.items():
        if name not in _RUN_NOT_PORTED:
            raise TypeError(f"run_training() got an unexpected keyword "
                            f"argument {name!r}")
        if value != _RUN_NOT_PORTED[name]:
            raise NotImplementedError(
                f"run_training({name}={value!r}) is not ported yet")
    if mesh is None:
        device = torch.device(device)
        resolve_device(device.type)  # "cuda" without a card raises
        params = F.init_flagship_params(cfg, seed=seed, device=device)
    else:
        device = mesh.device
        params = F.place_flagship_params(
            F.init_flagship_params(cfg, seed=seed, device="cpu"), mesh, cfg)
    make = (F.make_flagship_lm_train_step if cfg.vocab
            else F.make_flagship_train_step)
    step_fn = make(cfg, lr=lr, donate=True, mesh=mesh)
    loader = DeviceLoader(_per_step_batches(cfg, seed, 0), device,
                          prefetch=2, mesh=mesh,
                          spec=F.flagship_data_spec(mesh))
    printer = mesh is None or mesh.index == 0

    def emit(rec):
        if not printer:
            return
        line = json.dumps(rec)
        if log_stream is not None:
            print(line, file=log_stream, flush=True)
        if log_path:
            with open(log_path, "a") as fh:
                fh.write(line + "\n")

    t0 = time.monotonic()
    tokens_per_step = cfg.batch * cfg.seq
    loss = None
    for step in range(steps):
        x, t = next(loader)
        params, loss = step_fn(params, x, t)
        if log_every and ((step + 1) % log_every == 0 or step + 1 == steps):
            loss_f = float(loss)  # waits for the device on log steps
            dt = time.monotonic() - t0
            emit({
                "step": step + 1,
                "loss": round(loss_f, 6),
                "wall_s": round(dt, 3),
                "tokens_per_s_wall": round((step + 1) * tokens_per_step
                                           / dt),
            })
    return {
        "start_step": 0,
        "steps_run": max(0, steps),
        "final_loss": round(float(loss), 6) if loss is not None else None,
        "params": params,
    }


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_p2p_torch train",
        description="Train the flagship model (synthetic data) on the "
                    "five-axis mesh of the world with plain SGD and "
                    "JSONL logging.",
    )
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--log-jsonl", default=None, metavar="PATH")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="device to train on (default cuda, a card a rank; "
                        "raises without a card)")
    nyp = "not ported yet (rejected when set)"
    p.add_argument("--obs-jsonl", default=None, metavar="PATH", help=nyp)
    p.add_argument("--obs-window-step", type=int, default=None,
                   metavar="K", help=nyp)
    p.add_argument("--trace", default=None, metavar="PATH", help=nyp)
    p.add_argument("--ckpt-dir", default=None, metavar="DIR", help=nyp)
    p.add_argument("--ckpt-every", type=int, default=0, metavar="N",
                   help=nyp)
    p.add_argument("--ckpt-keep", type=int, default=CKPT_KEEP, metavar="K",
                   help=nyp)
    p.add_argument("--resume", action="store_true", help=nyp)
    p.add_argument("--supervise", action="store_true", help=nyp)
    p.add_argument("--max-restarts", type=int, default=3, metavar="N",
                   help=nyp)
    p.add_argument("--optimizer", default="sgd", choices=("sgd", "adamw"),
                   help="sgd; adamw is " + nyp)
    p.add_argument("--weight-decay", type=float, default=0.0, help=nyp)
    p.add_argument("--clip-norm", type=float, default=0.0, help=nyp)
    p.add_argument("--warmup-steps", type=int, default=0, help=nyp)
    p.add_argument("--schedule", default="constant",
                   choices=("constant", "cosine"), help=nyp)
    p.add_argument("--eval-every", type=int, default=0, metavar="N",
                   help=nyp)
    p.add_argument("--eval-batches", type=int, default=2, metavar="K",
                   help=nyp)
    p.add_argument("--cpu-mesh", type=int, default=None, metavar="N",
                   help="spawn N CPU ranks (gloo) and train on "
                        "build_mesh(N)")
    p.add_argument("--mesh-shape", default=None, metavar="DPxPPxSPxTPxEP",
                   help="the mesh's dims (default: build_mesh's factoring "
                        "of the world)")
    p.add_argument("--heal", action="store_true", help=nyp)
    p.add_argument("--fault-degrade-edge", default=None, metavar="S:D",
                   help=nyp)
    p.add_argument("--fault-degrade-factor", type=int, default=8,
                   metavar="K", help=nyp)
    p.add_argument("--fault-slow-rank", type=int, default=None, metavar="R",
                   help=nyp)
    p.add_argument("--fault-slow-ms", type=float, default=100.0,
                   metavar="MS", help=nyp)
    p.add_argument("--fault-lost-host", type=int, default=None, metavar="H",
                   help=nyp)
    p.add_argument("--fault-at-step", type=int, default=0, metavar="K",
                   help=nyp)
    p.add_argument("--fault-ckpt-crash-bytes", type=int, default=None,
                   metavar="B", help=nyp)
    p.add_argument("--fault-ckpt-corrupt-seed", type=int, default=None,
                   metavar="S", help=nyp)
    p.add_argument("--fault-ckpt-io-errors", type=int, default=0,
                   metavar="N", help=nyp)
    # Model shape (FlagshipConfig fields).
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--kv-heads", type=int, default=0)
    p.add_argument("--head-dim", type=int, default=32)
    p.add_argument("--stages", type=int, default=2)
    p.add_argument("--microbatches", type=int, default=2)
    p.add_argument("--experts", type=int, default=4)
    p.add_argument("--moe-mult", type=int, default=2,
                   help="FFN width = MOE_MULT x model dim")
    p.add_argument("--vocab", type=int, default=0)
    p.add_argument("--attn-window", type=int, default=0)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--param-dtype", default="",
                   help="param storage dtype (e.g. float32 master "
                        "weights with --dtype bfloat16 compute)")
    p.add_argument("--sp-strategy", default="ring",
                   choices=("ring", "ring_zigzag", "ulysses"))
    for flag in ("flash", "norm", "dense-ffn", "rope", "remat", "zero-dp"):
        p.add_argument(f"--{flag}", action="store_true")
    p.add_argument("--overlap", default="none", choices=("none", "prefetch"),
                   help="ZeRO gather schedule: prefetch gathers each "
                        "block's params one block ahead (needs --zero-dp)")
    p.add_argument("--tp-overlap", default="none", choices=("none", "ring"),
                   help=nyp)
    p.add_argument("--ep-overlap", default="none", choices=("none", "ring"),
                   help=nyp)
    p.add_argument("--pp-overlap", default="none", choices=("none", "wave"),
                   help=nyp)
    p.add_argument("--pp-chunks", type=int, default=4, help=nyp)
    p.add_argument("--pp-schedule", default="1f1b", choices=PP_SCHEDULES,
                   help=nyp)
    p.add_argument("--tick-lowering", default="masked",
                   choices=TICK_LOWERINGS, help=nyp)
    return p


def _not_ported(args: argparse.Namespace) -> Optional[str]:
    """The first flag set whose machinery is not ported, or None."""
    parser = _build_parser()
    for dest, flag in _FLAGS_NOT_PORTED:
        if getattr(args, dest) != parser.get_default(dest):
            return flag
    return None


def config_from_args(args: argparse.Namespace):
    """The ``FlagshipConfig`` of parsed ``train`` arguments."""
    from tpu_p2p_torch.models.flagship import FlagshipConfig

    return FlagshipConfig(
        batch=args.batch, seq=args.seq, heads=args.heads,
        kv_heads=args.kv_heads, head_dim=args.head_dim,
        stages=args.stages, microbatches=args.microbatches,
        num_experts=args.experts, moe_mult=args.moe_mult,
        vocab=args.vocab, attn_window=args.attn_window,
        dtype=args.dtype, param_dtype=args.param_dtype,
        sp_strategy=args.sp_strategy, use_flash=args.flash,
        norm=args.norm, dense_ffn=args.dense_ffn, rope=args.rope,
        remat=args.remat, zero_dp=args.zero_dp, overlap=args.overlap,
    )


def mesh_shape(text: Optional[str], world: int):
    """The mesh's dims: ``--mesh-shape`` parsed, or ``build_mesh``'s
    factoring of ``world``."""
    from tpu_p2p_torch.models.flagship import mesh_dims

    if text is None:
        return mesh_dims(world)
    try:
        dims = tuple(int(d) for d in text.lower().split("x"))
    except ValueError:
        dims = ()
    if len(dims) != 5 or min(dims) < 1:
        raise ValueError(f"--mesh-shape must look like 2x1x2x1x1 (dp x pp "
                         f"x sp x tp x ep), got {text!r}")
    return dims


def _card_report(rt) -> Optional[str]:
    """Rank 0's lines of every rank's peak device memory and flash
    kernel launches over the run (cards only)."""
    import torch

    from tpu_p2p_torch.ops import flash_attention as TFA

    if rt.device.type != "cuda":
        return None
    peaks = rt.gather(round(torch.cuda.max_memory_allocated(rt.device)
                            / 2**30, 3))
    launches = rt.gather(dict(TFA.launches))
    return (f"# peak device memory per rank (GiB): {peaks}\n"
            f"# flash kernel launches per rank: {launches}")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _build_parser().parse_args(argv)
    flag = _not_ported(args)
    if flag is not None:
        print(f"train {flag}: not ported yet", file=sys.stderr)
        return 2
    if args.cpu_mesh and "RANK" not in os.environ:
        from tpu_p2p_torch.parallel.launch import spawn

        return max(spawn(args.cpu_mesh, ["-m", "tpu_p2p_torch.train",
                                         *argv]))
    from tpu_p2p_torch.models.flagship import AXES
    from tpu_p2p_torch.parallel.runtime import make_runtime
    from tpu_p2p_torch.utils.device import resolve_device

    rt = None
    try:
        cfg = config_from_args(args)
        cpu = bool(args.cpu_mesh) or resolve_device(args.device).type \
            == "cpu"
        world = int(os.environ.get("WORLD_SIZE", "1")) \
            if "RANK" in os.environ else 1
        rt = make_runtime(device="cpu" if cpu else None,
                          mesh_shape=mesh_shape(args.mesh_shape, world),
                          axis_names=AXES)
        summary = run_training(
            cfg, steps=args.steps, lr=args.lr, seed=args.seed,
            log_every=args.log_every, log_path=args.log_jsonl,
            log_stream=sys.stdout, mesh=rt.mesh)
        report, rank = _card_report(rt), rt.rank
        rt.close()
        rt = None
    except KeyboardInterrupt:
        return 130
    except Exception as e:  # noqa: BLE001 — the CLI's one fail-fast exit
        print(f"Failed: {type(e).__name__} '{e}'", file=sys.stderr)
        traceback.print_exception(e, file=sys.stderr)
        return 1
    finally:
        if rt is not None:  # a failed rank leaves the world too
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
    summary.pop("params")
    if rank == 0:
        if report:
            print(report, file=sys.stderr)
        print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
