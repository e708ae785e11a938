"""The flagship training loop on one device — the port of
``tpu_p2p/train.py``'s plain-SGD path.

``python -m tpu_p2p_torch train --dense-ffn --steps 4 ...`` (or
``python -m tpu_p2p_torch.train``) trains the flagship model on seeded
synthetic data and prints the reference's JSONL records (``step``,
``loss``, ``wall_s``, ``tokens_per_s_wall``) and its closing
``{"summary": ...}`` line. It runs on the card unless ``--device cpu``
is given; ``--device cuda`` without a card raises, nothing falls back.

Batches are generated per step from ``seed`` and the global step index
(byte-identical to the reference's stream), go to the device through
:class:`tpu_p2p_torch.utils.data.DeviceLoader`, and the step updates
the params in place (the reference donates them). Every reference flag
parses; the flags whose machinery is not ported (optax optimizers and
schedules, evaluation, checkpoints and recovery, fault injection,
observability, the CPU mesh, remat, FSDP, the mesh overlaps and
schedules, the MoE FFN) exit with "not ported yet" when set.
"""

from __future__ import annotations

import argparse
import json
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
    ("trace", "--trace"), ("cpu_mesh", "--cpu-mesh"),
    ("remat", "--remat"), ("zero_dp", "--zero-dp"),
    ("overlap", "--overlap"), ("tp_overlap", "--tp-overlap"),
    ("ep_overlap", "--ep-overlap"), ("pp_overlap", "--pp-overlap"),
    ("pp_chunks", "--pp-chunks"), ("sp_strategy", "--sp-strategy"),
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
                 log_stream=None, device="cuda", **unported) -> dict:
    """Train the flagship for ``steps`` steps of plain SGD on ``device``;
    returns a summary dict (``final_loss``, ``steps_run``,
    ``start_step``, ``params``).

    Every ``log_every`` steps (and at the last) one JSONL record goes to
    ``log_stream`` and/or is appended to ``log_path``; reading its loss
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
    device = torch.device(device)
    resolve_device(device.type)  # "cuda" without a card raises
    params = F.init_flagship_params(cfg, seed=seed, device=device)
    make = (F.make_flagship_lm_train_step if cfg.vocab
            else F.make_flagship_train_step)
    step_fn = make(cfg, lr=lr, donate=True)
    loader = DeviceLoader(_per_step_batches(cfg, seed, 0), device,
                          prefetch=2)

    def emit(rec):
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
        description="Train the flagship model (synthetic data) on one "
                    "device with plain SGD and JSONL logging.",
    )
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--log-jsonl", default=None, metavar="PATH")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="device to train on (default cuda; raises "
                        "without a card)")
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
                   help=nyp + "; use --device cpu")
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
    p.add_argument("--vocab", type=int, default=0)
    p.add_argument("--attn-window", type=int, default=0)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--param-dtype", default="",
                   help="param storage dtype (e.g. float32 master "
                        "weights with --dtype bfloat16 compute)")
    p.add_argument("--sp-strategy", default="ring",
                   choices=("ring", "ring_zigzag", "ulysses"),
                   help="ring (one device: no sequence parallelism); "
                        "the others are " + nyp)
    for flag in ("flash", "norm", "dense-ffn", "rope", "remat", "zero-dp"):
        p.add_argument(f"--{flag}", action="store_true")
    p.add_argument("--overlap", default="none", choices=("none", "prefetch"),
                   help=nyp)
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
    if not args.dense_ffn:
        return "the MoE FFN (no --dense-ffn)"
    return None


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    flag = _not_ported(args)
    if flag is not None:
        print(f"train {flag}: not ported yet", file=sys.stderr)
        return 2
    from tpu_p2p_torch.models.flagship import FlagshipConfig

    try:
        cfg = FlagshipConfig(
            batch=args.batch, seq=args.seq, heads=args.heads,
            kv_heads=args.kv_heads, head_dim=args.head_dim,
            stages=args.stages, microbatches=args.microbatches,
            num_experts=args.experts, vocab=args.vocab,
            attn_window=args.attn_window, dtype=args.dtype,
            param_dtype=args.param_dtype, use_flash=args.flash,
            norm=args.norm, dense_ffn=args.dense_ffn, rope=args.rope,
        )
        summary = run_training(
            cfg, steps=args.steps, lr=args.lr, seed=args.seed,
            log_every=args.log_every, log_path=args.log_jsonl,
            log_stream=sys.stdout, device=args.device)
    except KeyboardInterrupt:
        return 130
    except Exception as e:  # noqa: BLE001 — the CLI's one fail-fast exit
        print(f"Failed: {type(e).__name__} '{e}'", file=sys.stderr)
        traceback.print_exception(e, file=sys.stderr)
        return 1
    summary.pop("params")
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
