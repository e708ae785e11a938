"""The flagship training loop over the five-axis mesh — the port of
``tpu_p2p/train.py``.

``python -m tpu_p2p_torch train --steps 4 ...`` (or ``python -m
tpu_p2p_torch.train``) trains the flagship model (the MoE FFN, or the
dense one with ``--dense-ffn``) on seeded synthetic data on
``build_mesh(world)``: one rank a card under ``torchrun
--nproc-per-node N`` (NCCL), ``--cpu-mesh N`` spawned gloo CPU ranks,
or a world of one. Rank 0 prints the reference's JSONL records
(``step``, ``loss``, ``wall_s``, ``tokens_per_s_wall``; ``eval_loss``
every ``--eval-every`` steps) and its closing ``{"summary": ...}``
line. It runs on the card unless ``--device cpu`` (or ``--cpu-mesh``)
is given; ``--device cuda`` without a card raises, nothing falls back.

Batches are generated per step from ``seed`` and the global step index
(byte-identical to the reference's stream), so a resumed run consumes
exactly the batches the interrupted one would have; each rank's
:class:`tpu_p2p_torch.utils.data.DeviceLoader` keeps its (dp·ep, sp)
block, and the step updates the rank's param shards in place (the
reference donates them). ``--optimizer adamw``, ``--clip-norm``,
``--warmup-steps`` and ``--schedule cosine`` train through the port's
copy of optax (:mod:`tpu_p2p_torch.utils.optim`); ``--ckpt-dir`` /
``--ckpt-every`` / ``--ckpt-keep`` publish durable generations in the
reference's format (:mod:`tpu_p2p_torch.utils.checkpoint`),
``--resume`` continues from the newest intact one, and ``--supervise``
re-enters after a simulated crash mid-save (the ``--fault-ckpt-*``
flags). ``--zero-dp`` keeps each rank's dp shard of the params and
moments (ZeRO-3, gathered on use; ``--overlap prefetch`` gathers one
block ahead), ``--remat`` recomputes each block inside the backward, and
``--tp-overlap ring``, ``--ep-overlap ring`` and ``--pp-overlap wave``
(with ``--pp-chunks N``) overlap the tp joins, the MoE reshards and the
stage hops with compute. ``--obs-jsonl PATH`` turns on the obs
layer: a span-timed step row a step (the loop drains the card every
step), one profiled window (``--obs-window-step``, default the second
step) with its device-busy and overlap fractions and the collective
ledger's join, the health monitor's verdicts, the checkpoint records and
a closing summary; ``--trace PATH`` exports the stream as a Chrome
trace. ``--fault-degrade-edge S:D`` / ``--fault-degrade-factor``,
``--fault-slow-rank`` / ``--fault-slow-ms`` and ``--fault-lost-host``
inject the link, straggler and lost-host faults from ``--fault-at-step``
on, and ``--heal`` reshards the newest intact generation onto the
largest power-of-two set of surviving ranks when the monitor declares a
host lost, and resumes. ``--pp-schedule zb`` and ``--tick-lowering
switch`` are refused, as the reference's loop refuses them.
``--mesh-shape`` (dp x pp x sp x tp x ep) and ``--moe-mult`` are the
port's own: a mesh other than ``build_mesh``'s factoring, and the FFN
width of the 4x-FFN configurations.
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
# reference's defaults (a non-default value raises): none are left.
_RUN_NOT_PORTED: dict = {}

# CLI flags whose machinery is not ported: (argparse dest, flag); none
# are left.
_FLAGS_NOT_PORTED: tuple = ()


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


def _make_eval_fn(cfg, mesh=None):
    """``(params, x, t) → float32 scalar``: the train objective's mean
    over the GLOBAL batch (MSE per element, or CE per token), no update.
    Each rank sums its block in float32; the sums meet over the data
    plane (dp, ep, sp), which leaves the pp and tp copies of the output
    out, and the total is divided by the global count."""
    import torch

    from tpu_p2p_torch.models import flagship as F
    from tpu_p2p_torch.parallel.collectives import all_reduce_flat

    plane = None if mesh is None else mesh.plane(
        F._data_axes(mesh.axis_names))
    if cfg.vocab:
        fwd = F.make_flagship_lm_forward(cfg, mesh)
        count = cfg.batch * cfg.seq

        def local(params, toks, targets):
            logp = torch.log_softmax(fwd(params, toks).float(), dim=-1)
            return -torch.sum(torch.gather(logp, -1,
                                           targets.long()[..., None]))
    else:
        fwd = F.make_flagship_forward(cfg, mesh)
        count = cfg.batch * cfg.seq * cfg.model_dim

        def local(params, x, t):
            return torch.sum((fwd(params, x).float() - t.float()) ** 2)

    def eval_fn(params, x, t):
        with torch.no_grad():
            s = local(params, x, t).reshape(1)
            if plane is not None:
                all_reduce_flat([s], plane, "the eval sum")
            return s[0] / count

    return eval_fn


def _broadcast(mesh, obj):
    """``obj`` as the mesh's first rank holds it, on every rank."""
    if mesh is None or mesh.size == 1:
        return obj
    import torch.distributed as dist

    box = [obj]
    dist.broadcast_object_list(box, src=mesh.ranks[0],
                               group=mesh.host_group)
    return box[0]


def _load_resume(ckpt_dir: str, mesh):
    """The verifying loader on the first rank, its verdict on every
    rank: → the ``LoadedCheckpoint`` of the generation the first rank
    chose (each rank reads its params from it), or None when
    ``ckpt_dir`` holds nothing. A failed load (the ladder's ValueError,
    an OSError, anything else) raises on every rank alike, so no rank
    waits in the broadcast."""
    from tpu_p2p_torch.utils import checkpoint as C

    if mesh is None or mesh.size == 1:
        return C.load_latest(ckpt_dir) if C.has_checkpoint(ckpt_dir) \
            else None
    verdict = lc = failed = None
    if mesh.index == 0 and C.has_checkpoint(ckpt_dir):
        try:
            lc = C.load_latest(ckpt_dir)
            verdict = ("ok", lc.path, lc.name, lc.step, lc.skipped)
        except Exception as e:  # noqa: BLE001 — every rank must leave
            # the load together; re-raised below
            kind = ("value" if isinstance(e, ValueError) else
                    "os" if isinstance(e, OSError) else "other")
            verdict, failed = ("error", kind, f"{type(e).__name__}: {e}",
                               str(e)), e
    verdict = _broadcast(mesh, verdict)
    if failed is not None:
        raise failed
    if verdict is None:
        return None
    if verdict[0] == "error":
        _, kind, named, text = verdict
        if kind == "value":
            raise ValueError(text)
        if kind == "os":
            raise OSError(text)
        raise RuntimeError(f"the checkpoint load failed on the first "
                           f"rank: {named}")
    if lc is not None:
        return lc
    _, path, name, step, skipped = verdict
    params, _ = C._load_flat_params(path)
    return C.LoadedCheckpoint(path=path, name=name, step=step,
                              params=params, skipped=skipped)


def run_training(cfg, *, steps: int, lr: float = 1e-2, seed: int = 0,
                 log_every: int = 10, ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 0, ckpt_keep: Optional[int] = None,
                 resume: bool = False, log_path: Optional[str] = None,
                 log_stream=None, optimizer: str = "sgd",
                 weight_decay: float = 0.0, eval_every: int = 0,
                 eval_batches: int = 2, clip_norm: float = 0.0,
                 warmup_steps: int = 0, schedule: str = "constant",
                 fault_plan=None, device="cuda", mesh=None,
                 obs_jsonl: Optional[str] = None,
                 obs_window_step: Optional[int] = None,
                 health_config=None, heal: bool = False,
                 **unported) -> dict:
    """Train the flagship for ``steps`` global steps; returns a summary
    dict (``start_step``, ``steps_run``, ``final_loss``, ``params``: this
    rank's shards, and ``ckpt_resume`` after a resume).

    ``mesh`` (:func:`tpu_p2p_torch.models.flagship.build_mesh`): train
    this rank's shards on ``mesh.device``; every rank of the mesh calls
    this. ``mesh=None``: the whole model on ``device``. Every
    ``log_every`` steps (and at the last) the first rank sends one JSONL
    record to ``log_stream`` and/or appends it to ``log_path``; reading
    its loss waits for the device, so ``wall_s`` is real elapsed time.

    As the reference's loop: ``optimizer="adamw"``, ``clip_norm``,
    ``warmup_steps`` or ``schedule="cosine"`` train through
    :mod:`tpu_p2p_torch.utils.optim` (the schedule's count lives in the
    checkpointed state, so resume stays bit-exact), else the plain SGD
    step. ``eval_every=N`` logs ``eval_loss`` on a held-out batch set
    every N steps. ``ckpt_every=N`` publishes a generation
    (:func:`tpu_p2p_torch.utils.checkpoint.save_generation`: params,
    optimizer state and schedule metadata at once) every N steps and at
    the end, keeping ``ckpt_keep``; ``resume=True`` continues from the
    newest intact generation, refusing a checkpoint of another config or
    optimizer shape in the reference's words. On a mesh the params and
    moments are gathered on every rank, the first rank writes, and the
    save's outcome (a ``SimulatedCrash`` or an ``OSError`` included)
    reaches every rank, so all raise alike. ``fault_plan``: a
    :class:`tpu_p2p_torch.obs.faults.FaultPlan`, injected around the
    loop: the storage faults at the checkpoint writer, the link throttle
    at the model's permutes, the straggler's sleep on rank ``slow_rank``
    inside its step span, and the lost host's missing heartbeats.

    ``obs_jsonl``: the obs layer, as the reference's loop runs it
    (``tpu_p2p/train.py:390-563``). The first rank appends to the file
    (and to ``log_stream``) a ``{"obs": "step"}`` row a step (spans
    ``data``, ``step``, ``eval``, ``checkpoint``; the loop drains the
    card every step), one profiled window at
    :func:`~tpu_p2p_torch.obs.timeline.pick_window_step` (``obs_window_
    step``) as a ``{"obs": "device_window"}`` record joined against the
    run's collective ledger (recorded around the loop; the step's first
    call records), its fractions folded into that step's row, the health
    monitor's verdicts (``health_config``; heartbeats from the plan),
    the ``{"obs": "ckpt"}`` save and load records and a closing
    ``{"obs": "summary"}``. ``heal=True`` (needs ``obs_jsonl``,
    ``ckpt_dir`` and ``ckpt_every``) raises
    :class:`~tpu_p2p_torch.obs.health.HostLostError` on every rank at
    the step the monitor declares a host lost
    (:func:`run_training_with_heal` acts on it).
    """
    import torch

    from tpu_p2p_torch.models import flagship as F
    from tpu_p2p_torch.obs import faults
    from tpu_p2p_torch.utils import checkpoint as C
    from tpu_p2p_torch.utils import optim as O
    from tpu_p2p_torch.utils.data import DeviceLoader
    from tpu_p2p_torch.utils.device import resolve_device

    for name, value in unported.items():
        if name not in _RUN_NOT_PORTED:
            raise TypeError(f"run_training() got an unexpected keyword "
                            f"argument {name!r}")
        if value != _RUN_NOT_PORTED[name]:
            raise NotImplementedError(
                f"run_training({name}={value!r}) is not ported yet")
    if heal and not (obs_jsonl and ckpt_dir and ckpt_every):
        raise ValueError(
            "heal=True needs obs_jsonl (the monitor that detects the "
            "lost host), ckpt_dir, and ckpt_every (the checkpoint the "
            "heal reshards from)"
        )
    if mesh is None:
        device = torch.device(device)
        resolve_device(device.type)  # "cuda" without a card raises
    else:
        device = mesh.device
    first = mesh is None or mesh.index == 0

    start_step = 0
    ckpt_resume = None
    if resume and ckpt_dir:
        # Keys are checked on the host before placing (placing looks
        # each key's spec up). The loader is the VERIFYING one: damaged
        # generations are skipped newest first, each with its reason.
        ckpt_resume = _load_resume(ckpt_dir, mesh)
    if ckpt_resume is not None:
        host, start_step = ckpt_resume.params, ckpt_resume.step
        want_shapes = F.flagship_param_shapes(cfg)
        want_dtype = F.torch_dtype(cfg.params_dtype)
        problems = []
        if set(host) != set(want_shapes):
            problems.append(
                f"keys {sorted(host)} vs expected {sorted(want_shapes)}"
            )
        else:
            for k, v in host.items():
                if tuple(v.shape) != tuple(want_shapes[k]):
                    problems.append(
                        f"{k}: shape {tuple(v.shape)} vs expected "
                        f"{tuple(want_shapes[k])}"
                    )
                elif v.dtype != want_dtype:
                    problems.append(
                        f"{k}: dtype {_dtype_name(v.dtype)} vs expected "
                        f"{_dtype_name(want_dtype)}"
                    )
        if problems:
            raise ValueError(
                f"checkpoint at {ckpt_dir} does not fit this config "
                f"(config/checkpoint mismatch): {'; '.join(problems)}"
            )
        params = (F.place_flagship_params(host, mesh, cfg)
                  if mesh is not None
                  else {k: v.to(device) for k, v in host.items()})
    elif mesh is None:
        params = F.init_flagship_params(cfg, seed=seed, device=device)
    else:
        params = F.place_flagship_params(
            F.init_flagship_params(cfg, seed=seed, device="cpu"), mesh, cfg)

    if optimizer not in ("sgd", "adamw"):
        raise ValueError(f"unknown optimizer {optimizer!r}")
    if schedule not in ("constant", "cosine"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if schedule == "cosine" and warmup_steps >= steps:
        raise ValueError(
            f"schedule='cosine' needs warmup_steps ({warmup_steps}) < "
            f"steps ({steps}) — the decay phase would be empty"
        )
    if eval_every and eval_batches < 1:
        raise ValueError(
            f"eval_every={eval_every} needs eval_batches >= 1, got "
            f"{eval_batches} (an empty eval set would log NaN losses)"
        )
    opt_state = tx = None
    # The hygiene flags route even sgd through the optimizer
    # transformations (the plain step has nowhere to hang them).
    use_optax = (optimizer == "adamw" or clip_norm > 0
                 or warmup_steps > 0 or schedule != "constant")
    # The learning-rate curve the state's count indexes into: saved with
    # the checkpoint and compared at resume (a different --steps would
    # reshape the cosine's decay_steps mid-run).
    sched_meta = {
        "optimizer": optimizer, "schedule": schedule, "lr": lr,
        "warmup_steps": warmup_steps,
        "decay_steps": max(steps, 1) if schedule == "cosine" else None,
        "clip_norm": clip_norm, "weight_decay": weight_decay,
    }
    if use_optax:
        tx = O.make_optimizer(
            optimizer, lr, steps=steps, weight_decay=weight_decay,
            clip_norm=clip_norm, warmup_steps=warmup_steps,
            schedule=schedule, clip_reduce=F.global_norm_reducer(cfg, mesh))
        opt_state = F.init_optimizer(tx, params)
        if start_step and ckpt_resume is not None:
            # The optimizer state lives inside the loaded generation
            # (published atomically with the params).
            ckpt_src = ckpt_resume.path
            if not C.has_opt_state(ckpt_src):
                raise ValueError(
                    f"resuming an optax run from {ckpt_src}, but the "
                    "checkpoint has no optimizer state (saved by the "
                    "plain-sgd path?)"
                )
            saved = C.read_sched_meta(ckpt_src)
            if saved is not None:  # absent in older checkpoints
                diffs = [
                    f"{k}: checkpoint {saved.get(k)!r} vs this run {v!r}"
                    for k, v in sched_meta.items() if saved.get(k) != v
                ]
                if diffs:
                    raise ValueError(
                        f"resume at {ckpt_src} changes the optimizer/"
                        "LR-schedule shape mid-run: "
                        + "; ".join(diffs)
                        + " — pass the original flags (a different "
                        "--steps reshapes cosine decay_steps)"
                    )
            host_state = C.load_opt_state(
                ckpt_src, F.opt_state_template(tx, cfg),
                expect_step=start_step)
            opt_state = F.place_opt_state(host_state, mesh, cfg, device)
        step_fn = F.make_flagship_optax_step(cfg, tx, lm=bool(cfg.vocab),
                                             donate=True, mesh=mesh)
    else:
        if start_step and ckpt_resume is not None and C.has_opt_state(
                ckpt_resume.path):
            # Resuming a hygiene/adamw checkpoint without those flags
            # would drop the schedule count and moments mid-curve.
            raise ValueError(
                f"checkpoint at {ckpt_resume.path} carries optimizer "
                "state, but this run uses the plain-sgd path — pass "
                "the original --optimizer/--clip-norm/--warmup-steps/"
                "--schedule flags (or choose a fresh --ckpt-dir to "
                "discard it)"
            )
        make = (F.make_flagship_lm_train_step if cfg.vocab
                else F.make_flagship_train_step)
        step_fn = make(cfg, lr=lr, donate=True, mesh=mesh)

    spec = F.flagship_data_spec(mesh)
    eval_fn = None
    if eval_every:
        eval_fn = _make_eval_fn(cfg, mesh)
        src = _per_step_batches(cfg, seed + 999_983, 0)
        held = DeviceLoader((next(src) for _ in range(eval_batches)),
                            device, prefetch=eval_batches, mesh=mesh,
                            spec=spec)
        eval_set = list(held)

    loader = DeviceLoader(_per_step_batches(cfg, seed, start_step), device,
                          prefetch=2, mesh=mesh, spec=spec)

    def _emit_to(path, rec):
        if not first:
            return
        line = json.dumps(rec)
        if log_stream is not None:
            print(line, file=log_stream, flush=True)
        if path:
            with open(path, "a") as fh:
                fh.write(line + "\n")

    def emit(rec):
        _emit_to(log_path, rec)

    def emit_obs(rec):
        # Obs records ride the same emit path (the stream included) but
        # land in their own file, so the training log's schema does not
        # grow new shapes.
        _emit_to(obs_jsonl, rec)

    if ckpt_resume is not None and obs_jsonl:
        # The verifying loader's verdict: a clean load is "load", one
        # that skipped damaged generations a "fallback" (an alert).
        emit_obs({"obs": "ckpt",
                  "event": ("fallback" if ckpt_resume.skipped
                            else "load"),
                  "step": int(start_step),
                  "generation": ckpt_resume.name,
                  "skipped": ckpt_resume.skipped,
                  "ok": True})

    def save_ckpt(step_no):
        # ONE atomic generation: params + optimizer state + schedule
        # metadata land together or not at all. Every rank gathers; the
        # first writes and tells the others how it went.
        full = F.gather_flagship_params(params, mesh, cfg) \
            if mesh is not None else params
        full = {k: full[k] for k in params}  # init order: the file's
        state = (F.gather_opt_state(opt_state, mesh, cfg)
                 if opt_state is not None else None)
        outcome = failed = None
        if first:
            try:
                outcome = ("ok", C.save_generation(
                    ckpt_dir, full, step_no, opt_state=state,
                    sched_meta=sched_meta if state is not None else None,
                    keep=ckpt_keep))
            except faults.SimulatedCrash as e:
                outcome, failed = ("crash", os.path.basename(e.path),
                                   e.bytes_written, e.step), e
            except OSError as e:
                outcome, failed = ("oserror", str(e)), e
            except Exception as e:  # noqa: BLE001 — every rank must
                # leave the save together; re-raised below
                outcome, failed = ("error", f"{type(e).__name__}: {e}"), e
        outcome = _broadcast(mesh, outcome)
        if failed is not None:
            raise failed
        if outcome[0] == "crash":
            raise faults.SimulatedCrash(outcome[1], outcome[2],
                                        step=outcome[3])
        if outcome[0] == "oserror":
            raise OSError(outcome[1])
        if outcome[0] == "error":
            raise RuntimeError(f"the checkpoint save failed on the first "
                               f"rank: {outcome[1]}")
        return outcome[1]

    def save_and_record(step_no):
        t0s = time.monotonic()
        stats = save_ckpt(step_no)
        if obs_jsonl:
            emit_obs({"obs": "ckpt", "event": "save",
                      "step": int(step_no),
                      "generation": stats["name"],
                      "save_ms": round((time.monotonic() - t0s) * 1e3, 3),
                      "bytes": stats["bytes"],
                      "write_retries": stats["write_retries"],
                      "ok": True})
        return stats

    import contextlib

    tl = led = monitor = None
    obs_trace_step = None
    n_hosts = mesh.size if mesh is not None else 1
    if obs_jsonl:
        from tpu_p2p_torch.obs import ledger as obs_ledger
        from tpu_p2p_torch.obs.health import HealthMonitor, HostLostError
        from tpu_p2p_torch.obs.timeline import (
            StepTimeline,
            device_window_record,
            pick_window_step,
        )
        from tpu_p2p_torch.utils.profiling import profile_window

        tl = StepTimeline(emit_obs)
        led = obs_ledger.CollectiveLedger()
        # The always-on health half of the obs layer: straggler scoring
        # on every step row and heartbeat-based lost-host tracking.
        monitor = HealthMonitor(health_config, emit=emit_obs,
                                n_hosts=n_hosts)
        # One profiled window a run, by default the second step (the
        # first builds the kernels).
        obs_trace_step = pick_window_step(start_step, steps,
                                          obs_window_step)

    def _span(name):
        return (tl.span(name) if tl is not None
                else contextlib.nullcontext())

    def _drain():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def run_step(x, t):
        nonlocal params, opt_state
        if opt_state is not None:
            params, opt_state, loss = step_fn(params, opt_state, x, t)
        else:
            params, loss = step_fn(params, x, t)
        return loss

    # Only rank ``slow_rank`` sleeps, at the start of the step span and
    # before the step's collectives, so its peers wait for it in the same
    # step (a world of one sleeps itself), as the reference's one
    # controller sees a slow step.
    slow_here = (fault_plan is not None and fault_plan.slow_rank is not None
                 and (mesh is None or mesh.index == fault_plan.slow_rank))
    t0 = time.monotonic()
    tokens_per_step = cfg.batch * cfg.seq
    loss = None
    saved_at = start_step - 1
    with contextlib.ExitStack() as stack:
        if led is not None:
            # Recording wraps the loop: the step's first call records
            # its collectives, as the reference's first trace does.
            stack.enter_context(obs_ledger.recording(led))
        if fault_plan is not None:
            stack.enter_context(faults.injecting(fault_plan))
        for step in range(start_step, steps):
            with _span("data"):
                x, t = next(loader)
            dev_rec = None
            with _span("step"):
                if slow_here:
                    faults.maybe_slow_host(fault_plan, step + 1)
                if tl is not None and step == obs_trace_step:
                    import tempfile

                    with tempfile.TemporaryDirectory(
                            prefix="obs_step_") as td:
                        box = {}
                        path = profile_window(
                            lambda: box.setdefault("loss", run_step(x, t)),
                            td)
                        loss = box["loss"]
                        dev_rec = device_window_record(
                            path, step=step + 1, ledger=led)
                else:
                    loss = run_step(x, t)
                if tl is not None:
                    # Obs mode drains every step: step_ms is the step's
                    # real cadence, not its issue time.
                    _drain()
            if log_every and ((step + 1) % log_every == 0
                              or step + 1 == steps):
                loss_f = float(loss)  # waits for the device on log steps
                dt = time.monotonic() - t0
                emit({
                    "step": step + 1,
                    "loss": round(loss_f, 6),
                    "wall_s": round(dt, 3),
                    "tokens_per_s_wall": round(
                        (step + 1 - start_step) * tokens_per_step / dt),
                })
            if eval_every and eval_fn and (step + 1) % eval_every == 0:
                with _span("eval"):
                    ev = float(np.mean([float(eval_fn(params, xe, te))
                                        for xe, te in eval_set]))
                emit({"step": step + 1, "eval_loss": round(ev, 6)})
            if ckpt_every and ckpt_dir and (step + 1) % ckpt_every == 0:
                with _span("checkpoint"):
                    save_and_record(step + 1)
                saved_at = step + 1
            if tl is not None:
                extra = {}
                if dev_rec is not None:
                    extra = {k: dev_rec[k] for k in
                             ("device_busy_frac", "gather_overlap_frac",
                              "tp_overlap_frac")}
                step_rec = tl.end_step(step + 1, extra=extra)
                if dev_rec is not None:
                    emit_obs(dev_rec)
                alive = None
                if fault_plan is not None:
                    alive = [h for h in range(n_hosts)
                             if not faults.host_lost(fault_plan, h,
                                                     step + 1)]
                for v in monitor.observe_step(
                        step + 1, step_rec["step_ms"], alive_hosts=alive,
                        # The first step and the profiled step are
                        # instrumentation, not fleet health.
                        score_straggler=(step not in
                                         (start_step, obs_trace_step))):
                    if heal and v.kind == "lost_host":
                        raise HostLostError(v.detail["host"], step + 1)
    ran = max(0, steps - start_step)
    if ran and ckpt_dir and saved_at != steps:  # the rolling save may
        # have written this state already
        save_and_record(steps)
    out = {
        "start_step": start_step,
        "steps_run": ran,
        "final_loss": round(float(loss), 6) if loss is not None else None,
        "params": params,
    }
    if ckpt_resume is not None:
        out["ckpt_resume"] = {"generation": ckpt_resume.name,
                              "step": ckpt_resume.step,
                              "skipped": ckpt_resume.skipped}
    if tl is not None:
        summary = tl.summary_record()
        emit_obs(summary)
        out["obs_step_ms_p50"] = summary["obs_step_ms_p50"]
        out["obs_step_ms_p99"] = summary["obs_step_ms_p99"]
        out["obs_ledger_issues"] = len(led)
        out["health_verdicts"] = len(monitor.verdicts)
    return out


def run_training_with_heal(cfg, *, steps: int, fault_plan=None,
                           resume: bool = False, mesh=None, **kw) -> dict:
    """:func:`run_training` under the self-healing resume protocol (the
    reference's ``run_training_with_heal``, ``train --heal``).

    Runs normally until the health monitor declares a host lost
    (:class:`~tpu_p2p_torch.obs.health.HostLostError`, raised on every
    rank at one step), then: drops the lost rank, lays a mesh over the
    first ``m`` survivors, ``m`` the largest power of two
    (:meth:`~tpu_p2p_torch.parallel.runtime.Runtime.restrict`, groups
    made among them alone), reshards the newest intact generation onto
    it and resumes to ``steps``; the per-step batch stream makes the
    healed run consume the batches an uninterrupted one would. The ranks
    outside the new mesh (the lost one, and any past ``m``) return at
    once and wait for the others wherever their caller meets the world.
    Needs ``ckpt_dir``, ``ckpt_every`` and ``obs_jsonl`` in ``kw``. The
    summary carries ``heal`` (``lost_host``, ``detected_step``,
    ``resume_step``, ``devices``; None for an uninterrupted run) and
    ``mesh``, the mesh the run ended on (None on a rank outside it)."""
    from tpu_p2p_torch.models import flagship as F
    from tpu_p2p_torch.obs.health import HostLostError
    from tpu_p2p_torch.utils import checkpoint as C

    kw = dict(kw)
    kw.pop("heal", None)  # the wrapper owns this knob
    kw.pop("resume", None)
    try:
        out = run_training(cfg, steps=steps, resume=resume,
                           fault_plan=fault_plan, heal=True, mesh=mesh,
                           **kw)
        out["heal"] = None
        out["mesh"] = mesh
        return out
    except HostLostError as e:
        ckpt_dir = kw.get("ckpt_dir")
        first = mesh is None or mesh.index == 0
        resume_step = _broadcast(mesh, C.latest_intact_step(ckpt_dir)
                                 if first and C.has_checkpoint(ckpt_dir)
                                 else None)
        if resume_step is None:
            raise RuntimeError(
                f"host {e.host} lost at step {e.step}, but no intact "
                f"checkpoint exists under {ckpt_dir!r} to heal from "
                "(ckpt_every never fired?)") from e
        survivors = [r for i, r in enumerate(
            mesh.ranks if mesh is not None else (0,)) if i != e.host]
        m = 1
        while m * 2 <= len(survivors):
            m *= 2
        heal_rec = {"obs": "heal", "lost_host": e.host,
                    "detected_step": e.step,
                    "resume_step": resume_step, "devices": m}
        obs_jsonl = kw.get("obs_jsonl")
        if obs_jsonl and first:
            with open(obs_jsonl, "a") as fh:
                fh.write(json.dumps(heal_rec) + "\n")
        heal = {k: v for k, v in heal_rec.items() if k != "obs"}
        members = survivors[:m]
        if mesh is None or mesh.rank not in members:
            return {"start_step": resume_step, "steps_run": 0,
                    "final_loss": None, "params": None, "heal": heal,
                    "mesh": None}
        new_mesh = F.build_mesh(m, runtime=mesh.runtime.restrict(members))
        # The resumed half runs fault-free: the lost rank is gone from
        # the mesh, and its plan must not trigger again.
        out = run_training(cfg, steps=steps, resume=True, mesh=new_mesh,
                           **kw)
        out["heal"] = heal
        out["mesh"] = new_mesh
        return out


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def run_training_supervised(cfg, *, steps: int, fault_plan=None,
                            resume: bool = False, max_restarts: int = 3,
                            mesh=None, **kw) -> dict:
    """:func:`run_training` under the crash-resilient supervisor (the
    reference's ``run_training_supervised``): a ``SimulatedCrash`` mid
    checkpoint write is caught, and the loop re-enters from the newest
    INTACT generation through the verifying loader; the per-step batch
    stream replays the lost steps exactly, so the run ends where an
    uninterrupted one would. Needs ``ckpt_dir`` and ``ckpt_every``; at
    most ``max_restarts`` re-entries. The summary gains ``supervisor``
    (``restarts`` and each crash's ``step``, ``resume_step``,
    ``lost_steps``); each transition prints a ``# supervise:`` line on
    ``log_stream`` (the first rank's). On a mesh every rank re-enters
    together: the crash reaches every rank from the save."""
    from tpu_p2p_torch.obs import faults
    from tpu_p2p_torch.utils import checkpoint as C

    ckpt_dir = kw.get("ckpt_dir")
    if not (ckpt_dir and kw.get("ckpt_every")):
        raise ValueError(
            "supervised training needs ckpt_dir and ckpt_every — "
            "without a generation to re-enter from, a crash is total "
            "loss"
        )
    if max_restarts < 1:
        raise ValueError(f"max_restarts must be >= 1, got "
                         f"{max_restarts}")
    log_stream = kw.get("log_stream")
    obs_jsonl = kw.get("obs_jsonl")
    first = mesh is None or mesh.index == 0

    def note(msg):
        if log_stream is not None and first:
            print(msg, file=log_stream, flush=True)

    def emit_obs(rec):
        if obs_jsonl and first:
            with open(obs_jsonl, "a") as fh:
                fh.write(json.dumps(rec) + "\n")

    restarts = 0
    crashes = []
    while True:
        try:
            out = run_training(cfg, steps=steps,
                               resume=resume or restarts > 0,
                               fault_plan=fault_plan, mesh=mesh, **kw)
            out["supervisor"] = {"restarts": restarts,
                                 "crashes": crashes}
            if restarts:
                note(f"# supervise: completed at step {steps} after "
                     f"{restarts} restart(s)")
            return out
        except faults.SimulatedCrash as e:
            restarts += 1
            crash_step = e.step
            intact = _broadcast(mesh, C.latest_intact_step(ckpt_dir)
                                if first else None)
            resume_step = intact if intact is not None else 0
            lost = (crash_step - resume_step
                    if crash_step is not None else None)
            crashes.append({"step": crash_step,
                            "resume_step": resume_step,
                            "lost_steps": lost})
            # The file's basename and the byte count only: the temp
            # dir's path would not reproduce.
            note(f"# supervise: crashed mid-checkpoint at step "
                 f"{crash_step} (simulated process death after "
                 f"{e.bytes_written} bytes into "
                 f"{os.path.basename(e.path)})")
            if intact is not None:
                note(f"# supervise: resuming from gen-{intact:06d} "
                     f"(step {resume_step}, {lost} step(s) to re-run)")
            else:
                note("# supervise: no intact generation — restarting "
                     f"from step 0 ({lost} step(s) to re-run)")
            emit_obs({"obs": "ckpt", "event": "crash_restart",
                      "step": crash_step, "resume_step": resume_step,
                      "restarts": restarts, "ok": False})
            if restarts > max_restarts:
                note(f"# supervise: restart budget ({max_restarts}) "
                     "exhausted — giving up")
                raise


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_p2p_torch train",
        description="Train the flagship model (synthetic data) on the "
                    "five-axis mesh of the world with checkpoint/resume "
                    "and JSONL logging.",
    )
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--log-jsonl", default=None, metavar="PATH")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="device to train on (default cuda, a card a rank; "
                        "raises without a card)")
    p.add_argument("--obs-jsonl", default=None, metavar="PATH",
                   help="observability JSONL: span-timed step rows, one "
                        "profiled window joined against the collective "
                        "ledger, health verdicts, checkpoint records and "
                        "an obs_step_ms_p50 summary; drains the card every "
                        "step")
    p.add_argument("--obs-window-step", type=int, default=None,
                   metavar="K",
                   help="which step gets the one torch.profiler window "
                        "(default: the second executed step; clamped "
                        "into the executed range)")
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="after the run, export the --obs-jsonl records as "
                        "a Chrome-trace/Perfetto JSON timeline (requires "
                        "--obs-jsonl)")
    p.add_argument("--ckpt-dir", default=None, metavar="DIR")
    p.add_argument("--ckpt-every", type=int, default=0, metavar="N")
    p.add_argument("--ckpt-keep", type=int, default=CKPT_KEEP, metavar="K",
                   help="checkpoint generations retained after each "
                        "atomic publish")
    p.add_argument("--resume", action="store_true",
                   help="continue from the newest INTACT checkpoint "
                        "generation in --ckpt-dir (the verifying loader "
                        "falls back past damaged ones)")
    p.add_argument("--supervise", action="store_true",
                   help="crash-resilient supervisor: a (simulated) process "
                        "death mid-checkpoint re-enters from the newest "
                        "intact generation and replays the lost steps "
                        "(requires --ckpt-dir and --ckpt-every)")
    p.add_argument("--max-restarts", type=int, default=3, metavar="N",
                   help="--supervise: crash re-entries before giving up")
    p.add_argument("--optimizer", default="sgd", choices=("sgd", "adamw"))
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--clip-norm", type=float, default=0.0,
                   help="global-norm gradient clipping (0 = off)")
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--schedule", default="constant",
                   choices=("constant", "cosine"))
    p.add_argument("--eval-every", type=int, default=0, metavar="N")
    p.add_argument("--eval-batches", type=int, default=2, metavar="K")
    p.add_argument("--cpu-mesh", type=int, default=None, metavar="N",
                   help="spawn N CPU ranks (gloo) and train on "
                        "build_mesh(N)")
    p.add_argument("--mesh-shape", default=None, metavar="DPxPPxSPxTPxEP",
                   help="the mesh's dims (default: build_mesh's factoring "
                        "of the world)")
    p.add_argument("--heal", action="store_true",
                   help="on a lost-host health verdict, reshard the newest "
                        "intact checkpoint onto the largest power-of-two "
                        "set of surviving ranks and resume (requires "
                        "--obs-jsonl, --ckpt-dir and --ckpt-every)")
    p.add_argument("--fault-degrade-edge", default=None, metavar="S:D",
                   help="inject: throttle the directed link S->D")
    p.add_argument("--fault-degrade-factor", type=int, default=8,
                   metavar="K", help="trips per ship on the degraded edge "
                                     "(>= 2)")
    p.add_argument("--fault-slow-rank", type=int, default=None, metavar="R",
                   help="inject: delay rank R's step")
    p.add_argument("--fault-slow-ms", type=float, default=100.0,
                   metavar="MS", help="injected per-step delay")
    p.add_argument("--fault-lost-host", type=int, default=None, metavar="H",
                   help="inject: host H stops heartbeating")
    p.add_argument("--fault-at-step", type=int, default=0, metavar="K",
                   help="first step the slow/lost/checkpoint faults apply "
                        "to")
    # Storage faults, applied only by the checkpoint writer.
    p.add_argument("--fault-ckpt-crash-bytes", type=int, default=None,
                   metavar="B",
                   help="inject: simulated process death after B bytes of "
                        "the first checkpoint save at/past --fault-at-step "
                        "(pair with --supervise)")
    p.add_argument("--fault-ckpt-corrupt-seed", type=int, default=None,
                   metavar="S",
                   help="inject: seeded one-bit flip in each generation "
                        "published at/past --fault-at-step")
    p.add_argument("--fault-ckpt-io-errors", type=int, default=0,
                   metavar="N",
                   help="inject: first N checkpoint write attempts fail "
                        "transiently (absorbed by the bounded retry)")
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
                   help="tp joins as ring collective-matmuls over token "
                        "chunks (a no-op at tp 1)")
    p.add_argument("--ep-overlap", default="none", choices=("none", "ring"),
                   help="MoE reshards as shift hops beside the expert "
                        "products (a no-op at ep 1)")
    p.add_argument("--pp-overlap", default="none", choices=("none", "wave"),
                   help="the stage hop as a wave of token chunks (a no-op "
                        "at pp 1)")
    p.add_argument("--pp-chunks", type=int, default=4,
                   help="chunks of a --pp-overlap wave hop")
    p.add_argument("--pp-schedule", default="1f1b", choices=PP_SCHEDULES,
                   help="pipeline tick schedule (zb = the zero-bubble "
                        "dB/dW split, tick-IR executor only: the training "
                        "loop runs GPipe autograd and refuses it, as the "
                        "reference does, pointing at "
                        "make_flagship_train_step_1f1b / the "
                        "flagship_step workload)")
    p.add_argument("--tick-lowering", default="masked",
                   choices=TICK_LOWERINGS,
                   help="tick lowering of compiled pipeline programs "
                        "(switch = per-rank dispatch, tick-IR executor "
                        "only: refused by the training loop like "
                        "--pp-schedule zb)")
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
        tp_overlap=args.tp_overlap, ep_overlap=args.ep_overlap,
        pp_overlap=args.pp_overlap, pp_chunks=args.pp_chunks,
        pp_schedule=args.pp_schedule, tick_lowering=args.tick_lowering,
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


def fault_plan_from_args(args: argparse.Namespace):
    """The :class:`~tpu_p2p_torch.obs.faults.FaultPlan` the ``--fault-*``
    flags describe, or None."""
    if not (args.fault_degrade_edge or args.fault_slow_rank is not None
            or args.fault_lost_host is not None
            or args.fault_ckpt_crash_bytes is not None
            or args.fault_ckpt_corrupt_seed is not None
            or args.fault_ckpt_io_errors):
        return None
    from tpu_p2p_torch.config import parse_edge
    from tpu_p2p_torch.obs.faults import FaultPlan

    return FaultPlan(
        degrade_edge=(parse_edge(args.fault_degrade_edge)
                      if args.fault_degrade_edge else None),
        degrade_factor=args.fault_degrade_factor,
        slow_rank=args.fault_slow_rank, slow_ms=args.fault_slow_ms,
        lost_host=args.fault_lost_host,
        ckpt_crash_after_bytes=args.fault_ckpt_crash_bytes,
        ckpt_corrupt_seed=args.fault_ckpt_corrupt_seed,
        ckpt_io_errors=args.fault_ckpt_io_errors,
        start_step=args.fault_at_step)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _build_parser().parse_args(argv)
    if args.trace and not args.obs_jsonl:
        raise SystemExit("--trace exports the observability records; "
                         "it requires --obs-jsonl")
    if args.supervise and args.heal:
        raise SystemExit(
            "--supervise and --heal are separate recovery wrappers; "
            "pick one (the supervisor covers storage crashes, heal "
            "covers lost hosts)")
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
        common = dict(
            steps=args.steps, lr=args.lr, seed=args.seed,
            log_every=args.log_every, ckpt_dir=args.ckpt_dir,
            ckpt_every=args.ckpt_every, ckpt_keep=args.ckpt_keep,
            log_path=args.log_jsonl, log_stream=sys.stdout,
            optimizer=args.optimizer, weight_decay=args.weight_decay,
            eval_every=args.eval_every, eval_batches=args.eval_batches,
            clip_norm=args.clip_norm, warmup_steps=args.warmup_steps,
            schedule=args.schedule, fault_plan=fault_plan_from_args(args),
            obs_jsonl=args.obs_jsonl, obs_window_step=args.obs_window_step,
            mesh=rt.mesh)
        if args.supervise:
            summary = run_training_supervised(
                cfg, resume=args.resume, max_restarts=args.max_restarts,
                **common)
        elif args.heal:
            summary = run_training_with_heal(cfg, resume=args.resume,
                                             **common)
        else:
            summary = run_training(cfg, resume=args.resume, **common)
        # The summary is the first rank's of the mesh the run ended on
        # (after a heal, the survivors' mesh).
        final = summary.pop("mesh", rt.mesh)
        printer = final is not None and final.index == 0
        report = _card_report(rt)
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
    if printer:
        if report:
            print(report, file=sys.stderr)
        if args.trace:
            from tpu_p2p_torch.obs.trace import (
                load_obs_records,
                write_chrome_trace,
            )

            obj = write_chrome_trace(
                args.trace, obs_records=load_obs_records(args.obs_jsonl),
                meta={"source": "train", "obs_jsonl": args.obs_jsonl})
            print(f"# wrote chrome trace {args.trace} "
                  f"({len(obj['traceEvents'])} events)")
        print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
