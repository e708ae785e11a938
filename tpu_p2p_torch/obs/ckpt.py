"""Checkpoint-durability chaos smoke — the port of
``tpu_p2p/obs/ckpt.py`` (``python -m tpu_p2p_torch obs ckpt-smoke``).

Three injected IO-fault scenarios, each deterministic (the storage
shapes of :mod:`tpu_p2p_torch.obs.faults`, applied only by the
interposed writer of :mod:`tpu_p2p_torch.utils.checkpoint`), each graded
against an uninterrupted twin run of the training loop:

1. **crash_mid_write** — ``ckpt_crash_after_bytes`` kills the save at a
   mid-run generation; the supervisor
   (:func:`~tpu_p2p_torch.train.run_training_supervised`) must re-enter
   from the newest intact generation — whose params must be BITWISE the
   twin's save of that step — and complete with at most ``ckpt_every``
   steps of lost progress, every published generation verifying (a
   crash leaves no partially written generation) and the final loss
   within ``max_loss_rel`` of the twin's.
2. **corrupt_latest** — ``ckpt_corrupt_seed`` rots the newest published
   generation; a later ``resume`` must fall back to the one before
   (bitwise the twin's same-step save, the skip reason on the resume
   receipt), replay the lost steps, and land on the twin's trajectory.
3. **transient_io** — ``ckpt_io_errors`` fails the first N write
   attempts; the bounded retry (:func:`tpu_p2p_torch.utils.retry.
   retry_io`) must absorb them with ZERO fallbacks — every generation
   intact AND bitwise the twin's, the retries visible in the save
   records.

The resumed-from generations are compared BITWISE: the same seed gives
the same batches, hence the same params at every save before a fault.
The post-resume final state is graded as final-loss parity, with the
per-generation bitwise map reported beside it.

Two gate numbers: ``ckpt_recover_steps`` (the worst crash/corruption →
resumed-and-training span; it equals ``ckpt_every`` unless the recovery
ladder regresses) and ``ckpt_save_ms_p50`` (the median generation-publish
wall time off the twin run's ``{"obs": "ckpt"}`` save records).

The world: a world of one on its card by default (``--device`` another
device), a world of processes under ``torchrun`` or ``--cpu-mesh N``
(the five-axis mesh over it, every rank in every run; the first rank
writes, reads and grades).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
from typing import Dict, List, Optional, Sequence

__all__ = ["run_ckpt_smoke", "ckpt_smoke_main"]


def _ckpt_records(path: str) -> List[dict]:
    recs = []
    if not os.path.exists(path):
        return recs
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
            except json.JSONDecodeError:
                continue
            if d.get("obs") == "ckpt":
                recs.append(d)
    return recs


def _gen_params(path: str):
    """Host tensors of one generation (no placement)."""
    from tpu_p2p_torch.utils import checkpoint as C

    return C._load_flat_params(path)[0]


def _bitwise(a, b) -> bool:
    """Equal dtype, shape and bytes."""
    import torch

    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().reshape(-1).view(torch.uint8),
                            b.contiguous().reshape(-1).view(torch.uint8)))


def _params_bitwise(pa, pb) -> bool:
    return set(pa) == set(pb) and all(_bitwise(pa[k], pb[k]) for k in pa)


def _gens_bitwise(dir_a: str, dir_b: str) -> Dict[str, bool]:
    """Per-generation bitwise params comparison between two checkpoint
    dirs (generations present in both)."""
    from tpu_p2p_torch.utils import checkpoint as C

    a = {name for _step, name in C.list_generations(dir_a)}
    b = {name for _step, name in C.list_generations(dir_b)}
    return {name: _params_bitwise(_gen_params(os.path.join(dir_a, name)),
                                  _gen_params(os.path.join(dir_b, name)))
            for name in sorted(a & b)}


def _verify_all(path: str) -> Dict[str, Optional[str]]:
    from tpu_p2p_torch.utils import checkpoint as C

    return {name: C.verify_generation(os.path.join(path, name))
            for _s, name in C.list_generations(path)}


def _gen_bitwise(dir_a: str, dir_b: str, name: Optional[str]) -> bool:
    """Bitwise params comparison of ONE generation across two dirs."""
    if not name:
        return False
    return _params_bitwise(_gen_params(os.path.join(dir_a, name)),
                           _gen_params(os.path.join(dir_b, name)))


def _loss_rel(a: Optional[float], b: Optional[float]) -> Optional[float]:
    if a is None or b is None:
        return None
    return abs(a - b) / max(abs(b), 1e-12)


def run_ckpt_smoke(*, steps: int = 9, ckpt_every: int = 3,
                   max_loss_rel: float = 0.05, out=None, rt=None,
                   device="cuda") -> Optional[dict]:
    """Run the three storage-fault scenarios (module docstring) and grade
    them against an uninterrupted twin → on the first rank a result dict
    with per-scenario details, ``ckpt_recover_steps`` /
    ``ckpt_save_ms_p50`` and ``ok``; None on the others.

    ``rt``: a runtime whose world trains on the five-axis mesh over it
    (every rank calls this); None: a world of one on ``device``."""
    import shutil
    import tempfile

    from tpu_p2p_torch.models import flagship as F
    from tpu_p2p_torch.obs import faults
    from tpu_p2p_torch.obs.health import _smoke_cfg
    from tpu_p2p_torch.train import run_training, run_training_supervised
    from tpu_p2p_torch.utils import checkpoint as C

    log = out if out is not None else sys.stderr
    if steps < 3 * ckpt_every:
        raise ValueError(
            f"the smoke needs >= 3 save points (steps {steps} vs "
            f"ckpt_every {ckpt_every}) — the retention ladder is what "
            "it grades")
    mesh = None
    n, first = 1, True
    if rt is not None:
        n, first = rt.world, rt.rank == 0
        mesh = F.build_mesh(n, runtime=rt)
    cfg = _smoke_cfg()
    kw = dict(lr=1e-2, log_every=0, ckpt_every=ckpt_every, mesh=mesh,
              device=device)

    def say(msg: str) -> None:
        if first:
            print(msg, file=log, flush=True)

    results: dict = {"devices": n, "steps": steps,
                     "ckpt_every": ckpt_every}
    oks: List[bool] = []
    recover: List[int] = []
    td = tempfile.mkdtemp(prefix="ckpt_smoke_") if first else None
    if rt is not None:
        td = rt.broadcast(td, 0)
    try:
        # Uninterrupted twin: same seed ⇒ same per-step batches ⇒ same
        # params at every save point — the bitwise oracle every scenario
        # compares against. Its obs stream gives the save latencies.
        ref_ck = os.path.join(td, "ref")
        ref_obs = os.path.join(td, "ref_obs.jsonl")
        ref = run_training(cfg, steps=steps, ckpt_dir=ref_ck,
                           obs_jsonl=ref_obs, **kw)
        save_ms = sorted(r["save_ms"] for r in _ckpt_records(ref_obs)
                         if r.get("event") == "save")
        p50 = (round(float(statistics.median(save_ms)), 3)
               if save_ms else None)

        # ---- 1) crash mid-write → supervisor re-entry.
        crash_at = 2 * ckpt_every
        ck1 = os.path.join(td, "crash")
        obs1 = os.path.join(td, "crash_obs.jsonl")
        plan = faults.FaultPlan(ckpt_crash_after_bytes=512,
                                start_step=crash_at)
        sup = run_training_supervised(
            cfg, steps=steps, ckpt_dir=ck1, obs_jsonl=obs1,
            fault_plan=plan, **kw)
        if first:
            verify1 = _verify_all(ck1)
            bits1 = _gens_bitwise(ck1, ref_ck)
            crashes = sup["supervisor"]["crashes"]
            rec1 = crashes[0]["lost_steps"] if crashes else None
            latest1 = C.read_latest_pointer(ck1)
            resumed_from1 = (C._gen_name(crashes[0]["resume_step"])
                             if crashes else None)
            from_bits1 = _gen_bitwise(ck1, ref_ck, resumed_from1)
            loss_rel1 = _loss_rel(sup.get("final_loss"),
                                  ref.get("final_loss"))
            ok1 = (sup["supervisor"]["restarts"] == 1
                   and bool(crashes)
                   and crashes[0]["step"] == crash_at
                   and crashes[0]["resume_step"] == crash_at - ckpt_every
                   and rec1 is not None and rec1 <= ckpt_every
                   and all(v is None for v in verify1.values())
                   and from_bits1
                   and loss_rel1 is not None
                   and loss_rel1 <= max_loss_rel
                   and latest1 is not None
                   and verify1.get(latest1) is None)
            results["crash_mid_write"] = {
                "plan": plan.describe(),
                "restarts": sup["supervisor"]["restarts"],
                "crashes": crashes, "recover_steps": rec1,
                "resumed_from": resumed_from1,
                "resumed_from_bitwise": from_bits1,
                "final_loss_rel": loss_rel1,
                "generations_verify": verify1,
                "generations_bitwise_vs_ref": bits1,
                "latest": latest1, "ok": ok1,
            }
            oks.append(ok1)
            if rec1 is not None:
                recover.append(rec1)
            say(f"# ckpt crash_mid_write: restarts="
                f"{sup['supervisor']['restarts']} crash_step="
                f"{crashes[0]['step'] if crashes else None} "
                f"resumed_from={resumed_from1} "
                f"bitwise={from_bits1} "
                f"gens_intact={all(v is None for v in verify1.values())}"
                f" loss_rel={loss_rel1}")

        # ---- 2) corrupt-latest → verifying-loader fallback.
        ck2 = os.path.join(td, "rot")
        obs2 = os.path.join(td, "rot_obs.jsonl")
        plan = faults.FaultPlan(ckpt_corrupt_seed=1, start_step=steps)
        run_training(cfg, steps=steps, ckpt_dir=ck2, fault_plan=plan,
                     **kw)
        newest = C._gen_name(steps)
        rotted = (C.verify_generation(os.path.join(ck2, newest))
                  if first else None)
        resumed = run_training(cfg, steps=steps, ckpt_dir=ck2,
                               obs_jsonl=obs2, resume=True, **kw)
        if first:
            receipt = resumed.get("ckpt_resume") or {}
            skipped = receipt.get("skipped") or []
            rec2 = (steps - resumed["start_step"]
                    if resumed["start_step"] else None)
            verify2 = _verify_all(ck2)
            bits2 = _gens_bitwise(ck2, ref_ck)
            from_bits2 = _gen_bitwise(ck2, ref_ck,
                                      receipt.get("generation"))
            loss_rel2 = _loss_rel(resumed.get("final_loss"),
                                  ref.get("final_loss"))
            ok2 = (rotted is not None  # the rot landed…
                   and len(skipped) == 1  # …the ladder skipped just it
                   and skipped[0]["generation"] == newest
                   and "checksum" in skipped[0]["reason"]
                   and resumed["start_step"] == steps - ckpt_every
                   and rec2 is not None and rec2 <= ckpt_every
                   and resumed["steps_run"] == ckpt_every
                   and all(v is None for v in verify2.values())
                   and from_bits2
                   and loss_rel2 is not None
                   and loss_rel2 <= max_loss_rel)
            results["corrupt_latest"] = {
                "plan": plan.describe(), "rot_reason": rotted,
                "resume_receipt": receipt, "recover_steps": rec2,
                "resumed_from": receipt.get("generation"),
                "resumed_from_bitwise": from_bits2,
                "final_loss_rel": loss_rel2,
                "generations_verify": verify2,
                "generations_bitwise_vs_ref": bits2, "ok": ok2,
            }
            oks.append(ok2)
            if rec2 is not None:
                recover.append(rec2)
            say(f"# ckpt corrupt_latest: rot={rotted!r} skipped="
                f"{[s['generation'] for s in skipped]} resumed_from="
                f"{receipt.get('generation')} bitwise={from_bits2} "
                f"loss_rel={loss_rel2}")

        # ---- 3) transient IO → retry absorbs, zero fallbacks.
        ck3 = os.path.join(td, "tio")
        obs3 = os.path.join(td, "tio_obs.jsonl")
        plan = faults.FaultPlan(ckpt_io_errors=3)
        run_training(cfg, steps=steps, ckpt_dir=ck3, obs_jsonl=obs3,
                     fault_plan=plan, **kw)
        if first:
            retries = sum(r.get("write_retries", 0)
                          for r in _ckpt_records(obs3)
                          if r.get("event") == "save")
            verify3 = _verify_all(ck3)
            bits3 = _gens_bitwise(ck3, ref_ck)
            fallbacks = C.load_latest(ck3).skipped
            ok3 = (retries == plan.ckpt_io_errors
                   and all(v is None for v in verify3.values())
                   and not fallbacks
                   and bits3 and all(bits3.values()))
            results["transient_io"] = {
                "plan": plan.describe(), "write_retries": retries,
                "fallbacks": fallbacks, "generations_verify": verify3,
                "generations_bitwise_vs_ref": bits3, "ok": ok3,
            }
            oks.append(ok3)
            say(f"# ckpt transient_io: retries={retries} "
                f"fallbacks={len(fallbacks)} "
                f"gens_intact={all(v is None for v in verify3.values())}")
    finally:
        if rt is not None:
            rt.barrier()
        if first:
            shutil.rmtree(td, ignore_errors=True)
    if not first:
        return None
    results["ckpt_recover_steps"] = (max(recover)
                                     if len(recover) == 2 else None)
    results["ckpt_save_ms_p50"] = p50
    results["ok"] = all(oks) and results["ckpt_recover_steps"] is not None
    return results


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_p2p_torch obs ckpt-smoke",
        description="Injected-IO-fault checkpoint-durability smoke: "
                    "crash mid-write → supervisor re-entry, "
                    "corrupt-latest → verifying-loader fallback, "
                    "transient IO → bounded retry, each graded bitwise "
                    "against an uninterrupted twin; nonzero exit unless "
                    "all three scenarios grade.",
    )
    p.add_argument("--steps", type=int, default=9,
                   help="training steps per scenario run")
    p.add_argument("--ckpt-every", type=int, default=3,
                   help="save cadence (also the max graded lost "
                        "progress)")
    p.add_argument("--cpu-mesh", type=int, default=None, metavar="N",
                   help="spawn N CPU ranks (gloo)")
    p.add_argument("--device", default=None,
                   help="the device (default: the rank's card)")
    return p


def ckpt_smoke_main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m tpu_p2p_torch obs ckpt-smoke``: the first rank prints
    the scenario lines and one JSON line; every rank exits with the
    verdict."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _build_parser().parse_args(argv)
    if args.cpu_mesh and "RANK" not in os.environ:
        from tpu_p2p_torch.parallel.launch import spawn

        return max(spawn(args.cpu_mesh, ["-m", "tpu_p2p_torch", "obs",
                                         "ckpt-smoke", *argv]))
    from tpu_p2p_torch.utils.errors import fail_fast

    try:
        from tpu_p2p_torch.parallel.runtime import make_runtime, pick_device

        rt = None
        if args.cpu_mesh or "RANK" in os.environ:
            rt = make_runtime(device="cpu" if args.cpu_mesh
                              else args.device)
            device = rt.device
        else:
            device = pick_device(args.device)
        res = run_ckpt_smoke(steps=args.steps, ckpt_every=args.ckpt_every,
                             out=sys.stdout, rt=rt, device=device)
        ok = False
        if res is not None:
            ok = bool(res["ok"])
            print(json.dumps({
                "ckpt_recover_steps": res["ckpt_recover_steps"],
                "ckpt_save_ms_p50": res["ckpt_save_ms_p50"],
                "ok": ok,
            }), flush=True)
        if rt is not None:
            ok = rt.broadcast(ok, 0)
            rt.close()
        return 0 if ok else 1
    except KeyboardInterrupt:
        print("interrupted", file=sys.stderr)
        return 130
    except SystemExit:
        raise
    except BaseException as e:  # noqa: BLE001 — the one fail-fast exit
        return fail_fast(e)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
