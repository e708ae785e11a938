"""The health smoke's straggler scenario, its step times laid bare.

    python3 straggler_series.py [REPEATS]      # on a card; ~2.5 min at 6

A world of 4 processes on ``cuda:0`` runs the straggler run of
``tpu_p2p_torch.obs.health.run_smoke`` ``REPEATS`` times (default 6):
rank 1 sleeps 150 ms a step from step ``2 + straggler_min_samples + 1``
on, with the obs stream on. For each run it prints the first rank's
``step_ms`` of every step and its straggler verdicts (the stream the
detector scored). Then ``chip_smoke.py``'s phase 19 (c), the whole
``obs smoke`` on 4 processes of the card, 3 times, each run's verdict on
a line of its own.
"""
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())


def series_case(reps: int):
    """Every rank: ``reps`` straggler runs → on the first rank a list of
    ``(step_ms, [(step, verdict)])`` a run; None elsewhere."""
    from tpu_p2p_torch.models import flagship as F
    from tpu_p2p_torch.obs import faults
    from tpu_p2p_torch.obs.health import HealthConfig, _smoke_cfg
    from tpu_p2p_torch.parallel import collectives as C
    from tpu_p2p_torch.parallel.runtime import make_runtime
    from tpu_p2p_torch.train import run_training

    rt = make_runtime(device="cuda:0")
    fmesh = F.build_mesh(rt.world, runtime=rt)
    start = 2 + HealthConfig.straggler_min_samples + 1
    out = []
    with tempfile.TemporaryDirectory(prefix="straggler_") as td:
        for i in range(reps):
            path = os.path.join(td, f"obs{i}.jsonl")
            with C.host_staged(True):
                run_training(_smoke_cfg(), steps=max(10, start + 4),
                             lr=1e-2, log_every=0, mesh=fmesh,
                             obs_jsonl=path, fault_plan=faults.FaultPlan(
                                 slow_rank=1, slow_ms=150.0,
                                 start_step=start))
            if rt.rank == 0:
                with open(path) as fh:
                    recs = [json.loads(s) for s in fh if s.strip()]
                out.append(([r["step_ms"] for r in recs
                             if r["obs"] == "step"],
                            [(r["step"], r["verdict"]) for r in recs
                             if r["obs"] == "health"]))
            rt.barrier()
    rt.close()
    return out if rt.rank == 0 else None


def main() -> int:
    import chip_smoke as cs
    from tpu_p2p_torch.obs.health import HealthConfig
    from tpu_p2p_torch.parallel.launch import run_world

    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    card = cs.card_line()
    start = 2 + HealthConfig.straggler_min_samples + 1
    t0 = time.perf_counter()
    runs = run_world(4, f"{os.path.abspath(__file__)}:series_case",
                     {"reps": reps}, timeout=600)[0]
    for i, (step_ms, verdicts) in enumerate(runs):
        print(f"run {i} (onset at step {start}): step_ms {step_ms}; "
              f"verdicts {verdicts} | {card}", flush=True)
    print(f"series: {time.perf_counter() - t0:.1f} s", flush=True)
    failed = 0
    for i in range(3):
        try:
            print(f"phase 19 (c) run {i}: {cs.obs_smoke_phase(card)}",
                  flush=True)
        except AssertionError as e:
            failed += 1
            print(f"phase 19 (c) run {i} failed: {e}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
