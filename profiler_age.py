"""Does ``torch.profiler`` lose device events as its process ages, or
only after the training loop's phase of ``chip_smoke.py``?

    python3 profiler_age.py [IDLE_SECONDS]     # on a card; ~11 min at 480

One process: it builds the kernels, then (1) traces 20 tiny kernels
(``torch.cuda._sleep``) under the profiler, the first launched as the
window opens, and once more after a host pause of 0.5 s, and reads, per
launch, the kernel's start less its ``cudaLaunchKernel`` start and how
many launches have no kernel record; (2) runs ``chip_smoke.ship_profile``
(phase 9's profiler check); (3) repeats (1) every 60 s while idle until
the process is ``IDLE_SECONDS`` old (default 480), then (1) with the
pause and (2); (4) runs ``chip_smoke.train_loop`` (phase 14), then the
device memory, threads and RSS, (1) and (2); (5) ``gc.collect()`` and
``torch.cuda.empty_cache()``, then the state, (1) and (2). One JSON line
a reading, each with the process's age, on stdout and in
``chiprun_out/profiler_age.jsonl``.
"""
import gc
import json
import os
import resource
import statistics
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke as S  # noqa: E402

T0 = time.time()
OUT = "chiprun_out/profiler_age.jsonl"
os.makedirs("chiprun_out", exist_ok=True)


def log(rec):
    rec["age_s"] = round(time.time() - T0, 1)
    line = json.dumps(rec)
    print(line, flush=True)
    with open(OUT, "a") as fh:
        fh.write(line + "\n")


def skew(tag, lead_s=0.0):
    """GPU kernel start minus its cudaLaunchKernel start (µs), per
    launch, in a CPU+CUDA trace; plus how many launches have no kernel
    record. 20 tiny kernels, the first right after the window opens."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if lead_s:
            time.sleep(lead_s)
        for _ in range(20):
            torch.cuda._sleep(2000)
            torch.cuda.synchronize()
            time.sleep(0.002)
    fd, fp = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    prof.export_chrome_trace(fp)
    with open(fp) as fh:
        tr = json.load(fh)["traceEvents"]
    os.remove(fp)
    launch = {e["args"]["correlation"]: e["ts"] for e in tr
              if e.get("cat") == "cuda_runtime"
              and "LaunchKernel" in e.get("name", "")
              and "correlation" in e.get("args", {})}
    kern = {e["args"]["correlation"]: e["ts"] for e in tr
            if e.get("cat") == "kernel" and "correlation" in e.get("args", {})}
    d = [kern[c] - t for c, t in launch.items() if c in kern]
    log({"tag": tag, "what": "skew", "lead_s": lead_s,
         "launches": len(launch), "kernels": len(kern),
         "missing": len([c for c in launch if c not in kern]),
         "gpu_minus_launch_us": [round(x, 1) for x in sorted(d)[:3]]
         + ["..."] + [round(x, 1) for x in sorted(d)[-2:]],
         "median_us": round(statistics.median(d), 1) if d else None})


def state(tag):
    free, total = torch.cuda.mem_get_info()
    log({"tag": tag, "what": "state",
         "allocated_gib": round(torch.cuda.memory_allocated() / 2**30, 3),
         "reserved_gib": round(torch.cuda.memory_reserved() / 2**30, 3),
         "free_gib": round(free / 2**30, 3),
         "py_threads": threading.active_count(),
         "os_threads": len(os.listdir("/proc/self/task")),
         "maxrss_gib": round(resource.getrusage(
             resource.RUSAGE_SELF).ru_maxrss / 2**20, 2),
         "rss_gib": round(int(open("/proc/self/statm").read().split()[1])
                          * os.sysconf("SC_PAGE_SIZE") / 2**30, 2),
         "gc_count": gc.get_count()})


def ship(tag, card):
    try:
        S.ship_profile(card)
        log({"tag": tag, "what": "ship_profile", "ok": True})
    except AssertionError as e:
        log({"tag": tag, "what": "ship_profile", "ok": False, "err": str(e)})


def main():
    from tpu_p2p_torch.ops import flash_attention as TFA
    from tpu_p2p_torch.utils import cuda_build

    card = S.card_line()
    cuda_build.build(["kvcache", "flash_attention", "p2p_dma"])
    log({"tag": "built", "what": "card", "card": card})
    skew("fresh")
    skew("fresh", 0.5)
    state("fresh")
    ship("fresh", card)
    idle_until = float(sys.argv[1]) if len(sys.argv) > 1 else 480
    while time.time() - T0 < idle_until:
        time.sleep(60)
        skew("idle")
    skew("idle", 0.5)
    ship("aged", card)
    dev = torch.device("cuda")
    S.train_loop(TFA, dev, card, 792.0)
    state("after14")
    skew("after14")
    skew("after14", 0.5)
    ship("after14", card)
    n = gc.collect()
    state(f"after14_gc_{n}")
    torch.cuda.empty_cache()
    state("after14_gc_empty")
    skew("after14_gc")
    ship("after14_gc", card)


if __name__ == "__main__":
    main()
