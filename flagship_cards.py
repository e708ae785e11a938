#!/usr/bin/env python3
"""The flagship training step across the cards of one host:
``python3 flagship_cards.py`` runs ``python -m tpu_p2p_torch train`` at
the flagship_large width (B 4 x T 4096, 16 heads over 8 KV heads of 128,
8 blocks, vocab 32768, rope, norm, flash, bf16, SGD lr 1e-2, seed 0)
with the 4x dense FFN and then with the MoE FFN (4 experts as wide,
capacity factor 2, top-1, groups of 256): each on one card, then as one
``torchrun`` world of every card on each of its meshes below, and
prints each run's records under its label, the cards' name and power
limit first. Three sets of meshes: ``--ffn dense``, ``--ffn moe`` or
``--ffn zero`` runs one set alone (with the one-card runs of the FFNs
it uses), ``--ffn all`` (the default) every set.

Dense meshes on 4 cards (dp x pp x sp x tp x ep):

- ``build_mesh(4)``: dp 2 x sp 2, the ring;
- sp 4 with ``ring_zigzag``;
- sp 4 with ``ulysses``;
- tp 2 x sp 2 (the ring);
- pp 2 x dp 2 (GPipe, one microbatch: a bubble tick a stage).

MoE meshes on 4 cards:

- ep 4 (one expert a card, the batch split four ways);
- dp 2 x ep 2 (the experts' gradients summed over dp only);
- sp 2 x ep 2 (the ring and the ep all-to-alls together).

ZeRO and remat on 4 cards (``zero``):

- dense dp 4, replicated (the gradient all-reduce after the backward);
- dense dp 4 ``--zero-dp`` (a bulk all-gather a leaf in the forward, a
  reduce-scatter a leaf in the backward);
- dense dp 4 ``--zero-dp --overlap prefetch`` (one bucketed gather a
  block, issued a block ahead);
- MoE dp 2 x ep 2 ``--zero-dp --overlap prefetch --remat``.

The training loop on 4 cards (``--ffn loop``, not part of ``all``):
one ``torchrun`` world of dp 2 x sp 2 trains the dense FFN with AdamW
(weight decay 0.01, lr 3e-4), global-norm clipping at 1.0, one warmup
step and the cosine schedule for 4 steps, publishing a checkpoint
generation every 2 steps; then one card resumes a copy of its
checkpoint directory without ``gen-000004`` to step 4. It prints both
runs' records, each save's seconds and the resumed final loss's
relative difference from the 4 cards' (bf16 on another mesh: a
reading; the CPU tests hold the cross-mesh resume to 1e-4 in float32).

For each mesh: the step ms (median of steps 2-4, each read when its loss
reached the host), tokens/s, the peak device memory and flash kernel
launches (over the run) of every rank, and
the relative difference of the losses of steps 1 and 2 from the
same FFN's one-card run (bf16 sums in another order: a reading, not a gate; the
float32 CPU parity tests hold the math). One JSON object with every
number closes the output (and goes to ``--json PATH`` too).

After each mesh's run, one more ``torchrun`` world of the same mesh
profiles its third step on every rank (``--profile-rank``, this script
under ``torchrun``): wall ms, the card's busy time (the union of its
kernel spans over all streams), idle share, and device ms by kernel
family (NCCL send/recv — the ep all-to-alls and the ring's hops —,
NCCL all-gather and reduce-scatter — the ZeRO traffic —, other NCCL,
flash, GEMM, copies and casts, elementwise, reductions).

``--cpu`` runs the same meshes as gloo worlds of 4 CPU ranks at a tiny
width (a rehearsal of the commands; its times are the host's, and the
profile has no card to read). Exits non-zero when a run fails; a failed
mesh is reported with its error.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import re
import signal
import statistics
import subprocess
import sys
import time

RUN_TIMEOUT_S = 300.0
STEPS = 4
LARGE = ["--batch", "4", "--seq", "4096", "--heads", "16", "--kv-heads",
         "8", "--head-dim", "128", "--stages", "8", "--microbatches", "1",
         "--moe-mult", "4", "--vocab", "32768", "--dtype", "bfloat16"]
TINY = ["--batch", "4", "--seq", "64", "--heads", "8", "--kv-heads", "4",
        "--head-dim", "8", "--stages", "2", "--microbatches", "1",
        "--moe-mult", "4", "--vocab", "64", "--device", "cpu"]
COMMON = ["--rope", "--norm", "--flash", "--lr", "1e-2", "--seed", "0",
          "--steps", str(STEPS), "--log-every", "1"]
DENSE_MESHES = (
    ("dp2 x sp2 ring (build_mesh(4))", []),
    ("sp4 ring_zigzag", ["--mesh-shape", "1x1x4x1x1", "--sp-strategy",
                         "ring_zigzag"]),
    ("sp4 ulysses", ["--mesh-shape", "1x1x4x1x1", "--sp-strategy",
                     "ulysses"]),
    ("tp2 x sp2 ring", ["--mesh-shape", "1x1x2x2x1"]),
    ("pp2 x dp2", ["--mesh-shape", "2x2x1x1x1"]),
)
MOE_MESHES = (
    ("moe ep4", ["--mesh-shape", "1x1x1x1x4"]),
    ("moe dp2 x ep2", ["--mesh-shape", "2x1x1x1x2"]),
    ("moe sp2 x ep2 ring", ["--mesh-shape", "1x1x2x1x2"]),
)
DP4 = ["--mesh-shape", "4x1x1x1x1"]
ZERO_MESHES = (  # (label, FFN, mesh and knobs)
    ("dense dp4 replicated", "dense", DP4),
    ("dense dp4 zero", "dense", [*DP4, "--zero-dp"]),
    ("dense dp4 zero prefetch", "dense",
     [*DP4, "--zero-dp", "--overlap", "prefetch"]),
    ("moe dp2 x ep2 zero prefetch remat", "moe",
     ["--mesh-shape", "2x1x1x1x2", "--zero-dp", "--overlap", "prefetch",
      "--remat"]),
)
FFNS = {  # FFN -> (train's FFN flags, one-card label)
    "dense": (["--dense-ffn"], "one card"),
    "moe": ([], "moe one card"),
}
LOOP = ["--optimizer", "adamw", "--weight-decay", "0.01", "--clip-norm",
        "1.0", "--warmup-steps", "1", "--schedule", "cosine", "--lr", "3e-4",
        "--ckpt-every", "2", "--ckpt-keep", "2"]
SETS = {  # --ffn -> [(label, FFN, mesh flags)]
    "dense": [(label, "dense", m) for label, m in DENSE_MESHES],
    "moe": [(label, "moe", m) for label, m in MOE_MESHES],
    "zero": list(ZERO_MESHES),
}


FAMILIES = (
    ("nccl send/recv", ("SendRecv",)),
    ("nccl all-gather", ("AllGather",)),
    ("nccl reduce-scatter", ("ReduceScatter",)),
    ("nccl", ("nccl", "Nccl")),
    ("flash", ("flash_fwd_kernel", "flash_bwd_")),
    ("gemm", ("gemm", "Gemm", "nvjet", "xmma", "cutlass", "cublas")),
    ("copy/cast", ("copy", "Copy", "Memcpy", "Memset", "cast", "Cat")),
    ("reduce", ("reduce", "Reduce", "softmax", "norm")),
    ("elementwise", ("elementwise", "Elementwise", "vectorized")),
)


def union_ms(spans) -> float:
    """Length of the union of ``(start_us, end_us)`` spans, in ms."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def profile_rank(argv) -> int:
    """One rank of a profiled step, under ``torchrun``: ``argv`` are
    ``train``'s arguments. Two warm steps, then the third under
    ``torch.profiler``; rank 0 prints every rank's breakdown as one
    ``{"profile": [...]}`` line."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpu_p2p_torch import train as T
    from tpu_p2p_torch.models import flagship as F
    from tpu_p2p_torch.parallel.runtime import make_runtime
    from tpu_p2p_torch.utils.data import DeviceLoader

    args = T._build_parser().parse_args(argv)
    cfg = T.config_from_args(args)
    rt = make_runtime(
        device="cpu" if args.device == "cpu" else None, axis_names=F.AXES,
        mesh_shape=T.mesh_shape(args.mesh_shape,
                                int(os.environ["WORLD_SIZE"])))
    mesh = rt.mesh
    params = F.place_flagship_params(
        F.init_flagship_params(cfg, seed=args.seed, device="cpu"), mesh, cfg)
    step = F.make_flagship_lm_train_step(cfg, lr=args.lr, donate=True,
                                         mesh=mesh)
    loader = DeviceLoader(T._per_step_batches(cfg, args.seed, 0),
                          mesh.device, mesh=mesh,
                          spec=F.flagship_data_spec(mesh))
    for _ in range(2):
        params, loss = step(params, *next(loader))
        float(loss)
    batch = next(loader)
    rt.barrier()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, loss = step(params, *batch)
        float(loss)
        wall = (time.perf_counter() - t0) * 1e3
    spans, fam = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        spans.append((ev.time_range.start, ev.time_range.end))
        family = next((f for f, keys in FAMILIES
                       if any(k in ev.name for k in keys)), "other")
        fam[family] = fam.get(family, 0.0) + ev.time_range.elapsed_us() / 1e3
    busy = union_ms(spans)
    mine = {"rank": rt.rank, "coords": mesh.coords, "wall_ms": wall,
            "device_events": len(spans), "busy_ms": busy,
            "idle_share": 1 - busy / wall, "device_ms_by_family": fam}
    rows = rt.gather(mine)
    rt.close()
    if rows[0]["rank"] == mine["rank"]:
        print(json.dumps({"profile": rows}), flush=True)
    return 0


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    return "; ".join(out.stdout.strip().splitlines())


def run(label: str, cmd: list, env: dict, tokens: int,
        steps: int = STEPS) -> dict:
    """One training run of ``steps`` logged steps → its records' numbers,
    or its error."""
    t0 = time.perf_counter()
    # A session of its own, so a run past its time limit goes down with
    # every rank torchrun started.
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=RUN_TIMEOUT_S)
        rc = proc.returncode
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        rc, err = 124, f"timed out after {RUN_TIMEOUT_S} s\n{err}"
    print(f"== {label} (rc {rc}, {time.perf_counter() - t0:.1f} s): "
          f"{' '.join(cmd[cmd.index('train'):])}", flush=True)
    sys.stdout.write(out)
    res = {"label": label, "rc": rc}
    recs = [r for r in (json.loads(s) for s in out.splitlines()
                        if s.startswith('{"step"')) if "loss" in r]
    memory = re.search(r"peak device memory per rank \(GiB\): (\[.*\])",
                       err)
    launches = re.search(r"flash kernel launches per rank: (\[.*\])", err)
    if rc or len(recs) != steps:
        res["error"] = err[-3000:]
        print(res["error"], flush=True)
        return res
    walls = [0.0] + [r["wall_s"] for r in recs]
    step_ms = [1e3 * (b - a) for a, b in zip(walls, walls[1:])]
    p50 = statistics.median(step_ms[1:] or step_ms)
    res.update(losses=[r["loss"] for r in recs], step_ms=step_ms,
               step_ms_p50=p50, tokens_per_s=tokens / p50 * 1e3,
               peak_gib=json.loads(memory.group(1)) if memory else None,
               flash_launches=(ast.literal_eval(launches.group(1))
                               if launches else None))
    return res


def profiled(label: str, cmd: list, env: dict):
    """The per-rank breakdown a ``--profile-rank`` world prints, or its
    error."""
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                              timeout=RUN_TIMEOUT_S, start_new_session=True)
        rc, out, err = proc.returncode, proc.stdout, proc.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = 124, "", f"timed out: {e}"
    print(f"== {label} profile (rc {rc}, {time.perf_counter() - t0:.1f} "
          f"s)", flush=True)
    rows = [json.loads(s)["profile"] for s in out.splitlines()
            if s.startswith('{"profile"')]
    if rc or not rows:
        print(err[-3000:], flush=True)
        return {"error": err[-3000:]}
    for row in rows[0]:
        if not row["device_events"]:
            print(f"  rank {row['rank']} {row['coords']}: wall "
                  f"{row['wall_ms']:.1f} ms; no device events (CPU ranks)",
                  flush=True)
            continue
        fam = ", ".join(f"{k} {v:.1f}" for k, v in sorted(
            row["device_ms_by_family"].items(), key=lambda kv: -kv[1]))
        print(f"  rank {row['rank']} {row['coords']}: wall "
              f"{row['wall_ms']:.1f} ms, busy {row['busy_ms']:.1f}, idle "
              f"share {row['idle_share']:.3f} | {fam}", flush=True)
    return rows[0]


def loop_cards(shape: list, env: dict, torchrun: list, tokens: int,
               card: str) -> list:
    """``--ffn loop``: the 4-card AdamW run with its checkpoints, then one
    card resuming it → the two runs' results."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="flagship_cards_loop_")
    try:
        ck4, ck1 = os.path.join(root, "cards"), os.path.join(root, "one")
        common = [*shape, "--dense-ffn", *COMMON, *LOOP]  # LOOP's --lr
        # comes last, so it wins
        train = ["-m", "tpu_p2p_torch", "train", *common]
        t0 = time.perf_counter()
        four = run("loop dp2 x sp2 adamw clip cosine ckpt",
                   [*torchrun, *train, "--mesh-shape", "2x1x2x1x1",
                    "--ckpt-dir", ck4], env, tokens)
        four["seconds"] = time.perf_counter() - t0
        gens = sorted(os.listdir(ck4)) if os.path.isdir(ck4) else []
        four["generations"] = gens
        if "error" in four:
            return [four]
        os.makedirs(ck1)
        shutil.copytree(os.path.join(ck4, "gen-000002"),
                        os.path.join(ck1, "gen-000002"))
        t0 = time.perf_counter()
        one = run("loop resume on one card from gen-000002",
                  [sys.executable, *train, "--ckpt-dir", ck1, "--resume"],
                  env, tokens, steps=STEPS - 2)
        one["seconds"] = time.perf_counter() - t0
        if "losses" in one:
            one["final_loss_rel_diff"] = (abs(one["losses"][-1]
                                              - four["losses"][-1])
                                          / abs(four["losses"][-1]))
            print(f"loop: 4 cards {four['losses']} ({four['seconds']:.1f} s "
                  f"with two saves; generations {gens}) | one card resumed "
                  f"at step 2: {one['losses']} ({one['seconds']:.1f} s with "
                  f"the load and a save), final loss rel. diff "
                  f"{one['final_loss_rel_diff']:.3e} | {card}", flush=True)
        return [four, one]
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--profile-rank"]:
        return profile_rank(argv[1:])
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cpu", action="store_true",
                   help="gloo worlds of 4 CPU ranks at a tiny width")
    p.add_argument("--json", metavar="PATH",
                   help="also write the closing JSON object to PATH")
    p.add_argument("--ffn", choices=(*SETS, "all", "loop"), default="all",
                   help="which set of runs (default all; loop: the "
                        "training loop's checkpoint and resume)")
    args = p.parse_args(argv)
    if args.cpu:
        n, shape = 4, TINY
    else:
        import torch

        n, shape = torch.cuda.device_count(), LARGE
        if n != 4:
            print(f"flagship_cards: the meshes need 4 cards, {n} visible",
                  file=sys.stderr)
            return 2
    tokens = int(shape[shape.index("--batch") + 1]) \
        * int(shape[shape.index("--seq") + 1])
    card = card_line()
    print(f"cards: {card} | world of {n}", flush=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.path.dirname(os.path.abspath(__file__)),
                    os.environ.get("PYTHONPATH")) if p))
    torchrun = [sys.executable, "-m", "torch.distributed.run",
                "--standalone", "--nproc-per-node", str(n)]
    results, one_card = [], {}
    if args.ffn == "loop":
        results = loop_cards(shape, env, torchrun, tokens, card)
    for name in (SETS if args.ffn == "all" else
                 (args.ffn,) if args.ffn != "loop" else ()):
        for label, ffn, mesh in SETS[name]:
            flags, one_label = FFNS[ffn]
            common = [*shape, *flags, *COMMON]
            train = ["-m", "tpu_p2p_torch", "train", *common]
            if ffn not in one_card:
                one_card[ffn] = run(one_label, [sys.executable, *train],
                                    env, tokens)
                results.append(one_card[ffn])
            one = one_card[ffn]
            res = run(label, [*torchrun, *train, *mesh], env, tokens)
            res["profile"] = profiled(label, [
                *torchrun, os.path.abspath(__file__), "--profile-rank",
                *common, *mesh], env)
            if "losses" in res and "losses" in one:
                res["loss_rel_diff_steps_1_2"] = [
                    abs(a - b) / abs(b) for a, b in zip(res["losses"][:2],
                                                        one["losses"][:2])]
                res["speedup_vs_one_card"] = (res["tokens_per_s"]
                                              / one["tokens_per_s"])
            results.append(res)
    for res in results:
        if "error" in res:
            print(f"{res['label']}: FAILED (rc {res['rc']})", flush=True)
            continue
        extra = ""
        if "loss_rel_diff_steps_1_2" in res:
            extra = (f" | x{res['speedup_vs_one_card']:.2f} the one card's "
                     f"tokens/s | loss rel diff steps 1-2 "
                     f"{[f'{d:.2e}' for d in res['loss_rel_diff_steps_1_2']]}")
        print(f"{res['label']}: step {res['step_ms_p50']:.1f} ms = "
              f"{res['tokens_per_s']:.0f} tokens/s | peak GiB per rank "
              f"{res['peak_gib']} | losses {res['losses']}{extra} | {card}",
              flush=True)
    summary = {"cards": card, "world": n, "results": results}
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(summary, fh, indent=1)
    print(json.dumps(summary), flush=True)
    return 1 if any(r["rc"] for r in results) else 0


if __name__ == "__main__":
    sys.exit(main())
