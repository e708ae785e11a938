#!/usr/bin/env python3
"""The benchmark's collective patterns across the cards of one host:
``python3 collectives_cards.py`` runs one ``torchrun`` world of every
card for each cell below, in turn, and prints each cell's output under
its label, the card's name and power limit first.

Cells, at the reference's 32 MiB x 128 iterations of int8, each with
``--check`` (its payload verified once after the timed loop):

- ``ring`` and ``torus2d --mesh-shape 2x2`` over NCCL (``--transport
  xla``) and over the peer-push kernel (``--transport pallas_dma``);
- ``all_to_all``, ``allreduce``, ``reduce_scatter`` and ``all_gather``
  over NCCL (the library collectives run under either transport);
- ``allreduce``, ``ring`` (both transports) and ``all_gather`` in
  ``--mode device`` (the per-op time on the card's clock).

The world is every visible card. ``--cpu`` runs the same cells as a
gloo world of 4 CPU ranks at 64 KiB x 4 (a rehearsal of the commands;
its numbers are host memcpy speeds). Exits non-zero when a cell fails.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

NCCL_ONLY = ("all_to_all", "allreduce", "reduce_scatter", "all_gather")
CELL_TIMEOUT_S = 600.0


def cells(n: int):
    """(label, arguments) of every cell on a world of ``n``."""
    side = int(n ** 0.5)
    torus = ["--pattern", "torus2d", "--mesh-shape", f"{side}x{n // side}"]
    out = []
    for transport in ("xla", "pallas_dma"):
        t = ["--transport", transport]
        out.append((f"ring {transport}", ["--pattern", "ring", *t]))
        out.append((f"torus2d {side}x{n // side} {transport}", [*torus, *t]))
    for pattern in NCCL_ONLY:
        out.append((pattern, ["--pattern", pattern]))
    out.append(("allreduce device", ["--pattern", "allreduce", "--mode",
                                     "device"]))
    out.append(("all_gather device", ["--pattern", "all_gather", "--mode",
                                      "device"]))
    for transport in ("xla", "pallas_dma"):
        out.append((f"ring device {transport}",
                    ["--pattern", "ring", "--mode", "device",
                     "--transport", transport]))
    return out


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    return "; ".join(out.stdout.strip().splitlines())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cpu", action="store_true",
                   help="a gloo world of 4 CPU ranks at 64 KiB x 4")
    args = p.parse_args(argv)
    if args.cpu:
        n = 4
    else:
        import torch

        n = torch.cuda.device_count()
        if n < 2:
            print("collectives_cards: needs 2 or more cards (or --cpu)",
                  file=sys.stderr)
            return 2
    extra = ["--check"]
    if args.cpu:
        extra += ["--cpu-mesh", str(n), "--msg-size", "64KiB", "--iters",
                  "4"]
    print(f"cards: {card_line()} | world of {n}", flush=True)
    bad = []
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.path.dirname(os.path.abspath(__file__)),
                    os.environ.get("PYTHONPATH")) if p))
    for label, cell in cells(n):
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(n), "-m", "tpu_p2p_torch", *cell,
               *extra]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=CELL_TIMEOUT_S, env=env)
            rc, out, err = proc.returncode, proc.stdout, proc.stderr
        except subprocess.TimeoutExpired as e:
            rc, out, err = 124, e.stdout or "", f"timed out: {e}"
        print(f"== {label} (rc {rc}, {time.perf_counter() - t0:.1f} s): "
              f"{' '.join(cell + extra)}", flush=True)
        sys.stdout.write(out if isinstance(out, str) else out.decode())
        if rc:
            bad.append(label)
            tail = err if isinstance(err, str) else err.decode()
            print(tail[-3000:], flush=True)
    print(f"cards: {card_line()}", flush=True)
    if bad:
        print(f"failed cells: {bad}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
