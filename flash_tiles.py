#!/usr/bin/env python3
"""Tile sizes of the bf16 tensor-core flash kernels on one NVIDIA GPU:
``python3 flash_tiles.py``.

Builds ``tpu_p2p_torch/csrc/flash_attention.cu`` once for each tile
variant below (its ``TP_FWD_*`` / ``TP_BWD_*`` / ``TP_DQ_*`` macros;
every build at once), then, at the training shape of ``chip_smoke.py``
(B 4, 16 query heads over 8 KV heads, T 4096, D 128, bf16, causal), for
each variant of ``flash_fwd_kernel_wgmma``, ``flash_bwd_dkdv_kernel_wgmma``
and ``flash_bwd_dq_kernel_wgmma``:

- ptxas's registers and spill bytes at D 128 (the build's ``-v`` log);
- the tiles, threads, dynamic shared memory and resident CTAs an SM
  (``tp_flash_config``, on this card);
- the kernel's time: CUDA events around 10 calls, the median of 3;
- its outputs against the default build's (normalised L-inf; the order
  of float32 sums differs between tilings, nothing else).

Prints one line per variant, then one JSON object with every row, and
the card's name and power limit. Exits non-zero without a card.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

B, HQ, HKV, T, D = 4, 16, 8, 4096, 128
DEFAULT = {"TP_FWD_WG": 2, "TP_FWD_BK": 64, "TP_FWD_MINB": 2,
           "TP_BWD_WG": 2, "TP_BWD_BQ": 64, "TP_BWD_MINB": 1,
           "TP_DQ_WG": 2, "TP_DQ_BK": 64, "TP_DQ_MINB": 1}
# (kernel, macros changed from DEFAULT): BQ = 64 x TP_FWD_WG (TP_DQ_WG)
# q rows and BK = 64 x TP_BWD_WG key rows, one warpgroup per 64 rows;
# MINB asks ptxas for that many resident CTAs an SM (a register cap).
VARIANTS = [
    ("flash_fwd", {}),
    ("flash_fwd", {"TP_FWD_MINB": 1}),
    ("flash_fwd", {"TP_FWD_BK": 128, "TP_FWD_MINB": 1}),
    ("flash_fwd", {"TP_FWD_WG": 1, "TP_FWD_MINB": 1}),
    ("flash_fwd", {"TP_FWD_WG": 1, "TP_FWD_BK": 128, "TP_FWD_MINB": 1}),
    ("flash_bwd_dkdv", {}),
    ("flash_bwd_dkdv", {"TP_BWD_BQ": 32}),
    ("flash_bwd_dkdv", {"TP_BWD_WG": 1}),
    ("flash_bwd_dkdv", {"TP_BWD_WG": 1, "TP_BWD_BQ": 32}),
    # dq at D 128: BQ 64 x BK 64 (97 KiB) is the one tiling whose shared
    # memory lets 2 CTAs share an SM; the other three hold 1.
    ("flash_bwd_dq", {}),
    ("flash_bwd_dq", {"TP_DQ_BK": 128}),
    ("flash_bwd_dq", {"TP_DQ_WG": 1, "TP_DQ_MINB": 2}),
    ("flash_bwd_dq", {"TP_DQ_WG": 1, "TP_DQ_BK": 128}),
]
KERNEL = {"flash_fwd": "flash_fwd_kernel_wgmma",
          "flash_bwd_dkdv": "flash_bwd_dkdv_kernel_wgmma",
          "flash_bwd_dq": "flash_bwd_dq_kernel_wgmma"}
PREFIX = {"flash_fwd": "TP_FWD", "flash_bwd_dkdv": "TP_BWD",
          "flash_bwd_dq": "TP_DQ"}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def defines(changes: dict) -> tuple:
    return tuple(f"{k}={v}" for k, v in sorted({**DEFAULT,
                                                **changes}.items()))


def device_ms(fn, calls: int = 10, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(calls):
            fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / calls)
    return statistics.median(times)


def norm_err(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_tiles: no CUDA device visible; this runs on an NVIDIA "
              "GPU", file=sys.stderr)
        return 2
    from tpu_p2p_torch.ops import flash_attention as TFA
    from tpu_p2p_torch.utils import cuda_build

    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)} | {card}", flush=True)
    sets = {defines(ch) for _, ch in VARIANTS}
    with ThreadPoolExecutor(len(sets)) as pool:
        built = dict(zip(sets, pool.map(
            lambda s: cuda_build.build(["flash_attention"], s)
            ["flash_attention"], sets)))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    q3, do3 = (torch.randn((B * HQ, T, D), generator=gen, device=dev).to(bf)
               for _ in range(2))
    k3, v3 = (torch.randn((B * HKV, T, D), generator=gen, device=dev).to(bf)
              for _ in range(2))
    carry = TFA.zero_carry(B * HQ, T, D, dev)
    kw = dict(causal=True, q_heads=HQ)
    calls = {
        "flash_fwd": lambda: TFA._flash_call(q3, k3, v3, *carry, **kw),
        "flash_bwd_dkdv": lambda: TFA._flash_bwd_dkdv(*bargs, **kw),
        "flash_bwd_dq": lambda: (TFA._flash_bwd_dq(*bargs, **kw),),
    }
    TFA._LIB = TFA.declare(cuda_build.load("flash_attention",
                                           defines({})))
    o, m, l = TFA._flash_call(q3, k3, v3, *carry, **kw)
    L = m + torch.log(l)
    delta = (do3.float() * (o / l[..., None])).sum(-1)
    bargs = (q3, k3, v3, do3, L, delta, 0, 0)
    want = {name: fn() for name, fn in calls.items()}

    rows = []
    for kernel, changes in VARIANTS:
        macros = defines(changes)
        TFA._LIB = TFA.declare(cuda_build.load("flash_attention", macros))
        cfg = TFA.kernel_config(kernel, bf, D)
        got = calls[kernel]()
        err = max(norm_err(g, w) for g, w in zip(got, want[kernel]))
        row = {"kernel": kernel,
               "macros": {k: v for k, v in {**DEFAULT, **changes}.items()
                          if k.startswith(PREFIX[kernel])},
               "bq": cfg["bq"], "bk": cfg["bk"], "threads": cfg["threads"],
               "smem": cfg["smem"], "ctas_per_sm": cfg["ctas_per_sm"],
               **cuda_build.ptxas_usage(built[macros]["log"],
                                        f"{KERNEL[kernel]}ILi{D}E"),
               "ms": device_ms(calls[kernel]),
               "err_vs_default": err}
        rows.append(row)
        minb = {**DEFAULT, **changes}[PREFIX[kernel] + "_MINB"]
        print(f"{kernel} BQ {row['bq']} BK {row['bk']} threads "
              f"{row['threads']} MINB {minb}: "
              f"{row['ms']:.4f} ms | {row['registers']} registers, spill "
              f"{row['spill_stores']} / {row['spill_loads']} B, "
              f"{row['smem']} B shared, {row['ctas_per_sm']} CTAs an SM | "
              f"vs default {err:.2e} | {card}", flush=True)
    print(json.dumps({"tiles": rows, "shape": {"B": B, "Hq": HQ, "Hkv": HKV,
                                               "T": T, "D": D}}))
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
