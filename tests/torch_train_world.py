"""Rank-side cases of the port's training-loop tests — this file imports
torch, numpy and the port only, never JAX.

``loop_case`` runs on every rank of a spawned gloo world
(``tpu_p2p_torch.parallel.launch.run_world(n, "<this file>:loop_case",
kwargs)``): one ``run_training`` a case, each on its own five-axis mesh
over the same world, and returns what the parent compares with the JAX
reference it ran on its 8-device CPU mesh.
"""

import io
import json

import numpy as np

from tpu_p2p_torch.models import flagship as F
from tpu_p2p_torch.models.flagship_steps import _param_of
from tpu_p2p_torch.train import run_training
from tpu_p2p_torch.utils.optim import tree_flatten_with_path


def loop_case(cases):
    """``cases``: dicts with ``name``, ``dims`` (dp, pp, sp, tp, ep),
    ``cfg`` (FlagshipConfig keywords) and ``run`` (run_training
    keywords; ``log_every`` and ``log_stream`` are set here) → name →
    ``{"records", "summary", "params", "moments"}``: the JSONL records
    and the summary (first rank; None elsewhere), the params gathered to
    global float32 arrays (first rank), and with ``"moments": True``
    this rank's (moment path, moment shape, param shard shape) triples of
    a fresh AdamW state over its final shards. A case with ``"fails":
    True`` gives ``{"error": (type name, message)}`` on every rank
    instead: what ``run_training`` raised there."""
    out, mesh = {}, None
    for c in cases:
        mesh = F.build_mesh(int(np.prod(c["dims"])), device="cpu",
                            dims=c["dims"])
        cfg = F.FlagshipConfig(**c["cfg"])
        buf = io.StringIO()
        if c.get("fails"):
            try:
                run_training(cfg, log_every=1, log_stream=buf, mesh=mesh,
                             **c["run"])
                out[c["name"]] = {"error": None}
            except Exception as e:  # noqa: BLE001 — the case's result
                out[c["name"]] = {"error": (type(e).__name__, str(e))}
            continue
        summary = run_training(cfg, log_every=1, log_stream=buf, mesh=mesh,
                               **c["run"])
        params = summary.pop("params")
        full = F.gather_flagship_params(params, mesh, cfg)
        moments = []
        if c.get("moments"):
            # The state the loop's step starts from: moments shaped like
            # this rank's shards (ZeRO's dp shards included).
            from tpu_p2p_torch.utils.optim import make_optimizer

            state = F.init_optimizer(make_optimizer("adamw", 1e-2, steps=4),
                                     params)
            for path, leaf in tree_flatten_with_path(state):
                name = _param_of(path)
                if name is not None:
                    moments.append((path, tuple(leaf.shape),
                                    tuple(params[name].shape)))
        first = mesh.index == 0
        out[c["name"]] = {
            "records": ([json.loads(s) for s in buf.getvalue().splitlines()]
                        if first else None),
            "summary": summary if first else None,
            "params": ({k: v.float().numpy() for k, v in full.items()}
                       if first else None),
            "moments": moments,
        }
    mesh.runtime.close()
    return out
