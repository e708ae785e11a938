"""Rank-side cases of the port's overlap tests — this file imports torch,
numpy and the port only, never JAX.

``ring_case`` runs on every rank of a spawned gloo world of 4
(``tpu_p2p_torch.parallel.launch.run_world(4, "<this file>:ring_case",
kwargs)``) and returns what the parent compares with the JAX reference it
ran on its CPU devices from the same numpy inputs: the ring
collective-matmuls of ``tpu_p2p_torch.parallel.collectives`` on lines of
2 (axis ``x`` of a 2x2 mesh), 4 (a 1-D mesh) and 1 (a size-1 axis),
their gradients, both transports of the gather ring and of the chunk
wave, and the three ``CollectiveCache`` chains.
"""

import numpy as np
import torch

from tpu_p2p_torch.parallel import collectives as C
from tpu_p2p_torch.parallel import pallas_dma as PD
from tpu_p2p_torch.parallel.runtime import make_runtime

# Each case's line: (mesh dims, axis names, the axis the line runs along).
LINES = {"x2": ((2, 2), ("x", "y"), "x"), "d4": ((4,), ("d",), "d"),
         "z1": ((2, 2, 1), ("x", "y", "z"), "z")}


def ring_body(fn, line, ins, transport="xla"):
    """One ring function on this rank's inputs ``ins`` (name → tensor)
    along ``line``; → the output. The parent's JAX twin
    (``tests/test_torch_overlap_collectives.py::ring_body``) computes the
    same with the reference's functions."""
    if fn == "gather":
        return C.ring_allgather_matmul(
            lambda c, s: (c @ ins["w"]) * (s + 1), ins["x"], line, 1,
            transport=transport)
    if fn == "gather_src":
        return C.ring_allgather_matmul(lambda c, s: c + s, ins["x"], line,
                                       0, transport=transport)
    if fn == "rs":
        return C.matmul_ring_reducescatter(
            lambda c, i: c @ ins["w"] + i, ins["x"], line, 1)
    if fn == "a2a":
        return C.ring_all_to_all_matmul(
            lambda c, s: c @ ins["w"] + s, ins["x"], line, 0, 1)
    if fn == "a2a_back":
        return C.matmul_ring_all_to_all(
            lambda c, d: c @ ins["w"] + d, ins["x"], line, 1, 0)
    if fn == "wave":
        return C.chunked_ppermute_compute(
            lambda c, i: c @ ins["w"], ins["x"], line, ins["edges"], 0,
            ins["chunks"], transport=transport)
    raise ValueError(fn)


def _tensors(ins, rank, grad):
    out = {}
    for k, v in ins.items():
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(v[rank]))
            out[k] = t.requires_grad_(grad) if grad else t
        else:
            out[k] = v
    return out


def ring_case(cases, chains):
    """``cases``: dicts with ``name``, ``fn``, ``line`` (a key of
    ``LINES``), ``ins`` (name → numpy ``[4, ...]``, rank ``r``'s at
    ``[r]``; other values pass as they are), ``transport`` and, for a
    gradient, ``cot`` (numpy ``[4, *out]``) → name → ``{"out"}`` (and
    ``"grads"``: name → this rank's gradient of ``sum(out * cot[r])``),
    or ``{"error": message}`` where the function raised. ``chains``:
    dicts with ``name``, ``chain`` (``tp_ring_chain`` / ``ep_ring_chain`` /
    ``pp_wave_chain``), ``line``, ``payload`` (numpy ``[4, elems]``) and
    ``kw`` → name → this rank's result. Also ``"launches"``: the
    peer-push kernel counts, none on the CPU."""
    rt = make_runtime(device="cpu")
    meshes = {k: rt.axis_mesh(dims, names)
              for k, (dims, names, _) in LINES.items()}
    out = {}
    for c in cases:
        line = meshes[c["line"]].line(LINES[c["line"]][2])
        grad = "cot" in c
        ins = _tensors(c["ins"], rt.rank, grad)
        try:
            y = ring_body(c["fn"], line, ins, c.get("transport", "xla"))
        except ValueError as e:
            out[c["name"]] = {"error": str(e)}
            continue
        res = {"out": y.detach().numpy()}
        if grad:
            (y * torch.from_numpy(c["cot"][rt.rank])).sum().backward()
            res["grads"] = {k: v.grad.numpy() for k, v in ins.items()
                            if isinstance(v, torch.Tensor)}
        out[c["name"]] = res
    cache = C.CollectiveCache()
    for c in chains:
        mesh = meshes[c["line"]]
        fn = getattr(cache, c["chain"])(mesh, LINES[c["line"]][2], **c["kw"])
        out[c["name"]] = fn(torch.from_numpy(
            np.ascontiguousarray(c["payload"][rt.rank:rt.rank + 1]))).numpy()
    out["launches"] = dict(PD.launches)
    rt.close()
    return out
