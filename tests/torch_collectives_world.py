"""Rank-side cases of the port's collective tests — this file imports
torch, numpy and the port only, never JAX.

Each ``*_case`` function runs on every rank of a spawned world
(``tpu_p2p_torch.parallel.launch.run_world(n, "<this file>:<case>",
kwargs)``) and returns what the parent compares:
``tests/test_torch_collectives.py`` holds the CPU results against the JAX
reference, ``tests/test_torch_cuda.py`` runs the card cases.
"""

import numpy as np
import torch

from tpu_p2p_torch.parallel import collectives as C
from tpu_p2p_torch.parallel import pallas_dma as PD
from tpu_p2p_torch.parallel import runtime as RT

SINGLES = ("all_to_all", "all_reduce", "reduce_scatter", "all_gather")
CHAINS = ("psum_chain", "rs_ag_chain", "ag_chain")
SHAPES_2D = ((4, 2), (2, 4))


def small_int_payload(n, elems, seed=0):
    """``[n, elems]`` float32 of small integers: every sum of them is
    exact in any order, so a float reduction compares bitwise."""
    rng = np.random.default_rng(seed)
    return rng.integers(-8, 9, (n, elems)).astype(np.float32)


def builders(cache, mesh, axis, k):
    """Every CollectiveCache reduction builder of the benchmark, single
    and chained ``k`` times, by name."""
    out = {name: getattr(cache, name)(mesh, axis) for name in SINGLES}
    out.update({name: getattr(cache, name)(mesh, axis, k)
                for name in CHAINS})
    return out


def axis_permutes(rt, x, chain):
    """Shift-by-1 rings along each axis of ``rt.mesh`` over both
    transports, one hop and ``chain`` hops → arrays by (axis, transport,
    hops)."""
    cache = C.CollectiveCache()
    out = {}
    for axis, size in rt.mesh.shape.items():
        ring = C.ring_edges(size)
        for transport in ("xla", "pallas_dma"):
            one = cache.permute(rt.mesh, axis, ring, transport=transport)
            many = cache.permute_chain(rt.mesh, axis, ring, chain,
                                       transport=transport)
            out[(axis, transport, 1)] = one(x).numpy()
            out[(axis, transport, chain)] = many(x).numpy()
    return out


def cpu_collectives_case(msg_bytes=64, k=3, chain=3):
    """On a gloo world: every reduction builder (single and ``k``-chained)
    on the int8 payload and a small-integer float32 row; then, on 2-D
    meshes of the same world, per-axis ring permutes over both
    transports and what the runtime formed (lines, groups, windows) →
    this rank's arrays and facts."""
    rt = RT.make_runtime(device="cpu")
    i, n = rt.rank, rt.world
    cache = C.CollectiveCache()
    x8 = C.make_payload(rt.mesh, msg_bytes, np.int8)
    xf = torch.from_numpy(small_int_payload(n, msg_bytes)[i:i + 1])
    out = {"builders": {}}
    for name, fn in builders(cache, rt.mesh, "d", k).items():
        out["builders"][name] = (fn(x8).numpy(), fn(xf).numpy())
    out["payload_intact"] = torch.equal(
        x8, C.make_payload(rt.mesh, msg_bytes, np.int8))
    for shape in SHAPES_2D:
        rt2 = RT.make_runtime(device="cpu", mesh_shape=shape)
        mesh = rt2.mesh
        lines = {a: mesh.line(a) for a in mesh.axis_names}
        out[shape] = {
            "shape": mesh.shape,
            "index": mesh.index,
            "lines": {a: m.ranks for a, m in lines.items()},
            "line_axes": {a: m.axis_names for a, m in lines.items()},
            "groups": sorted(rt2._groups),
            # Each line's windows are its rank set's: no two lines of
            # this rank share a dict, and none is the world's.
            "windows_shared": len({id(m.windows) for m in lines.values()}
                                  | {id(mesh.windows)}) != 3,
            "windows_by_set": all(
                rt2._groups[tuple(sorted(m.ranks))][2] is m.windows
                for m in lines.values()),
            "permutes": axis_permutes(
                rt2, C.make_payload(mesh, msg_bytes, np.int8), chain),
        }
    rt.close()
    return out


def card_collectives_case(msg_bytes=1 << 20, k=3, device="cuda:0"):
    """A world of 1 on a card, NCCL: every reduction builder against the
    host oracles, bitwise on int8 and on small-integer float32 → the
    (builder, dtype) pairs that disagree."""
    rt = RT.make_runtime(device=device)
    cache = C.CollectiveCache()
    x8 = C.make_payload(rt.mesh, msg_bytes, np.int8)
    host8 = C.host_payload(rt.mesh, msg_bytes, np.int8)
    hostf = small_int_payload(1, msg_bytes)
    xf = torch.from_numpy(hostf).to(rt.device)
    bad = []
    for name, fn in builders(cache, rt.mesh, "d", k).items():
        for x, host in ((x8, host8), (xf, hostf)):
            want = oracle(name, host, k)
            if not np.array_equal(fn(x).cpu().numpy(), want):
                bad.append((name, str(x.dtype)))
    rt.close()
    return bad


def oracle(name, host, k):
    """The host oracle of a builder, chained ``k`` times (rows of a
    chain hop's input are what the previous hop left)."""
    single = {"all_to_all": lambda h: C.expected_all_to_all(h, len(h)),
              "all_reduce": C.expected_all_reduce,
              "reduce_scatter": C.expected_reduce_scatter,
              "all_gather": C.expected_all_gather,
              "psum_chain": C.expected_all_reduce,
              "rs_ag_chain": C.expected_all_reduce,  # RS + AG = sum
              "ag_chain": C.expected_all_gather}[name]
    hops = k if name in CHAINS else 1
    for _ in range(hops):
        host = single(host)
    return host


def card_permute_case(shape=None, msg_bytes=4 << 20, chain=3,
                      device="cuda:0"):
    """Ranks sharing ``device``: shift-by-1 rings along every axis of a
    1-D world or of a ``shape`` mesh over the peer-push kernel, one hop
    and ``chain`` hops, against ``expected_permute`` bitwise → (bad
    cases, launches, launches made)."""
    rt = RT.make_runtime(device=device, mesh_shape=shape)
    mesh = rt.mesh
    PD.reset_launches()
    x = C.make_payload(mesh, msg_bytes, np.int8)
    host = C.host_payload(mesh, msg_bytes, np.int8)
    cache = C.CollectiveCache()
    bad, made = [], 0
    for a, (axis, size) in enumerate(mesh.shape.items()):
        ring = C.ring_edges(size)
        for hops in (1, chain):
            fn = cache.permute_chain(mesh, axis, ring, hops,
                                     transport="pallas_dma")
            got = fn(x)
            made += hops
            want = host
            for _ in range(hops):
                want = C.expected_permute(want, ring, axis=a)
            if not C.verify_against(got, want, mesh):
                bad.append((axis, hops))
    rt.barrier()
    launches = PD.launches["dma_permute"]
    rt.close()
    return {"bad": bad, "launches": launches, "made": made}
