"""The ring collective-matmuls of the overlap knobs against the JAX
reference: ``ring_allgather_matmul``, ``matmul_ring_reducescatter``,
``ring_all_to_all_matmul`` and ``matmul_ring_all_to_all``
(``tpu_p2p/parallel/collectives.py:344, :431, :488, :569``), the chunk
wave ``chunked_ppermute_compute`` on a line of a process mesh, and the
``CollectiveCache`` chains ``tp_ring_chain`` / ``ep_ring_chain`` /
``pp_wave_chain`` (:1357-1510).

The port's ranks run in one gloo world of 4 (``tests/
torch_overlap_world.py``, torch only) on lines of 2 (axis ``x`` of a 2x2
mesh), 4 and 1 (a size-1 axis: the degrade to ``compute_chunk(x, 0)``);
the parent runs the reference on its CPU devices over the same mesh from
the same seeded numpy inputs. Values and gradients are held to the
reference's own bound against the undecomposed product (rtol 1e-5,
``tests/test_pallas_dma.py:249``); the port's ``pallas_dma`` transport,
whose plain version (the compute, then gloo copies) runs here, is held
bitwise to its ``xla`` transport, as the reference pins its two
transports (``tests/test_pallas_dma.py:229-366``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from tpu_p2p.parallel import collectives as JC
from tpu_p2p_torch.parallel.launch import run_world

WORLD = os.path.join(os.path.dirname(__file__), "torch_overlap_world.py")
LINES = {"x2": ((2, 2), ("x", "y"), "x"), "d4": ((4,), ("d",), "d"),
         "z1": ((2, 2, 1), ("x", "y", "z"), "z")}
SIZE = {"x2": 2, "d4": 4, "z1": 1}
TOL = dict(rtol=1e-5, atol=1e-6)
PARTIAL = ((0, 1), (1, 2), (2, 3))


def ring_body(fn, axis, ins):
    """The reference's twin of ``torch_overlap_world.ring_body`` (its
    ``xla`` transport): one device's block ``ins`` along ``axis``."""
    if fn == "gather":
        return JC.ring_allgather_matmul(
            lambda c, s: (c @ ins["w"]) * jnp.asarray(s + 1, c.dtype),
            ins["x"], axis, gather_dim=1)
    if fn == "gather_src":
        return JC.ring_allgather_matmul(
            lambda c, s: c + jnp.asarray(s, c.dtype), ins["x"], axis,
            gather_dim=0)
    if fn == "rs":
        return JC.matmul_ring_reducescatter(
            lambda c, i: c @ ins["w"] + jnp.asarray(i, c.dtype), ins["x"],
            axis, chunk_dim=1)
    if fn == "a2a":
        return JC.ring_all_to_all_matmul(
            lambda c, s: c @ ins["w"] + jnp.asarray(s, c.dtype), ins["x"],
            axis, split_dim=0, concat_dim=1)
    if fn == "a2a_back":
        return JC.matmul_ring_all_to_all(
            lambda c, d: c @ ins["w"] + jnp.asarray(d, c.dtype), ins["x"],
            axis, split_dim=1, concat_dim=0)
    if fn == "wave":
        return JC.chunked_ppermute_compute(
            lambda c, i: c @ ins["w"], ins["x"], axis, ins["edges"],
            chunk_dim=0, chunks=ins["chunks"])
    raise ValueError(fn)


def _mesh(line):
    dims, names, axis = LINES[line]
    n = int(np.prod(dims))
    return Mesh(np.array(jax.devices()[:n]).reshape(dims), names), axis


def reference(case):
    """→ ``{"out": [4, *out]}`` (and ``"grads"``: name → ``[4, ...]``),
    or ``{"error": message}``."""
    mesh, axis = _mesh(case["line"])
    dims, names, _ = LINES[case["line"]]
    arrays = {k: v for k, v in case["ins"].items()
              if isinstance(v, np.ndarray)}
    static = {k: v for k, v in case["ins"].items() if k not in arrays}
    keys = sorted(arrays)
    lead = len(dims)
    spec = P(*names)

    def block(*vals):
        ins = {k: v.reshape(v.shape[lead:]) for k, v in zip(keys, vals)}
        y = ring_body(case["fn"], axis, {**ins, **static})
        return y.reshape((1,) * lead + y.shape)

    sm = jax.shard_map(block, mesh=mesh, in_specs=(spec,) * len(keys),
                       out_specs=spec)
    vals = [jnp.asarray(arrays[k].reshape(dims + arrays[k].shape[1:]))
            for k in keys]
    if "cot" not in case:
        try:
            out = np.asarray(jax.jit(sm)(*vals))
        except ValueError as e:
            return {"error": str(e)}
        return {"out": out.reshape((4,) + out.shape[lead:])}
    cot = jnp.asarray(case["cot"].reshape(dims + case["cot"].shape[1:]))

    @jax.jit
    def out_and_grads(*v):
        out, pull = jax.vjp(sm, *v)
        return out, pull(cot)

    out, grads = out_and_grads(*vals)
    out = np.asarray(out)
    return {"out": out.reshape((4,) + out.shape[lead:]),
            "grads": {k: np.asarray(g).reshape(arrays[k].shape)
                      for k, g in zip(keys, grads)}}


def _case(name, fn, line, ins, out_shape=None, transport="xla", seed=0):
    """A ring case: per-rank numpy inputs from ``ins`` (name → shape a
    rank, or a value passed as it is) and, with ``out_shape``, a
    cotangent for the gradient."""
    rng = np.random.default_rng(seed)
    c = {"name": name, "fn": fn, "line": line, "transport": transport,
         "ins": {k: (rng.standard_normal((4,) + v).astype(np.float32)
                     if isinstance(v, tuple) and k in ("x", "w") else v)
                 for k, v in ins.items()}}
    if out_shape is not None:
        c["cot"] = rng.standard_normal((4,) + out_shape).astype(np.float32)
    return c


def _cases():
    out = []
    for line, n in SIZE.items():
        out += [
            _case(f"gather_{line}", "gather", line,
                  {"x": (2, 3, 8), "w": (8, 5)}, (2, 3 * n, 5), seed=1),
            _case(f"rs_{line}", "rs", line,
                  {"x": (2, 3 * n, 8), "w": (8, 5)}, (2, 3, 5), seed=2),
            _case(f"a2a_{line}", "a2a", line,
                  {"x": (2 * n, 3, 8), "w": (8, 5)}, (2, 3 * n, 5), seed=3),
            _case(f"a2a_back_{line}", "a2a_back", line,
                  {"x": (2, 3 * n, 5), "w": (5, 8)}, (2 * n, 3, 8),
                  seed=4),
        ]
    for line in ("x2", "d4"):
        out.append(_case(f"gather_src_{line}", "gather_src", line,
                         {"x": (4, 3)}, seed=5))
    out.append(_case("rs_not_divisible", "rs", "d4",
                     {"x": (2, 13, 8), "w": (8, 5)}, seed=6))
    waves = {"wave_ring": ("d4", (8, 4), ((i, (i + 1) % 4)
                                          for i in range(4)), 2),
             "wave_partial_pad": ("d4", (7, 4), PARTIAL, 3),
             "wave_x2_pad": ("x2", (7, 4), ((0, 1), (1, 0)), 3)}
    for name, (line, shape, edges, chunks) in waves.items():
        out.append(_case(name, "wave", line,
                         {"x": shape, "w": (4, 4), "edges": tuple(edges),
                          "chunks": chunks}, shape, seed=7))
    return out


CASES = _cases()
# The port's pallas_dma transport on the same inputs (the reference pins
# its two transports equal, tests/test_pallas_dma.py:229-366).
PALLAS = [dict(c, name=c["name"] + "_pallas_dma", transport="pallas_dma")
          for c in CASES if c["fn"] in ("gather", "gather_src", "wave")
          and c["line"] != "z1"]


def _chain(name, chain, line, kw, elems=64, seed=8):
    rng = np.random.default_rng(seed)
    return {"name": name, "chain": chain, "line": line, "kw": kw,
            "payload": rng.standard_normal((4, elems)).astype(np.float32)}


CHAINS = [
    _chain("tp_ring_chain_x2", "tp_ring_chain", "x2",
           dict(count=2, k=8)),
    _chain("tp_ring_chain_d4", "tp_ring_chain", "d4",
           dict(count=2, k=8)),
    _chain("ep_ring_chain_x2", "ep_ring_chain", "x2",
           dict(count=2, k=8)),
    _chain("ep_ring_chain_d4", "ep_ring_chain", "d4",
           dict(count=2, k=8)),
    _chain("pp_wave_chain_d4", "pp_wave_chain", "d4",
           dict(count=5, chunks=3, k=8)),
    _chain("tp_ring_chain_z1", "tp_ring_chain", "z1",
           dict(count=2, k=8)),
]


@pytest.fixture(scope="module")
def world():
    res = run_world(4, f"{WORLD}:ring_case",
                    {"cases": CASES + PALLAS, "chains": CHAINS},
                    timeout=240)
    return res


def _assert_close(got, want, what):
    for r in range(4):
        np.testing.assert_allclose(got[r], want[r], err_msg=f"{what} rank {r}",
                                   **TOL)


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_ring_function_matches_reference(world, case):
    want = reference(case)
    got = [w[case["name"]] for w in world]
    if "error" in want:
        assert [g.get("error") for g in got] == [want["error"]] * 4
        return
    _assert_close([g["out"] for g in got], want["out"], case["name"])
    if "cot" in case:
        for k, g_want in want["grads"].items():
            _assert_close([g["grads"][k] for g in got], g_want,
                          f"{case['name']} d{k}")


@pytest.mark.parametrize("case", PALLAS, ids=[c["name"] for c in PALLAS])
def test_pallas_dma_transport_is_bitwise_the_xla_transport(world, case):
    xla = case["name"][:-len("_pallas_dma")]
    for r, w in enumerate(world):
        got, want = w[case["name"]], w[xla]
        np.testing.assert_array_equal(got["out"], want["out"],
                                      err_msg=f"rank {r}")
        for k in want.get("grads", {}):
            np.testing.assert_array_equal(got["grads"][k], want["grads"][k],
                                          err_msg=f"rank {r} d{k}")
    # The plain version ran: no kernel launches on the CPU.
    assert all(w["launches"] == {"dma_permute": 0, "dma_ship": 0}
               for w in world)


@pytest.mark.parametrize("chain", CHAINS, ids=[c["name"] for c in CHAINS])
def test_collective_cache_chain_matches_reference(world, chain):
    mesh, axis = _mesh(chain["line"])
    dims = LINES[chain["line"]][0]
    fn = getattr(JC.CollectiveCache(), chain["chain"])(mesh, axis,
                                                       **chain["kw"])
    want = np.asarray(fn(jnp.asarray(
        chain["payload"].reshape(dims + (-1,))))).reshape(4, -1)
    got = np.concatenate([w[chain["name"]] for w in world])
    np.testing.assert_allclose(got, want, **TOL)
    if chain["chain"] == "pp_wave_chain":
        # count = 5 hops of a 4-ring: every payload one stage on, through
        # identity products.
        np.testing.assert_array_equal(got, np.roll(chain["payload"], 1, 0))
