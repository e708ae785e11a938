"""The fused ship (``dma_ship_compute``) and the chunk wave
(``chunked_ppermute_compute``) of the port against the JAX reference.

The port runs on a ``LocalMesh`` of 4 CPU ranks (every rank in this
process, one tensor per rank), so its wrappers take their plain
versions; the reference runs the same per-rank inputs on 4 devices of
the CPU mesh, through ``collectives._shard_map_unchecked`` with its
Pallas kernels in interpret mode (as ``tests/test_pallas_dma.py`` runs
them). Inputs are integer-valued float32, so every product and sum is
exact: arrivals and computed values must be bitwise equal. Gradients
are held at the reference's own tolerance for the fused ship
(``test_fused_ship_compute_gradients_match_xla_ring``: rtol = atol =
1e-6).
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from tpu_p2p.parallel import collectives as JC
from tpu_p2p.parallel import pallas_dma as JPD
from tpu_p2p_torch.parallel import collectives as TC
from tpu_p2p_torch.parallel import pallas_dma as TPD
from tpu_p2p_torch.parallel.launch import run_world
from tpu_p2p_torch.parallel.runtime import LocalMesh

N = 4
WORLD = str(pathlib.Path(__file__).with_name("test_torch_p2p_world.py"))
GRAD_TOL = 1e-6  # tests/test_pallas_dma.py:320-321
EDGE_SETS = {    # tests/test_pallas_dma.py:101, cut to 4 ranks
    "ring": JC.ring_edges(N),
    "shift3": JC.ring_edges(N, shift=3),
    "unidir": ((2, 1),),
    "bidir": ((1, 3), (3, 1)),
    "partial": ((0, 1), (3, 2)),
    "empty": (),
}


def _ints(rng, *shape):
    """Integer-valued float32: products and sums stay exact."""
    return rng.integers(-4, 5, shape).astype(np.float32)


@pytest.fixture(scope="module")
def jmesh():
    return Mesh(np.array(jax.devices()[:N]), ("tp",))


@pytest.fixture(scope="module")
def tmesh():
    return LocalMesh(["cpu"] * N, ("tp",))


def _rows(a):
    """``[N, ...]`` numpy → per-rank torch tensors."""
    return [torch.from_numpy(np.ascontiguousarray(r)) for r in a]


def _stack(rows):
    return np.stack([r.detach().numpy() for r in rows])


def _grads(leaves):
    """Each leaf's gradient; a leaf no arrival depends on (a rank with
    only a dummy outgoing edge) has none, which is zero."""
    return np.stack([(t.grad if t.grad is not None
                      else torch.zeros_like(t)).numpy() for t in leaves])


def _jax_ship(jmesh, edges, ship, w):
    """The reference's fused ship on each rank: ``(arrived, c @ w)``."""
    def body(s, c, ws):
        arr, y = JPD.dma_ship_compute(s[0], "tp", edges,
                                      lambda a, b: jnp.dot(a, b), c[0],
                                      ws[0])
        return arr[None], y[None]

    spec = P("tp")
    f = jax.jit(JC._shard_map_unchecked(body, jmesh, (spec, spec, spec),
                                        (spec, spec)))
    arr, y = f(ship, ship * 2, w)
    return np.asarray(arr), np.asarray(y)


# ------------------------------------------------------- the fused ship


@pytest.fixture(scope="module")
def ship_case():
    rng = np.random.default_rng(0)
    return _ints(rng, N, 6, 4), _ints(rng, N, 4, 3)


@pytest.mark.parametrize("name", sorted(EDGE_SETS))
def test_dma_ship_compute_bitwise_vs_reference(jmesh, tmesh, ship_case,
                                               name):
    ship, w = ship_case
    edges = EDGE_SETS[name]
    want_arr, want_y = _jax_ship(jmesh, edges, ship, w)
    arr, y = TPD.dma_ship_compute(_rows(ship), tmesh, edges,
                                  lambda a, b: a @ b,
                                  [r * 2 for r in _rows(ship)], _rows(w))
    np.testing.assert_array_equal(_stack(arr), want_arr)
    np.testing.assert_array_equal(_stack(y), want_y)
    np.testing.assert_array_equal(
        want_arr, JC.expected_permute(ship, edges))


def test_dma_ship_compute_int8_and_bf16_payloads(tmesh):
    # The dtypes the ship carries: int8 of the benchmark payloads (136 B,
    # not a multiple of any vector width) and a bf16 KV chunk.
    for rows in ([TC.make_payload(_Rank(i), 136, np.int8)[0]
                  for i in range(N)],
                 [torch.randn(2, 1, 2, 3, 8).to(torch.bfloat16)
                  for _ in range(N)]):
        edges = EDGE_SETS["partial"]
        arr, y = TPD.dma_ship_compute(rows, tmesh, edges, lambda a: a + 1,
                                      rows)
        want = JC.expected_permute(
            np.stack([r.float().numpy() for r in rows]), edges)
        np.testing.assert_array_equal(np.stack([a.float().numpy()
                                                for a in arr]), want)
        assert all(a.dtype == rows[0].dtype for a in arr)
        assert all(torch.equal(yi, r + 1) for yi, r in zip(y, rows))


class _Rank:
    """The ``mesh.index`` view ``make_payload`` needs."""

    def __init__(self, i):
        self.index, self.device = i, torch.device("cpu")


def _ring_grads(jmesh, ship, w):
    """The reference's gradients of ``sum(3 arrived^2) + sum(y^2)`` for
    the fused ship over the ring with ``y = ship @ w``, per rank."""
    edges = EDGE_SETS["ring"]

    def jloss(s, ws):
        arr, y = JPD.dma_ship_compute(s[0], "tp", edges,
                                      lambda a, b: jnp.dot(a, b), s[0],
                                      ws[0])
        return jnp.sum(arr * arr * 3) + jnp.sum(y * y)

    spec = P("tp")
    f = jax.jit(JC._shard_map_unchecked(
        lambda s, ws: jax.grad(jloss, argnums=(0, 1))(s, ws), jmesh,
        (spec, spec), (spec, spec)))
    return tuple(np.asarray(a) for a in f(ship, w))


def test_dma_ship_compute_gradients_vs_reference(jmesh, tmesh, ship_case):
    ship, w = ship_case
    edges = EDGE_SETS["ring"]
    want_ds, want_dw = _ring_grads(jmesh, ship, w)
    xs = [r.requires_grad_(True) for r in _rows(ship)]
    ws = [r.requires_grad_(True) for r in _rows(w)]
    arr, y = TPD.dma_ship_compute(xs, tmesh, edges, lambda a, b: a @ b,
                                  xs, ws)
    loss = sum((a * a * 3).sum() + (b * b).sum() for a, b in zip(arr, y))
    loss.backward()
    np.testing.assert_allclose(_grads(xs), want_ds,
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    np.testing.assert_allclose(_grads(ws), want_dw,
                               rtol=GRAD_TOL, atol=GRAD_TOL)


def test_plain_versions_launch_nothing(tmesh, ship_case):
    TPD.reset_launches()
    ship, w = ship_case
    TPD.dma_ship_compute(_rows(ship), tmesh, EDGE_SETS["ring"],
                         lambda a: a, _rows(ship))
    TPD.dma_ppermute(_rows(ship), tmesh, EDGE_SETS["ring"])
    assert TPD.launches == {"dma_permute": 0, "dma_ship": 0}


def test_local_mesh_validates_rows(tmesh):
    x = [torch.zeros(3)] * (N - 1)
    with pytest.raises(ValueError, match="4 per-rank tensors"):
        TPD.dma_ppermute(x, tmesh, ())
    with pytest.raises(ValueError, match="shape or dtype"):
        TPD.dma_ship_compute([torch.zeros(3)] * 3 + [torch.zeros(4)],
                             LocalMesh(["cpu"] * N), (), lambda: None)
    with pytest.raises(ValueError, match="duplicate"):
        TPD.dma_ppermute([torch.zeros(3)] * N, tmesh, ((0, 1), (2, 1)))


# ---------------------------------------------------------- the wave

_WAVES = {                     # tests/test_pallas_dma.py:282-285, 290
    "ring_divisible": (JC.ring_edges(N), 2, 8),
    "partial_padding": (((0, 1), (1, 2), (2, 3)), 3, 7),
    "chunks_one": (JC.ring_edges(N), 1, 4),
    "unidir_more_chunks_than_rows": (((3, 0),), 5, 3),
}


@pytest.fixture(scope="module")
def wave_inputs():
    rng = np.random.default_rng(2)
    return {name: (_ints(rng, N, t, 4), _ints(rng, 4, 4))
            for name, (_, _, t) in _WAVES.items()}


@pytest.fixture(scope="module")
def wave_reference(jmesh, wave_inputs):
    """The reference wave over pallas_dma (interpret mode), per case."""
    out = {}
    for name, (edges, chunks, _) in _WAVES.items():
        x, w = wave_inputs[name]
        wj = jnp.asarray(w)

        def f(xs, edges=edges, chunks=chunks):
            return JC.chunked_ppermute_compute(
                lambda c, i: jnp.dot(c, wj) + i, xs[0], "tp", edges,
                chunk_dim=0, chunks=chunks, transport="pallas_dma")[None]

        sm = JC._shard_map_unchecked(f, jmesh, P("tp"), P("tp"))
        out[name] = np.asarray(jax.jit(sm)(x))
    return out


@pytest.mark.parametrize("transport", ["pallas_dma", "xla"])
@pytest.mark.parametrize("name", sorted(_WAVES))
def test_chunked_ppermute_compute_bitwise_vs_reference(
        tmesh, wave_inputs, wave_reference, name, transport):
    # The compute closes over a constant weight and uses the chunk
    # index, so chunk order and the zero padding both show.
    edges, chunks, _ = _WAVES[name]
    x, w = wave_inputs[name]
    wt = torch.from_numpy(w)
    got = TC.chunked_ppermute_compute(
        lambda c, i: c @ wt + i, _rows(x), tmesh, edges, chunk_dim=0,
        chunks=chunks, transport=transport)
    np.testing.assert_array_equal(_stack(got), wave_reference[name])


def test_chunked_ppermute_compute_gradients_vs_reference(jmesh, tmesh):
    # One weight shared by every rank: the reference holds it replicated
    # and hands back each rank's share of its gradient, the port sums
    # the shares in the one tensor.
    rng = np.random.default_rng(4)
    x, w = _ints(rng, N, 7, 4), _ints(rng, 4, 4)
    edges = ((0, 1), (1, 2), (2, 3))

    def jloss(xs, ws):
        y = JC.chunked_ppermute_compute(
            lambda c, i: jnp.dot(c, ws), xs[0], "tp", edges,
            chunk_dim=0, chunks=3, transport="pallas_dma")
        return jnp.sum(y * y)

    def grads(xs, ws):
        dx, dw = jax.grad(jloss, argnums=(0, 1))(xs, ws)
        return dx, dw[None]

    f = jax.jit(JC._shard_map_unchecked(grads, jmesh, (P("tp"), P()),
                                        (P("tp"), P("tp"))))
    want_dx, want_dw = (np.asarray(a) for a in f(x, w))
    for transport in ("pallas_dma", "xla"):
        xs = [r.requires_grad_(True) for r in _rows(x)]
        wt = torch.from_numpy(w).requires_grad_(True)
        y = TC.chunked_ppermute_compute(
            lambda c, i: c @ wt, xs, tmesh, edges, chunk_dim=0, chunks=3,
            transport=transport)
        sum((t * t).sum() for t in y).backward()
        np.testing.assert_allclose(_grads(xs), want_dx,
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=transport)
        np.testing.assert_allclose(wt.grad.numpy(), want_dw.sum(0),
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=transport)


def test_local_ppermute_matches_expected_permute(tmesh):
    x = np.arange(N * 5, dtype=np.float32).reshape(N, 5)
    for edges in EDGE_SETS.values():
        got = TC.ppermute(_rows(x), tmesh, edges)
        np.testing.assert_array_equal(_stack(got),
                                      JC.expected_permute(x, edges))


def test_ship_and_wave_on_a_process_mesh_vs_reference(jmesh, ship_case,
                                                      wave_inputs,
                                                      wave_reference):
    # The same functions with one process a rank (a gloo world of 4, the
    # plain versions over send/recv): arrivals, y and the wave bitwise
    # the reference's, the gradient at its tolerance.
    ship, w = ship_case
    name = "partial_padding"
    edges, chunks, _ = _WAVES[name]
    x, ww = wave_inputs[name]
    res = run_world(N, f"{WORLD}:cpu_ship_case",
                    dict(sets=EDGE_SETS, ship=ship, w=w, wave_x=x, wave_w=ww,
                         wave_edges=edges, chunks=chunks), timeout=240)
    for ename, eset in EDGE_SETS.items():
        want_arr, want_y = _jax_ship(jmesh, eset, ship, w)
        np.testing.assert_array_equal(np.stack([r[ename][0] for r in res]),
                                      want_arr, err_msg=ename)
        np.testing.assert_array_equal(np.stack([r[ename][1] for r in res]),
                                      want_y, err_msg=ename)
    for transport in ("pallas_dma", "xla"):
        np.testing.assert_array_equal(
            np.stack([r[f"wave_{transport}"] for r in res]),
            wave_reference[name], err_msg=transport)
    arr_grads = _ring_grads(jmesh, ship, w)
    np.testing.assert_allclose(np.stack([r["grads"][0] for r in res]),
                               arr_grads[0], rtol=GRAD_TOL, atol=GRAD_TOL)
    np.testing.assert_allclose(np.stack([r["grads"][1] for r in res]),
                               arr_grads[1], rtol=GRAD_TOL, atol=GRAD_TOL)
