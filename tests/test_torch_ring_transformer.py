"""The port's RingTransformer (``tpu_p2p_torch/models/ring_transformer.py``)
against the JAX reference's (``tpu_p2p/models/ring_transformer.py``).

The seeded init and batch are bitwise the reference's, ``tiny`` gives
the same shapes, and the weight carry round-trips. The forward (with
``use_flash``: the reference's Pallas kernel in interpret mode, the
port's plain flash versions) and one SGD step on the five meshes of
``tests/test_model.py`` run in one gloo world of 8 ranks
(``tests/torch_ring_transformer_world.py``), from the same numpy params
and batches, against the reference's sharded forward and step on its
CPU devices, at the reference's own tolerances: forward 2e-5, loss
relative 1e-4, params atol 1e-5 / rtol 1e-4.
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding

from tpu_p2p.models import ring_transformer as JM
from tpu_p2p_torch.models import ring_transformer as TM
from tpu_p2p_torch.models.flagship_params import tensor_from_numpy
from tpu_p2p_torch.parallel.launch import run_world
from tpu_p2p_torch.parallel.runtime import Mesh as TMesh
from tpu_p2p_torch.parallel.runtime import PlacementError, local_shard

WORLD = os.path.join(os.path.dirname(__file__),
                     "torch_ring_transformer_world.py")
CFG = dict(batch=4, seq=32, heads=4, head_dim=8, mlp_mult=2,
           dtype="float32")
FLASH_CFG = dict(batch=2, seq=64, heads=4, head_dim=8, dtype="float32")
FWD_TOL = dict(atol=2e-5, rtol=2e-5)
LEAF = dict(atol=1e-5, rtol=1e-4)
LOSS_RTOL = 1e-4
LR = 1e-2
MESHES = [((2,), ("dp",)), ((4,), ("sp",)), ((2,), ("tp",)),
          ((2, 2), ("dp", "sp")), ((2, 2, 2), ("dp", "sp", "tp"))]
FLASH_MESHES = [((4,), ("sp",)), ((2, 2), ("dp", "sp")),
                ((2, 2, 2), ("dp", "sp", "tp"))]


def _jmesh(shape, axes):
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    return Mesh(devs, axes)


def _tmesh(shape, axes):
    """A port mesh object that only carries the layout (no groups)."""
    n = int(np.prod(shape))
    return TMesh(ranks=tuple(range(n)), rank=0, device=torch.device("cpu"),
                 host_group=None, axis_names=axes, dims=shape)


def _numpy_case(cfg_kw, seed=0):
    """The reference's params and batch as numpy, made once."""
    cfg = JM.ModelConfig(**cfg_kw)
    params = {k: np.array(v) for k, v in JM.init_params(cfg, seed).items()}
    x, t = (np.array(a) for a in JM.example_batch(cfg, seed=seed + 1))
    return params, (x, t)


def _case(kind, shape, axes, cfg_kw, **kw):
    params, batch = _numpy_case(cfg_kw)
    name = "_".join((kind, *(f"{a}{n}" for a, n in zip(axes, shape))))
    return {"name": name, "kind": kind, "shape": shape, "axes": axes,
            "cfg": cfg_kw, "params": params, "batch": batch, "lr": LR, **kw}


CASES = (
    [_case("forward", s, a, {**FLASH_CFG, "use_flash": True})
     for s, a in FLASH_MESHES]
    + [_case("step", s, a, CFG) for s, a in MESHES]
    + [_case("train", (2, 2), ("dp", "sp"), CFG, lr=0.5, steps=5)]
)


@pytest.fixture(scope="module")
def world():
    return run_world(8, f"{WORLD}:model_case", {"cases": CASES},
                     timeout=300)


def _reference(case):
    """The reference's forward output, or its losses and updated params,
    on its mesh of the case's shape, as numpy."""
    mesh = _jmesh(case["shape"], case["axes"])
    cfg = JM.ModelConfig(**case["cfg"])
    params = JM.place_params(
        {k: jnp.asarray(v) for k, v in case["params"].items()}, mesh)
    sharding = NamedSharding(mesh, JM.data_spec(mesh))
    x, t = (jax.device_put(jnp.asarray(a), sharding) for a in case["batch"])
    if case["kind"] == "forward":
        return np.asarray(JM.make_forward(mesh, cfg)(params, x))
    step = JM.make_train_step(mesh, cfg, lr=case["lr"])
    losses = []
    for _ in range(case.get("steps", 1)):
        params, loss = step(params, x, t)
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in params.items()}


def _block(a, res, spec):
    """Rank ``res``'s block of the global numpy ``a`` under ``spec``."""
    where = SimpleNamespace(shape=res["shape"], coords=res["coords"])
    return local_shard(a, where, spec)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_and_batch_are_the_references_bitwise(dtype):
    cfg_kw = {**CFG, "dtype": dtype}
    params, batch = _numpy_case(cfg_kw, seed=3)
    cfg = TM.ModelConfig(**cfg_kw)
    ours = TM.init_params(cfg, seed=3, device="cpu")
    assert list(ours) == list(params)
    for k, a in params.items():
        want = tensor_from_numpy(a, "cpu")
        assert ours[k].dtype == want.dtype and torch.equal(ours[k], want), k
    for got, a in zip(TM.example_batch(cfg, seed=4, device="cpu"),
                      batch):
        assert torch.equal(got, tensor_from_numpy(a, "cpu"))


def test_placement_defaults_to_the_card(monkeypatch):
    # Without a device or a mesh the model's tensors go to the rank's
    # card; with no card that is an error, never a quiet CPU fallback.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TM.ModelConfig(**CFG)
    params, _ = _numpy_case(CFG)
    for make in (lambda: TM.init_params(cfg),
                 lambda: TM.example_batch(cfg),
                 lambda: TM.params_from_reference(params, None)):
        with pytest.raises(PlacementError, match="CUDA device"):
            make()


@pytest.mark.parametrize("shape,axes", MESHES + [((2, 4), ("sp", "tp"))])
def test_tiny_equals_the_references(shape, axes):
    ref = JM.ModelConfig().tiny(_jmesh(shape, axes))
    ours = TM.ModelConfig().tiny(_tmesh(shape, axes))
    assert vars(ours) == vars(ref)
    assert ours.model_dim == ref.model_dim


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_reference_round_trips(dtype):
    params, _ = _numpy_case({**CFG, "dtype": dtype})
    ours = TM.params_from_reference(params, "cpu")
    for k, a in params.items():
        if dtype == "bfloat16":  # through the 16-bit patterns
            assert np.array_equal(ours[k].view(torch.int16).numpy(),
                                  a.view(np.int16)), k
        else:
            assert np.array_equal(ours[k].numpy(), a), k
    # On a mesh: each rank's shard is its block of the global leaf.
    mesh = _tmesh((2, 2), ("dp", "tp"))
    mesh.rank = 3  # coordinates (1, 1)
    shards = TM.params_from_reference(params, "cpu", mesh)
    specs = TM.param_specs(mesh)
    for k, a in params.items():
        want = local_shard(a, mesh, specs[k])
        assert shards[k].shape == want.shape
        assert torch.equal(shards[k], tensor_from_numpy(want, "cpu"))


@pytest.mark.parametrize("case", [c for c in CASES if c["kind"] == "forward"],
                         ids=lambda c: c["name"])
def test_flash_forward_matches_the_reference_on_mesh(world, case):
    want = _reference(case)
    name = case["name"]
    for r, got in enumerate(w[name] for w in world):
        spec = TM.data_spec(SimpleNamespace(axis_names=got["axes"]))
        np.testing.assert_allclose(got["out"], _block(want, got, spec),
                                   err_msg=f"{name} rank {r}", **FWD_TOL)


@pytest.mark.parametrize("case", [c for c in CASES if c["kind"] == "step"],
                         ids=lambda c: c["name"])
def test_sgd_step_matches_the_reference_on_mesh(world, case):
    (loss,), params = _reference(case)
    name = case["name"]
    for r, got in enumerate(w[name] for w in world):
        np.testing.assert_allclose(got["losses"], [loss], rtol=LOSS_RTOL,
                                   err_msg=f"{name} rank {r}")
        specs = TM.param_specs(SimpleNamespace(axis_names=got["axes"]))
        for k, a in params.items():
            np.testing.assert_allclose(
                got["params"][k], _block(a, got, specs[k]),
                err_msg=f"{name} rank {r} {k}", **LEAF)


def test_training_on_dp2_sp2_reduces_the_loss(world):
    case = next(c for c in CASES if c["kind"] == "train")
    want, _ = _reference(case)
    for r, w in enumerate(world):
        losses = w[case["name"]]["losses"]
        assert losses[-1] < losses[0], (r, losses)
        np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL)


def test_train_step_runs_without_the_flash_kernels(monkeypatch):
    # The reference's step runs with allow_flash=False: the port's step
    # with use_flash=True must not reach the flash path either.
    import tpu_p2p_torch.ops.ring_flash as RF

    def boom(*a, **kw):
        raise AssertionError("the train step reached ring flash")

    monkeypatch.setattr(RF, "ring_flash_attention", boom)
    cfg = TM.ModelConfig(**{**CFG, "use_flash": True})
    params, (x, t) = _numpy_case(CFG)
    one = _tmesh((1,), ("sp",))
    x, t = torch.from_numpy(x), torch.from_numpy(t)
    results = [TM.make_train_step(one, TM.ModelConfig(**kw), lr=LR)(
        TM.params_from_reference(params, "cpu"), x, t)
        for kw in ({**CFG, "use_flash": True}, CFG)]
    (new, loss), (plain_new, plain_loss) = results
    assert torch.equal(loss, plain_loss)
    for k in new:
        assert torch.equal(new[k], plain_new[k]), k
    with pytest.raises(AssertionError, match="reached ring flash"):
        TM.make_forward(one, cfg)(new, x)
