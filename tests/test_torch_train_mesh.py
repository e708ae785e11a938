"""The port's ``train`` across a world of ranks against the JAX
reference: ``python -m tpu_p2p_torch train --cpu-mesh 8`` against the
reference's ``run_training`` on ``build_mesh(8)`` or the mesh
``--mesh-shape`` names (same flags and seed: losses to relative 1e-4,
the same record keys; one case trains the MoE FFN with its experts split
over ep 2, two run the tp ring and the pp wave), the flags still not
ported, the five-axis runtime (lines, planes, groups), the placement of
params and batches against the reference's shardings, and the refusal
of a multi-rank step on ranks that share a card (NCCL needs a card a
rank), pinned on the CPU before any traffic.
"""

import io
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding

from tpu_p2p import train as JT
from tpu_p2p.models import flagship as JF
from tpu_p2p_torch import train as TT
from tpu_p2p_torch.models import flagship as TF
from tpu_p2p_torch.ops.ring_flash import ring_flash_attention
from tpu_p2p_torch.parallel import collectives as C
from tpu_p2p_torch.parallel.launch import run_world
from tpu_p2p_torch.parallel.runtime import Mesh
from tpu_p2p_torch.utils.data import DeviceLoader
from tpu_p2p_torch.utils.errors import BackendError

REPO = pathlib.Path(__file__).resolve().parents[1]
WORLD = os.path.join(os.path.dirname(__file__), "torch_flagship_world.py")
LOSS_RTOL = 1e-4
SHAPE = ["--batch", "4", "--seq", "32", "--heads", "4", "--kv-heads", "2",
         "--head-dim", "8", "--stages", "2", "--microbatches", "2",
         "--dense-ffn", "--steps", "4", "--log-every", "2"]
MOE_SHAPE = [a for a in SHAPE if a != "--dense-ffn"]
CLI_CASES = {  # name -> the full flag list
    "ring_lm_flash": SHAPE + ["--rope", "--norm", "--vocab", "64",
                              "--flash"],
    "zigzag_lm_flash": SHAPE + ["--sp-strategy", "ring_zigzag", "--rope",
                                "--vocab", "64", "--flash"],
    "ulysses_mse": SHAPE + ["--sp-strategy", "ulysses", "--norm"],
    # The MoE FFN (no --dense-ffn) on pp 2 x sp 2 x ep 2: the experts
    # split over ep, GPipe's bubble ticks routed too.
    "moe_ep2_lm_flash": MOE_SHAPE + ["--mesh-shape", "1x2x2x1x2", "--rope",
                                     "--norm", "--vocab", "64", "--flash"],
}


def _reference_records(argv):
    """The reference's ``run_training`` on the mesh the flags name (its
    ``build_mesh(8)`` without ``--mesh-shape``, the port's own flag) with
    the config the same flags give → (records, summary)."""
    argv = list(argv)
    dims = None
    if "--mesh-shape" in argv:
        i = argv.index("--mesh-shape")
        dims = tuple(int(d) for d in argv[i + 1].split("x"))
        del argv[i:i + 2]
    args = JT._build_parser().parse_args(argv)
    mesh = (JF.build_mesh(8) if dims is None
            else JMesh(np.array(jax.devices()[:8]).reshape(dims), JF.AXES))
    cfg = JF.FlagshipConfig(
        batch=args.batch, seq=args.seq, heads=args.heads,
        kv_heads=args.kv_heads, head_dim=args.head_dim, stages=args.stages,
        microbatches=args.microbatches, vocab=args.vocab,
        sp_strategy=args.sp_strategy, use_flash=args.flash, norm=args.norm,
        dense_ffn=args.dense_ffn, rope=args.rope,
        tp_overlap=args.tp_overlap, ep_overlap=args.ep_overlap,
        pp_overlap=args.pp_overlap, pp_chunks=args.pp_chunks)
    buf = io.StringIO()
    out = JT.run_training(mesh, cfg, steps=args.steps,
                          log_every=args.log_every, log_stream=buf)
    out.pop("params")
    return [json.loads(s) for s in buf.getvalue().splitlines()], out


# The overlap knobs on 8 ranks: the tp ring on dp 2 x sp 2 x tp 2, the
# wave on build_mesh(8)'s pp 2 in 3 chunks of T_local 16 (padded).
OVERLAP_CASES = {
    "tp_overlap": SHAPE + ["--mesh-shape", "2x1x2x2x1", "--norm",
                           "--tp-overlap", "ring"],
    "pp_overlap": SHAPE + ["--pp-overlap", "wave", "--pp-chunks", "3"],
}


@pytest.mark.parametrize("name", sorted(CLI_CASES))
def test_train_cpu_mesh_cli_matches_reference(name):
    _assert_cli_matches_reference(CLI_CASES[name])


@pytest.mark.parametrize("name", sorted(OVERLAP_CASES))
def test_train_cpu_mesh_cli_runs_the_overlap_knobs(name):
    _assert_cli_matches_reference(OVERLAP_CASES[name])


def _assert_cli_matches_reference(argv):
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_p2p_torch", "train", "--cpu-mesh", "8",
         "--device", "cpu", *argv], capture_output=True, text=True,
        cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(s) for s in proc.stdout.splitlines()]
    got, summary = lines[:-1], lines[-1]["summary"]   # rank 0 alone prints
    want, want_summary = _reference_records(argv)
    assert [list(r) for r in got] == [list(r) for r in want]
    assert [r["step"] for r in got] == [r["step"] for r in want] == [2, 4]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL)
    assert list(summary) == list(want_summary)
    assert summary["steps_run"] == want_summary["steps_run"] == 4
    np.testing.assert_allclose(summary["final_loss"],
                               want_summary["final_loss"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("argv,what", [
    (["--pp-schedule", "zb"], "--pp-schedule"),
    (["--tick-lowering", "switch"], "--tick-lowering"),
], ids=["pp_schedule", "tick_lowering"])
def test_train_cpu_mesh_still_rejects_what_is_not_ported(argv, what,
                                                         capfd):
    # The knobs are ported (the tick-IR executor runs them); the loop's
    # GPipe step refuses them on every rank with the reference's own
    # error and exit code, as the reference's loop does.
    from tpu_p2p.models.flagship_steps import _reject_zb_schedule

    assert TT.main(["--cpu-mesh", "8", *SHAPE, *argv]) == 1
    kw = {"--pp-schedule": {"pp_schedule": "zb"},
          "--tick-lowering": {"tick_lowering": "switch"}}[what]
    with pytest.raises(ValueError) as want:
        _reject_zb_schedule(JF.FlagshipConfig(**kw))
    err = capfd.readouterr().err
    assert f"Failed: ValueError '{want.value}'" in err


def test_bad_mesh_shape_fails_fast(capsys):
    assert TT.main(["--device", "cpu", "--mesh-shape", "2x2", *SHAPE]) == 1
    assert "--mesh-shape must look like" in capsys.readouterr().err


# ------------------------------------------------------ the runtime


MESH_SHAPES = [(2, 2, 2, 1, 1), (1, 2, 1, 2, 2)]


@pytest.fixture(scope="module")
def mesh_world():
    return run_world(8, f"{WORLD}:mesh_case", {"shapes": MESH_SHAPES},
                     timeout=120)


@pytest.mark.parametrize("dims", MESH_SHAPES, ids=str)
def test_five_axis_runtime_forms_lines_and_planes(mesh_world, dims):
    grid = np.arange(8).reshape(dims)
    data = [TF.AXES.index(a) for a in ("dp", "sp", "ep")]
    want_groups = {tuple(range(8))}
    for r, got in enumerate(mesh_world):
        g = got[tuple(dims)]
        where = tuple(int(i) for i in np.argwhere(grid == r)[0])
        assert g["coords"] == dict(zip(TF.AXES, where))
        for a, name in enumerate(TF.AXES):
            index = list(where)
            index[a] = slice(None)
            line = tuple(int(x) for x in grid[tuple(index)])
            assert g["lines"][name] == line
            # A size-1 axis gets no group and launches nothing.
            assert g["line_groups"][name] == (dims[a] > 1)
            if dims[a] > 1:
                want_groups.add(line)
        index = [slice(None) if a in data else where[a] for a in range(5)]
        plane = tuple(int(x) for x in grid[tuple(index)].reshape(-1))
        assert g["plane"] == tuple(sorted(plane))
        want_groups.add(tuple(sorted(plane)))
    for got in mesh_world:
        assert set(got[tuple(dims)]["groups"]) == want_groups


# -------------------------------------------- placement and batches


def _hand_mesh(dims, rank, device="cpu"):
    """A mesh seen from ``rank`` with no groups: enough to place shards
    (placement reads the layout only)."""
    return Mesh(ranks=tuple(range(int(np.prod(dims)))), rank=rank,
                device=torch.device(device), host_group=None,
                axis_names=TF.AXES, dims=tuple(dims))


@pytest.mark.parametrize("dims", [(2, 2, 2, 1, 1), (1, 2, 1, 2, 2),
                                  (2, 1, 2, 1, 2), (1, 1, 2, 2, 2)], ids=str)
def test_shards_equal_the_reference_shardings(dims):
    kw = dict(batch=8, seq=32, heads=4, kv_heads=2, head_dim=8, stages=2,
              dense_ffn=True, norm=True, vocab=64, dtype="float32")
    jcfg = JF.FlagshipConfig(**kw)
    jmesh = JMesh(np.array(jax.devices()[:8]).reshape(dims), JF.AXES)
    params = JF.init_flagship_params(jcfg, seed=0)
    placed = JF.place_flagship_params(params, jmesh, jcfg)
    host = {k: np.asarray(v) for k, v in params.items()}
    toks = np.random.default_rng(0).integers(0, 64, (8, 33)).astype(np.int32)
    x = np.random.default_rng(1).standard_normal((8, 32, 32)).astype(
        np.float32)
    tok_j = jax.device_put(jnp.asarray(toks[:, :-1]),
                           NamedSharding(jmesh, JF._lm_token_spec(jmesh)))
    x_j = jax.device_put(jnp.asarray(x),
                         NamedSharding(jmesh, JF.flagship_data_spec(jmesh)))
    devices = list(jmesh.devices.reshape(-1))
    for rank in range(8):
        mesh = _hand_mesh(dims, rank)
        ours = TF.place_flagship_params(host, mesh)
        dev = devices[rank]
        for k, v in placed.items():
            shard = next(s for s in v.addressable_shards if s.device == dev)
            np.testing.assert_array_equal(ours[k].numpy(),
                                          np.asarray(shard.data), err_msg=k)
        loader = DeviceLoader(iter([(toks[:, :-1], x)]), "cpu", mesh=mesh,
                              spec=TF.flagship_data_spec(mesh))
        tok_t, x_t = next(loader)
        for got, arr in ((tok_t, tok_j), (x_t, x_j)):
            shard = next(s for s in arr.addressable_shards
                         if s.device == dev)
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(shard.data))


# ------------------------------------- ranks sharing a card: refused


def _shared_card_mesh(dims):
    """Rank 0 of a mesh whose ranks share cuda:0: every line and plane of
    size > 1 has a host group (a stand-in) and no NCCL group."""
    mesh = _hand_mesh(dims, 0, device="cuda:0")
    for a in TF.AXES:
        size = mesh.shape[a]
        mesh.planes[(a,)] = Mesh(ranks=tuple(range(size)), rank=0,
                                 device=mesh.device,
                                 host_group=object() if size > 1 else None,
                                 axis_names=(a,))
    data = tuple(a for a in TF.AXES if a in ("dp", "sp", "ep"))
    size = int(np.prod([mesh.shape[a] for a in data]))
    mesh.planes[data] = Mesh(ranks=tuple(range(size)), rank=0,
                             device=mesh.device, host_group=object(),
                             axis_names=("+".join(data),))
    return mesh


@pytest.fixture
def no_traffic(monkeypatch):
    calls = []
    for fn in ("all_reduce", "all_to_all_single", "batch_isend_irecv",
               "all_gather", "isend", "irecv"):
        monkeypatch.setattr(torch.distributed, fn,
                            lambda *a, _n=fn, **k: calls.append(_n))
    yield calls
    assert calls == []


def test_axis_collectives_on_a_shared_card_raise_before_traffic(no_traffic):
    line = _shared_card_mesh((1, 1, 2, 1, 1)).line("sp")
    x = torch.zeros(2, 4, 4, 8, requires_grad=True)
    for what, fn in (
            ("psum_join", lambda: C.psum_join(x, line)),
            ("all_to_all", lambda: C.axis_all_to_all(x, line, 1, 2)),
            ("ppermute", lambda: C.axis_ppermute(x, line, [(0, 1), (1, 0)])),
            ("ring attention", lambda: ring_flash_attention(x, x, x, line,
                                                            True)),
            ("the gradient all-reduce",
             lambda: C.all_reduce_flat([x.detach()], line,
                                       "the gradient all-reduce"))):
        with pytest.raises(BackendError, match=f"{what} is an NCCL"):
            fn()
    y = C.psum_conjugate(x, line)   # the identity forward: no traffic
    with pytest.raises(BackendError, match="psum_conjugate is an NCCL"):
        y.sum().backward()


@pytest.mark.parametrize("dims", [(2, 1, 1, 1, 1), (1, 2, 1, 1, 1),
                                  (1, 1, 1, 2, 1)], ids=["dp", "pp", "tp"])
def test_mesh_step_on_a_shared_card_raises_backend_error(no_traffic, dims):
    cfg = TF.FlagshipConfig(batch=4, seq=16, heads=4, head_dim=8, stages=2,
                            microbatches=2, dense_ffn=True, vocab=32)
    mesh = _shared_card_mesh(dims)
    params = TF.place_flagship_params(
        TF.init_flagship_params(cfg, seed=0, device="cpu"),
        _hand_mesh(dims, 0))  # CPU tensors: the step's plain versions
    toks, tgts = TF.flagship_token_batch(cfg, seed=1)
    b = cfg.batch // mesh.shape["dp"]
    step = TF.make_flagship_lm_train_step(cfg, mesh=mesh)
    with pytest.raises(BackendError, match="needs one card per rank"):
        step(params, toks[:b], tgts[:b])
