"""Tensor- and expert-parallel serving on the port against the JAX
reference: the ``LocalMesh`` collectives (rendezvous of in-process rank
threads) against the numpy oracles, teacher-forced decode and the paged
mixed step on the reference tests' meshes (``tests/test_decode.py``,
``tests/test_serve.py``), ZeRO-stored decode, the disaggregated engine
with a tensor-parallel prefill, and the ``serve --disagg`` CLI at its
default partition against the 8-device golden.

The reference runs in this process on its 8 simulated CPU devices; the
port runs on ``LocalMesh``es of CPU ranks over the same axes, one
thread a rank. Inputs are made once from a numpy seed and fed to both
sides; params come from the reference's ``init_flagship_params``
through ``params_from_numpy``. Port vs reference: within ``TOL`` (the
port's tolerance for float32 model code, ``tests/test_torch_model.py``)
of the largest reference value (:func:`_close`: the continuous decode's
outputs are un-normed activations up to ~90 in size, where float32
rounding alone is ~1e-5 absolute); paged vs the port's own dense
decode: bitwise on every mesh.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from test_cli_golden import mask_floats
from tpu_p2p.config import ServeConfig as JServeConfig
from tpu_p2p.models import decode as JD
from tpu_p2p.models import flagship as JF
from tpu_p2p.parallel import collectives as JC
from tpu_p2p.serve import disagg as JDis
from tpu_p2p.serve import engine as JE
from tpu_p2p.serve import paged_cache as JP
from tpu_p2p_torch.config import ServeConfig as TServeConfig
from tpu_p2p_torch.models import decode as TD
from tpu_p2p_torch.models import flagship as TF
from tpu_p2p_torch.parallel import collectives as TC
from tpu_p2p_torch.parallel.runtime import LocalMesh, RendezvousError
from tpu_p2p_torch.serve import disagg as TDis
from tpu_p2p_torch.serve import engine as TE
from tpu_p2p_torch.serve import paged_cache as TP

TOL = 1e-5
GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
AXES = JF.AXES  # (dp, pp, sp, tp, ep), on both sides


def _dims(dp=1, tp=1, ep=1):
    return (dp, 1, 1, tp, ep)


def _jmesh(dp=1, tp=1, ep=1):
    dims = _dims(dp, tp, ep)
    n = int(np.prod(dims))
    return Mesh(np.array(jax.devices()[:n]).reshape(dims), AXES)


def _tmesh(dp=1, tp=1, ep=1):
    dims = _dims(dp, tp, ep)
    return LocalMesh(("cpu",) * int(np.prod(dims)), AXES, dims)


def _close(got, want, what=""):
    """``got`` within ``TOL`` of ``want``, normalized by the largest
    ``|want|``: an L-inf bound on the error relative to the output's
    scale."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    scale = max(float(np.abs(want).max()), 1.0)
    assert err <= TOL * scale, f"{what}: max error {err} > {TOL} x {scale}"


def _carry(j_params):
    return TF.params_from_numpy(
        {k: np.asarray(v) for k, v in j_params.items()}, "cpu")


# ----------------------------------------------- LocalMesh collectives


def test_local_line_collectives_match_numpy_oracles():
    mesh = LocalMesh(("cpu",) * 8, ("dp", "tp", "ep"), (2, 2, 2))
    rng = np.random.default_rng(0)
    x = rng.integers(-50, 50, (8, 12)).astype(np.int32)
    xf = rng.standard_normal((8, 12)).astype(np.float32)

    def body(rank, row, rowf):
        out = {}
        for ax in ("dp", "tp", "ep"):
            line = rank.line(ax)
            out[ax] = (TC.psum(row, line).numpy(),
                       TC.axis_all_to_all(row, line, 0, 0).numpy(),
                       TC.axis_all_gather(row, line, 0).numpy(),
                       TC.psum_join(rowf, line).numpy())
        return out

    got = mesh.run(body, [torch.from_numpy(r) for r in x],
                   [torch.from_numpy(r) for r in xf])
    for ax in ("dp", "tp", "ep"):
        for i in range(8):
            members = mesh.line_members(ax, i)
            rows = x[list(members)]
            k = members.index(i)
            np.testing.assert_array_equal(
                got[i][ax][0], JC.expected_all_reduce(rows)[k])
            np.testing.assert_array_equal(
                got[i][ax][1], JC.expected_all_to_all(rows, 2)[k])
            np.testing.assert_array_equal(got[i][ax][2], rows.reshape(-1))
            # The float sum in line order, bitwise on every member.
            want = xf[members[0]] + xf[members[1]]
            np.testing.assert_array_equal(got[i][ax][3], want)
    # The all-gather's diagonal form, JC.expected_all_gather.
    own = mesh.run(lambda rank, row: TC.axis_all_gather(
        row.reshape(2, 6)[rank.line("tp").index], rank.line("tp"), 0),
        [torch.from_numpy(r) for r in x])
    for i in range(8):
        members = list(mesh.line_members("tp", i))
        np.testing.assert_array_equal(
            own[i].numpy(),
            JC.expected_all_gather(x[members])[members.index(i)])


def test_local_mesh_bucketed_gather_is_the_tiled_gather_and_fails_fast():
    mesh = LocalMesh(("cpu",) * 4, ("dp",))
    full = torch.arange(4 * 6 * 3, dtype=torch.float32).reshape(12, 6)
    got = mesh.run(lambda rank, s: TC.bucketed_all_gather(
        {"a": (s, 0), "b": (s.t().contiguous(), 1)}, rank.line("dp")),
        list(full.chunk(4, 0)))
    for g in got:
        assert torch.equal(g["a"], full) and torch.equal(g["b"], full.t())
    # Its backward is the summing reduce-scatter: rank i scales the
    # gathered tensor by i + 1, so every shard's gradient is 1 + 2 + 3 + 4.

    def grads(rank, s):
        s = s.clone().requires_grad_(True)
        out = TC.bucketed_all_gather({"a": (s, 0)}, rank.line("dp"))
        (out["a"] * (rank.index + 1)).sum().backward()
        return s.grad

    for g in mesh.run(grads, list(full.chunk(4, 0))):
        assert torch.equal(g, torch.full((3, 6), 10.0))
    # A rank that raises breaks its peers' rendezvous: its own error
    # comes back, nobody hangs, and the mesh serves again afterwards.

    def bad(rank):
        if rank.index == 2:
            raise KeyError("rank 2 fails")
        return TC.psum(torch.ones(1), rank.line("dp"))

    with pytest.raises(KeyError, match="rank 2 fails"):
        mesh.run(bad)
    assert [t.item() for t in mesh.run(
        lambda rank: TC.psum(torch.ones(1), rank.line("dp")))] == [4.0] * 4
    slow = LocalMesh(("cpu",) * 2, ("dp",), timeout=0.2)
    with pytest.raises(RendezvousError, match="did not arrive"):
        slow.run(lambda rank: TC.psum(torch.ones(1), rank.line("dp")),
                 ranks=[0])
    with pytest.raises(ValueError, match="process mesh"):
        slow.run(lambda rank: TC.all_to_all(torch.ones(2), slow))


def test_local_mesh_rendezvous_under_thread_stress():
    # More rank threads than cores, the interpreter switching threads as
    # often as it can: every exchange must see every peer's value of that
    # exchange (a slot overwritten too early, or a lost deposit, breaks
    # the sums), and every rank must finish within the mesh's timeout.
    import sys
    import time

    n, rounds = 16, 60
    mesh = LocalMesh(("cpu",) * n, ("dp", "tp"), (4, 4), timeout=60.0)

    def body(rank):
        out = []
        for r in range(rounds):
            x = torch.tensor([float(rank.index * 1000 + r)])
            ax = ("dp", "tp")[r % 2]
            line = rank.line(ax)
            out.append((ax, TC.psum(x, line).item(),
                        [t.item() for t in line.all_gather(x)]))
        return out

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.monotonic()
        got = mesh.run(body)
        assert time.monotonic() - t0 < 60.0
    finally:
        sys.setswitchinterval(old)
    for i, rows in enumerate(got):
        for r, (ax, total, gathered) in enumerate(rows):
            members = mesh.line_members(ax, i)
            want = [float(m * 1000 + r) for m in members]
            assert gathered == want and total == sum(want), (i, r)


# ------------------------------------------------------------- decode

def _decode_cfg(**kw):
    # tests/test_decode.py::_cfg: no-drop MoE capacity.
    base = dict(batch=8, seq=8, heads=4, head_dim=8, stages=2,
                microbatches=2, num_experts=2, capacity_factor=2.0)
    base.update(kw)
    return base


_DECODE = {
    "single": (dict(), {}),
    "dp2tp2ep2": (dict(dp=2, tp=2, ep=2), {}),
    "dp4tp2": (dict(dp=4, tp=2), {}),
    "gqa_tp2": (dict(tp=2), dict(heads=8, kv_heads=2, microbatches=1)),
    "zero_dp4": (dict(dp=4), dict(zero_dp=True)),
}


@pytest.mark.parametrize("name", sorted(_DECODE))
def test_teacher_forced_decode_matches_reference(name):
    mesh_kw, cfg_kw = _DECODE[name]
    kw = _decode_cfg(**cfg_kw)
    jcfg, tcfg = JF.FlagshipConfig(**kw), TF.FlagshipConfig(**kw)
    jmesh, tmesh = _jmesh(**mesh_kw), _tmesh(**mesh_kw)
    seeded = JF.init_flagship_params(jcfg)
    x = np.random.default_rng(7).standard_normal(
        (jcfg.batch, jcfg.seq, jcfg.model_dim)).astype(np.float32)
    jstep = JD.make_flagship_decode_step(jmesh, jcfg)
    jcache = JD.init_kv_cache(jcfg, max_len=jcfg.seq, mesh=jmesh)
    jparams = JF.place_flagship_params(seeded, jmesh, jcfg)
    tstep = TD.make_flagship_decode_step(tmesh, tcfg)
    tcache = TD.init_kv_cache(tcfg, tcfg.seq, mesh=tmesh)
    tparams = TF.place_local_params(_carry(seeded), tmesh, tcfg)
    if cfg_kw.get("heads") == 8:
        assert tcache[0]["k"].shape[2] == 1      # 2 KV heads over tp 2
    if cfg_kw.get("zero_dp"):
        assert any(tparams[0][k].numel() < np.asarray(v).size
                   for k, v in seeded.items())   # ZeRO-stored shards
    xt = torch.from_numpy(x)
    for t in range(jcfg.seq):
        jcache, jy = jstep(jparams, jcache, jnp.asarray(x[:, t:t + 1]), t)
        tcache, ty = tstep(tparams, tcache,
                           TD.split_rows(tmesh, xt[:, t:t + 1]), t)
        _close(TD.join_rows(tmesh, ty).numpy(), jy, f"position {t}")
        # tp peers hold the same bits.
        for i in range(tmesh.size):
            lead = TD.lead_ranks(tmesh)[TD.rank_shard(tmesh, i)]
            assert torch.equal(ty[i], ty[lead])


def test_zero_stored_decode_is_bitwise_the_replicated_decode():
    kw = _decode_cfg()
    seeded = _carry(JF.init_flagship_params(JF.FlagshipConfig(**kw)))
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (8, 4, 32)).astype(np.float32))
    outs = []
    for zero in (False, True):
        cfg = TF.FlagshipConfig(**kw, zero_dp=zero)
        mesh = _tmesh(dp=4)
        step = TD.make_flagship_decode_step(mesh, cfg)
        params = TF.place_local_params(seeded, mesh, cfg)
        if zero:
            assert any(params[0][k].numel() < seeded[k].numel()
                       for k in seeded)
        cache = TD.init_kv_cache(cfg, 8, mesh=mesh)
        ys = []
        for t in range(4):
            cache, y = step(params, cache,
                            TD.split_rows(mesh, x[:, t:t + 1]), t)
            ys.append(TD.join_rows(mesh, y))
        outs.append(torch.cat(ys, 1))
    assert torch.equal(outs[0], outs[1])


def test_decode_rejects_sp_or_pp_mesh_and_indivisible_heads():
    kw = _decode_cfg()
    for dims, msg in (((1, 1, 2, 1, 1), "sp axis size 1"),
                      ((1, 2, 1, 1, 1), "pp axis size 1")):
        mesh = LocalMesh(("cpu",) * 2, AXES, dims)
        with pytest.raises(ValueError, match=msg) as got:
            TD.make_flagship_decode_step(mesh, TF.FlagshipConfig(**kw))
        jmesh = Mesh(np.array(jax.devices()[:2]).reshape(dims), AXES)
        with pytest.raises(ValueError) as want:
            JD.make_flagship_decode_step(jmesh, JF.FlagshipConfig(**kw))
        assert str(got.value) == str(want.value)
    kw = _decode_cfg(heads=8, kv_heads=2, microbatches=1)
    with pytest.raises(ValueError, match="kv_heads"):
        TD.init_kv_cache(TF.FlagshipConfig(**kw), 8, mesh=_tmesh(tp=4))


# --------------------------------------------------------- paged step

def _serve_cfg(**kw):
    # tests/test_serve.py::_cfg: the no-drop MoE LM.
    base = dict(batch=8, seq=16, heads=4, head_dim=8, stages=2,
                microbatches=1, num_experts=2, capacity_factor=2.0,
                vocab=64, norm=True, rope=True)
    base.update(kw)
    return base


def _tables(pool, batch, max_blocks, n_shards):
    tables = np.zeros((batch, max_blocks), np.int32)
    per = batch // n_shards
    for b in range(batch):
        tables[b] = [pool.alloc(b // per) for _ in range(max_blocks)]
    return tables


def _teacher_force(mesh_kw, kw, chunk, T=16, page_len=8, max_blocks=2):
    """tests/test_serve.py::_teacher_force on both sides → (reference
    paged logits, port dense logits, port paged logits), each [B, T,
    V]."""
    jcfg, tcfg = JF.FlagshipConfig(**kw), TF.FlagshipConfig(**kw)
    jmesh, tmesh = _jmesh(**mesh_kw), _tmesh(**mesh_kw)
    n_shards = TP.pool_shards(tmesh)
    assert n_shards == JP.pool_shards(jmesh)
    seeded = JF.init_flagship_params(jcfg)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (8, T))
    num_pages = n_shards * (8 // n_shards * max_blocks + 1)
    table = _tables(TP.PagePool(num_pages, page_len, n_shards), 8,
                    max_blocks, n_shards)

    def chunks():
        pos = 0
        while pos < T:
            n = min(chunk, T - pos)
            tk = np.zeros((8, chunk), np.int64)
            tk[:, :n] = toks[:, pos:pos + n]
            yield pos, n, tk
            pos += n

    # The reference's paged step.
    jstep = JP.make_paged_lm_step(jmesh, jcfg, page_len=page_len,
                                  max_blocks=max_blocks, chunk=chunk)
    jpool = JP.init_paged_pool(jcfg, num_pages, page_len, jmesh)
    jparams = JF.place_flagship_params(seeded, jmesh)
    want = np.zeros((8, T, jcfg.vocab), np.float32)
    for pos, n, tk in chunks():
        jpool, lg = jstep(jparams, jpool, jnp.asarray(tk, jnp.int32),
                          jnp.full((8,), pos, jnp.int32),
                          jnp.full((8,), n, jnp.int32), jnp.asarray(table))
        want[:, pos:pos + n] = np.asarray(lg)[:, :n]
    # The port: dense decode, then the paged step, on the same mesh.
    params = TF.place_local_params(_carry(seeded), tmesh, tcfg)
    dstep = TD.make_flagship_lm_decode_step(tmesh, tcfg)
    cache = TD.init_kv_cache(tcfg, T, mesh=tmesh)
    dense = []
    for t in range(T):
        cache, lg = dstep(params, cache, TD.split_rows(
            tmesh, torch.from_numpy(toks[:, t:t + 1])), t)
        dense.append(TD.join_rows(tmesh, lg)[:, 0])
    dense = torch.stack(dense, 1).numpy()
    pstep = TP.make_paged_lm_step(tmesh, tcfg, page_len=page_len,
                                  max_blocks=max_blocks, chunk=chunk)
    pools = TP.init_paged_pool(tcfg, num_pages, page_len, mesh=tmesh)
    heads = tcfg.num_kv_heads // tmesh.shape["tp"]
    assert [tuple(p["k"].shape) for p in pools] == [
        (2, num_pages // n_shards, heads, page_len, 8)] * tmesh.size
    got = np.zeros_like(want)
    split = lambda a: TD.split_rows(tmesh, torch.from_numpy(a))  # noqa
    for pos, n, tk in chunks():
        pools, lg = pstep(params, pools, split(tk),
                          split(np.full(8, pos)), split(np.full(8, n)),
                          split(table))
        got[:, pos:pos + n] = TD.join_rows(tmesh, lg).numpy()[:, :n]
    return want, dense, got


_PAGED = {"single": dict(), "tp2": dict(tp=2), "dp2ep2": dict(dp=2, ep=2),
          "dp2tp2ep2": dict(dp=2, tp=2, ep=2)}


@pytest.mark.parametrize("name", sorted(_PAGED))
def test_paged_decode_bitwise_vs_dense_and_close_to_reference(name):
    want, dense, got = _teacher_force(_PAGED[name], _serve_cfg(), chunk=1)
    np.testing.assert_array_equal(got, dense)
    _close(got, want, name)


@pytest.mark.parametrize("name", ["tp2", "dp2ep2"])
def test_chunked_prefill_close_to_dense_and_reference(name):
    want, dense, got = _teacher_force(_PAGED[name], _serve_cfg(), chunk=4)
    _close(got, dense, f"{name} vs the port's dense decode")
    _close(got, want, f"{name} vs the reference")


def test_paged_step_and_pool_refuse_bad_meshes():
    kw = _serve_cfg(heads=8, kv_heads=2)
    with pytest.raises(ValueError, match="kv_heads"):
        TP.make_paged_lm_step(_tmesh(tp=4), TF.FlagshipConfig(**kw),
                              page_len=8, max_blocks=2, chunk=1)
    with pytest.raises(ValueError, match="dp×ep shard"):
        TP.init_paged_pool(TF.FlagshipConfig(**kw), 9, 8,
                           mesh=_tmesh(dp=2, ep=2))
    step = TP.make_paged_lm_step(_tmesh(dp=2, tp=2, ep=2),
                                 TF.FlagshipConfig(**_serve_cfg()),
                                 page_len=8, max_blocks=2, chunk=1)
    # Shards 0-1 sit on dp 0, 2-3 on dp 1; the ep line meets, so an
    # active shard brings its whole dp coordinate (tp and ep peers).
    assert step.ranks_for([]) == []
    assert step.ranks_for([1]) == [0, 1, 2, 3]
    assert step.ranks_for([2, 3]) == [4, 5, 6, 7]
    assert step.threads


# ------------------------------------------- disagg with a tp prefill

def test_build_disagg_meshes_equals_reference_for_every_prefill_tp():
    jdev = jax.devices()
    for n in range(2, 9):
        for tp in range(0, n):
            jpre, jdec, jmig = JDis.build_disagg_meshes(tp,
                                                        devices=jdev[:n])
            pre, dec, mig = TDis.build_disagg_meshes(tp, ["cpu"] * n)
            for j, t in ((jpre, pre), (jdec, dec), (jmig, mig)):
                assert t.shape == dict(zip(j.axis_names, j.devices.shape))
            # The submeshes are the mig mesh's ranks: the same streams.
            assert pre.streams + dec.streams == mig.streams


def _disagg_kw(**kw):
    # tests/test_serve_disagg.py::_sc at 2 decode replicas, the prefill
    # on 2 tp ranks.
    base = dict(slots=4, page_len=8, num_pages=2 * (2 * 3 + 1),
                max_blocks=3, chunk=4, requests=5, seed=0, rate=1.0,
                prompt_len=(4, 12), gen_len=(4, 8), vocab=64, disagg=True,
                prefill_slots=2, prefill_pages=(2 + 4) * 3 + 1,
                prefill_tp=2)
    base.update(kw)
    return base


_DIS_CFG = dict(batch=4, seq=16, heads=4, kv_heads=2, head_dim=8,
                stages=2, microbatches=1, num_experts=2,
                capacity_factor=2.0, vocab=64, norm=True, rope=True,
                dense_ffn=True)

_DIS_SUMMARY = ("requests", "steps", "idle_steps", "prompt_tokens",
                "gen_tokens", "shed", "preemptions", "kv_migrated",
                "kv_migrate_blocks", "kv_migrate_bytes",
                "migrate_wait_steps_p50", "migrate_wait_steps_max")


@pytest.fixture(scope="module")
def disagg_reference():
    """The reference's disagg run at prefill tp 2 over 4 devices, and the
    seeded weights."""
    cfg = JF.FlagshipConfig(**_DIS_CFG)
    seeded = JF.init_flagship_params(cfg)
    sc = JServeConfig(**_disagg_kw())
    pre, dec, mig = JDis.build_disagg_meshes(2, devices=jax.devices()[:4])
    assert dict(zip(pre.axis_names, pre.devices.shape)) == {"dp": 1,
                                                            "tp": 2}
    run = JDis.run_disagg_engine(
        pre, dec, mig, cfg, JF.place_flagship_params(seeded, pre),
        JF.place_flagship_params(seeded, dec), JE.synthetic_trace(sc),
        sc=sc)
    return seeded, run


@pytest.mark.parametrize("transport,chunks", [
    ("xla", 1), ("pallas_dma", 1), ("pallas_dma", 3)])
def test_disagg_tp2_prefill_streams_bitwise_vs_reference(
        disagg_reference, transport, chunks):
    from tpu_p2p_torch.parallel import pallas_dma as TPD

    seeded, want = disagg_reference
    sc = TServeConfig(**_disagg_kw(transport=transport,
                                   migrate_chunks=chunks))
    _, _, mig = TDis.build_disagg_meshes(2, ["cpu"] * 4)
    TPD.reset_launches()
    got = TDis.run_disagg_engine(mig, TF.FlagshipConfig(**_DIS_CFG),
                                 _carry(seeded), TE.synthetic_trace(sc),
                                 sc=sc)
    assert TPD.launches == {"dma_permute": 0, "dma_ship": 0}  # plain
    streams = {r.rid: list(r.generated) for r in got["finished"]}
    assert streams == {r.rid: list(r.generated) for r in want["finished"]}
    for key in _DIS_SUMMARY:
        assert got[key] == want[key], key
    assert got["migrate_events"] == want["migrate_events"]
    b = got["batcher"]
    assert [tuple(p["k"].shape) for p in b.pre_pools] \
        == [(2, sc.prefill_pages, 1, 8, 8)] * 2      # a KV head a rank
    assert b.pool_p.available(0) == b.pool_p.capacity
    assert all(b.pool_d.available(d) == b.pool_d.capacity
               for d in range(2))
    # Migration bytes are the tp 1 run's (1 prefill + the same 2 decode
    # replicas): full heads, whatever the split.
    one = TServeConfig(**_disagg_kw(prefill_tp=1))
    _, _, mig1 = TDis.build_disagg_meshes(1, ["cpu"] * 3)
    got1 = TDis.run_disagg_engine(mig1, TF.FlagshipConfig(**_DIS_CFG),
                                  _carry(seeded), TE.synthetic_trace(one),
                                  sc=one)
    assert got1["kv_migrate_bytes"] == got["kv_migrate_bytes"]
    assert {r.rid: list(r.generated) for r in got1["finished"]} == streams


def test_kv_migrator_joins_head_slices_from_tp_prefill_ranks():
    cfg = TF.FlagshipConfig(**{**_DIS_CFG, "heads": 8, "kv_heads": 4})
    rng = np.random.default_rng(0)
    full = {k: torch.from_numpy(rng.standard_normal(
        (2, 9, 4, 8, 8)).astype(np.float32)) for k in ("k", "v")}
    for transport in ("xla", "pallas_dma"):
        for chunks in (1, 3):
            _, _, mig = TDis.build_disagg_meshes(2, ["cpu"] * 4)
            pre = [{k: full[k][:, :, 2 * i:2 * i + 2].clone()
                    for k in full} for i in range(2)]
            dec = [{k: torch.full((2, 5, 4, 8, 8), 7.0) for k in "kv"}
                   for _ in range(2)]
            m = TDis.KvMigrator(mig, cfg, page_len=8, transport=transport,
                                chunks=chunks, n_prefill=2)
            m.migrate(pre, [4, 2, 7], dec, [3, 1, 2], 1)
            for k in "kv":
                assert torch.equal(dec[1][k][:, [3, 1, 2]],
                                   full[k][:, [4, 2, 7]])
                assert torch.equal(dec[0][k][:, 0],
                                   torch.zeros(2, 4, 8, 8))
                assert torch.equal(dec[0][k][:, 1:],
                                   torch.full((2, 4, 4, 8, 8), 7.0))
            assert m.block_bytes(3) == 3 * 2 * 2 * 4 * 8 * 8 * 4


# ---------------------------------------------------------------- CLI


def test_serve_disagg_cli_over_eight_ranks_matches_golden(capsys):
    assert TE.main(["--device", "cpu", "--cpu-mesh", "8", "--disagg",
                    "--requests", "6", "--seed", "0"]) == 0
    got = mask_floats(capsys.readouterr().out).splitlines()
    want = (GOLDEN / "cli_serve_disagg_8dev.txt").read_text().splitlines()
    want_head, got_head = "serve mesh disagg ", "serve device cpu disagg "
    assert want[0].startswith(
        want_head + "prefill {'dp': 1, 'tp': 4} + decode {'dp': 4}")
    assert got[0].startswith(got_head)
    got[0] = want_head + got[0][len(got_head):]
    assert got == want


@pytest.mark.parametrize("disagg", [False, True], ids=["colocated",
                                                       "disagg"])
def test_serve_trace_cli_writes_a_valid_chrome_trace(disagg, tmp_path,
                                                     capsys):
    from tpu_p2p.obs import trace as JT
    from tpu_p2p_torch.obs import trace as TT

    path, jsonl = tmp_path / "serve.json", tmp_path / "serve.jsonl"
    args = ["--device", "cpu", "--cpu-mesh", "4", "--requests", "5",
            "--trace", str(path), "--obs-jsonl", str(jsonl)]
    assert TE.main(args + (["--disagg"] if disagg else [])) == 0
    out = capsys.readouterr().out.splitlines()
    assert TT.validate_chrome_trace(str(path)) == []
    obj = TT.load_obs_records(str(jsonl))
    import json

    with open(path) as fh:
        trace = json.load(fh)
    assert out[-1] == (f"# wrote chrome trace {path} "
                       f"({len(trace['traceEvents'])} events)")
    # The reference's exporter on the same records writes the same
    # trace, bar the exporter's name.
    want = JT.write_chrome_trace(str(tmp_path / "ref.json"),
                                 obs_records=obj, meta={"source": "serve"})
    trace["otherData"].pop("exporter")
    want["otherData"].pop("exporter")
    assert trace == want
    lanes = {e["tid"] for e in trace["traceEvents"]
             if e["pid"] == TT.PID_SERVE and e["ph"] == "X"}
    assert lanes and len([e for e in trace["traceEvents"]
                          if e["ph"] == "X"]) >= 5 * 2
    if disagg:
        assert any(e["name"].startswith("migrate_wait")
                   for e in trace["traceEvents"])
