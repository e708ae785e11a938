"""The port's disaggregated serving (``serve --disagg``) against the JAX
reference (``tpu_p2p/serve/disagg.py``).

Sizes are the reference tests' (``tests/test_serve_disagg.py:54-66``:
vocab 64, page_len 8, 2 blocks, 3-block window). The port runs its
ranks on a ``LocalMesh`` of CPU ranks (the plain versions of every
kernel), 1 prefill + 1 or + 3 decode replicas; the reference runs the
same traces on 2 or 4 devices of the CPU mesh with ``prefill_tp=1``.

- Host logic (mesh partition, config validation, pool identity, the dry
  two-sided scheduler) must be equal to the reference's exactly, event
  for event.
- Engine runs use float32 and one set of weights made by the reference
  and carried over: every token stream must be bitwise the reference's
  disaggregated streams over ``xla`` and the colocated engine's, over
  both of the port's transports and with the migration cut into 1 and 3
  chunks (3 does not divide page_len 8: padded rows ride the wave), and
  the summary counts must be equal.
- The CLI's output must equal the reference's after
  ``tests/test_cli_golden.py::mask_floats``, except the title line, whose
  head names the mesh (``serve mesh``) in the reference and the device
  (``serve device cpu``) in the port, and which names the transport.

The reference's runs are made once per module.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from test_cli_golden import mask_floats
from tpu_p2p.config import ServeConfig as JServeConfig
from tpu_p2p.models import flagship as JF
from tpu_p2p.serve import batcher as JB
from tpu_p2p.serve import disagg as JD
from tpu_p2p.serve import engine as JE
from tpu_p2p.serve.paged_cache import PagePool as JPagePool
from tpu_p2p_torch.config import ServeConfig as TServeConfig
from tpu_p2p_torch.models import flagship as TF
from tpu_p2p_torch.parallel import pallas_dma as TPD
from tpu_p2p_torch.serve import batcher as TB
from tpu_p2p_torch.serve import disagg as TD
from tpu_p2p_torch.serve import engine as TE
from tpu_p2p_torch.serve.paged_cache import OutOfPages, PagePool

REPO = pathlib.Path(__file__).resolve().parents[1]


def _sc_kw(n_dec, **kw):
    """tests/test_serve_disagg.py::_sc, as keyword arguments."""
    base = dict(slots=2 * n_dec, page_len=8, num_pages=0, max_blocks=3,
                chunk=4, requests=5, seed=0, rate=1.0, prompt_len=(4, 12),
                gen_len=(4, 8), vocab=64, disagg=True, prefill_slots=2)
    base.update(kw)
    if not base["num_pages"]:
        base["num_pages"] = n_dec * (base["slots"] // n_dec
                                     * base["max_blocks"] + 1)
    if not base.get("prefill_pages"):
        base["prefill_pages"] = (base["prefill_slots"]
                                 + base["slots"]) * base["max_blocks"] + 1
    return base


def _tight_kw(n_dec, **kw):
    """tests/test_serve_disagg.py::_tight_decode_sc: 3 usable decode
    pages a shard against 3-block worst requests, so two worst-case
    occupants of a shard must preempt."""
    base = dict(slots=2 * n_dec, num_pages=4 * n_dec, requests=8,
                rate=3.0, gen_len=(6, 8), prefill_slots=3)
    base.update(kw)
    return _sc_kw(n_dec, **base)


def _cfg_kw():
    """tests/test_serve_disagg.py::_cfg(1, dense_ffn=True)."""
    return dict(batch=4, seq=16, heads=4, kv_heads=2, head_dim=8,
                stages=2, microbatches=1, num_experts=2,
                capacity_factor=2.0, vocab=64, norm=True, rope=True,
                dense_ffn=True)


def _trace_pair(kw):
    jt = JE.synthetic_trace(JServeConfig(**kw))
    tt = TE.synthetic_trace(TServeConfig(**kw))
    assert [(r.rid, r.arrival_step, r.max_new, r.prompt.tolist())
            for r in jt] == [(r.rid, r.arrival_step, r.max_new,
                              r.prompt.tolist()) for r in tt]
    return jt, tt


def _streams(out):
    return {r.rid: list(r.generated) for r in out["finished"]}


# ----------------------------------------------------- partition


def test_build_disagg_meshes_partition_and_messages():
    pre, dec, mig = TD.build_disagg_meshes(1, ["cpu"] * 4)
    assert (pre.size, dec.size, mig.size) == (1, 3, 4)
    assert mig.axis_names == ("mig",) and mig.ranks == (0, 1, 2, 3)
    pre, dec, mig = TD.build_disagg_meshes(0, ["cpu"] * 2)  # auto = 1
    assert (pre.size, dec.size) == (1, 1)
    jdev = jax.devices()
    for tp, n in ((8, 8), (9, 8), (1, 1)):
        with pytest.raises(ValueError) as want:
            JD.build_disagg_meshes(tp, devices=jdev[:n])
        with pytest.raises(ValueError) as got:
            TD.build_disagg_meshes(tp, ["cpu"] * n)
        assert str(got.value) == str(want.value)
    # Tensor-parallel prefill: the partition equals the reference's,
    # the auto value included (half the devices).
    for tp, n in ((2, 4), (0, 4), (3, 4), (4, 8), (0, 8)):
        jpre, jdec, jmig = JD.build_disagg_meshes(tp, devices=jdev[:n])
        pre, dec, mig = TD.build_disagg_meshes(tp, ["cpu"] * n)
        for j, t in ((jpre, pre), (jdec, dec), (jmig, mig)):
            assert t.shape == dict(zip(j.axis_names, j.devices.shape))


@pytest.mark.parametrize("bad", [
    dict(transport="carrier_pigeon"), dict(migrate_chunks=0),
    dict(prefill_slots=0), dict(prefill_tp=-1), dict(prefill_pages=-1),
])
def test_serve_config_disagg_validation_matches_reference(bad):
    kw = _sc_kw(2, **bad)
    with pytest.raises(ValueError) as want:
        JServeConfig(**kw)
    with pytest.raises(ValueError) as got:
        TServeConfig(**kw)
    assert str(got.value) == str(want.value)


# --------------------------------------------------- pool identity


def test_pool_identity_in_messages_and_defaults():
    p, d = PagePool(8, 8, 1, name="prefill"), PagePool(8, 8, 1,
                                                     name="decode")
    jp = JPagePool(8, 8, 1, name="prefill")
    assert PagePool(8, 8, 1).name == "kv"
    for _ in range(p.capacity):
        p.alloc(0)
        jp.alloc(0)
    for pool, jpool in ((p, jp),):
        with pytest.raises(OutOfPages) as got:
            pool.alloc(0)
        with pytest.raises(Exception) as want:
            jpool.alloc(0)
        assert str(got.value) == str(want.value)
        assert "'prefill'" in str(got.value)
    with pytest.raises(OutOfPages, match="'decode'"):
        d.alloc_n(d.capacity + 1, 0)
    with pytest.raises(ValueError, match="'decode'"):
        d.free([1], 0)
    with pytest.raises(RuntimeError, match="'prefill'"):
        p.clamp_capacity(1)


def test_disagg_batcher_distinguishes_pool_exhaustion():
    kw = _sc_kw(1, num_pages=3, prompt_len=(4, 4), gen_len=(4, 4))
    b = TD.DisaggBatcher(
        None, None, None, slots=kw["slots"],
        prefill_slots=kw["prefill_slots"], page_len=8,
        num_pages=kw["num_pages"], prefill_pages=kw["prefill_pages"],
        max_blocks=3, chunk=4, dry=True, n_decode_shards=1)
    b.submit(TB.Request(rid=0, prompt=np.zeros(20, np.int32), max_new=4))
    with pytest.raises(ValueError, match="decode shard"):
        b.step()
    with pytest.raises(ValueError, match="VALUE-driven"):
        TD.DisaggBatcher(None, None, None, slots=2, prefill_slots=1,
                         page_len=8, num_pages=8, prefill_pages=8,
                         max_blocks=3, chunk=4, dry=True,
                         n_decode_shards=1, spec_k=2)


# --------------------------------------------- dry schedule twin

_DRY = {   # the reference tests' traces (test_serve_disagg.py)
    "event_exact": (lambda: _sc_kw(2, requests=6, rate=1.5, seed=3), 2,
                    {}),
    "preempt": (lambda: _tight_kw(2), 2, {}),
    "fifo_waits": (lambda: _sc_kw(1, slots=1, prefill_slots=3,
                                  requests=4, rate=4.0, num_pages=4), 1,
                   {}),
    "deadline": (lambda: _sc_kw(1, slots=1, prefill_slots=1, requests=6,
                                rate=6.0, deadline_steps=4, num_pages=4),
                 1, {"deadline_steps": 4}),
    "eos_queue": (lambda: _sc_kw(2, requests=8, rate=3.0, seed=4), 2,
                  {"stop": "eos", "stop_seed": 4, "eos_prob": 0.3,
                   "queue_depth": 2}),
}


def _life(reqs):
    return [(r.rid, r.enqueue_step, r.prefill_start_step,
             r.first_token_step, r.prefill_done_step, r.migrate_step,
             r.migrate_wait_steps, r.decode_shard, r.migrations,
             r.migrated_blocks, r.finish_step, r.preempt_steps,
             r.preempt_recover_steps, r.outcome, r.shed_step, r.pool,
             len(r.generated)) for r in reqs]


def _events_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["step"] == w["step"]
        assert g["migrations"] == w["migrations"]
        for k in ("p_pos", "p_n", "p_tables", "d_pos", "d_n", "d_tables"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(_DRY))
def test_simulate_disagg_schedule_event_exact_vs_reference(name):
    make, n_dec, extra = _DRY[name]
    kw = make()
    jt, tt = _trace_pair(kw)
    geo = dict(slots=kw["slots"], prefill_slots=kw["prefill_slots"],
               page_len=8, num_pages=kw["num_pages"],
               prefill_pages=kw["prefill_pages"], max_blocks=3, chunk=4,
               n_decode_shards=n_dec, **extra)
    want = JD.simulate_disagg_schedule(
        jt, cfg=JF.FlagshipConfig(**_cfg_kw()), **geo)
    got = TD.simulate_disagg_schedule(
        tt, cfg=TF.FlagshipConfig(**_cfg_kw()), **geo)
    for key in ("steps", "busy_steps", "idle_steps", "migrations",
                "kv_migrate_bytes", "migrate_events", "preempt_events"):
        assert got[key] == want[key], key
    _events_equal(got["events"], want["events"])
    assert _life(got["requests"]) == _life(want["requests"])
    assert _life(got["shed"]) == _life(want["shed"])
    assert got["migrations"] > 0
    if name == "preempt":
        assert got["preempt_events"]
    if name in ("deadline", "eos_queue"):
        assert got["shed"]


# ------------------------------------------------------- the engine

_ENGINE = {       # name: (n_dec, ServeConfig overrides)
    "1+1": (1, {}),
    "1+3": (3, {}),
    "1+3_preempt": (3, "tight"),
    "1+1_shed_eos": (1, dict(requests=8, rate=4.0, queue_depth=3,
                             deadline_steps=3, stop="eos",
                             eos_prob=0.3)),
}
_SUMMARY = ("requests", "steps", "idle_steps", "prompt_tokens",
            "gen_tokens", "shed", "preemptions", "preempt_recover_steps",
            "kv_migrated", "kv_migrate_blocks", "kv_migrate_bytes",
            "migrate_wait_steps_p50", "migrate_wait_steps_max")


def _engine_kw(name):
    n_dec, extra = _ENGINE[name]
    return n_dec, (_tight_kw(n_dec) if extra == "tight"
                   else _sc_kw(n_dec, **extra))


@pytest.fixture(scope="module")
def weights():
    """One set of weights, made by the reference, for both sides."""
    cfg = JF.FlagshipConfig(**_cfg_kw())
    return cfg, JF.init_flagship_params(cfg)


@pytest.fixture(scope="module")
def reference(weights):
    """Per engine case: the reference's disagg run over xla (1 prefill
    + n_dec decode devices), its records and its colocated streams."""
    cfg, seeded = weights
    out = {}
    for name in _ENGINE:
        n_dec, kw = _engine_kw(name)
        sc = JServeConfig(**kw)
        trace = JE.synthetic_trace(sc)
        pre, dec, mig = JD.build_disagg_meshes(
            1, devices=jax.devices()[:1 + n_dec])
        recs = []
        run = JD.run_disagg_engine(
            pre, dec, mig, cfg, JF.place_flagship_params(seeded, pre),
            JF.place_flagship_params(seeded, dec), trace, sc=sc,
            emit=recs.append)
        mesh = JE.serve_mesh(1)
        sc_co = dataclasses.replace(
            sc, disagg=False, slots=4, num_pages=4 * sc.max_blocks + 1,
            prefill_pages=0)
        co = JE.run_engine(mesh, cfg, JF.place_flagship_params(seeded,
                                                               mesh),
                           trace, sc=sc_co, mode="continuous")
        out[name] = (run, recs, _streams(co))
    return out


_REC_FIELDS = ("id", "prompt_tokens", "output_tokens", "enqueue_step",
               "prefill_start_step", "first_token_step", "finish_step",
               "outcome", "shed_step", "preemptions", "pool",
               "prefill_done_step", "migrate_step", "migrate_wait_steps",
               "decode_shard", "migrations", "migrated_blocks")


@pytest.mark.parametrize("chunks", [1, 3])
@pytest.mark.parametrize("transport", ["xla", "pallas_dma"])
@pytest.mark.parametrize("name", sorted(_ENGINE))
def test_disagg_streams_bitwise_vs_reference_and_colocated(
        weights, reference, name, transport, chunks):
    cfg_j, seeded = weights
    n_dec, kw = _engine_kw(name)
    sc = TServeConfig(**{**kw, "transport": transport,
                         "migrate_chunks": chunks})
    want, want_recs, colocated = reference[name]
    trace = TE.synthetic_trace(sc)
    params = TF.params_from_numpy({k: np.asarray(v)
                                   for k, v in seeded.items()}, "cpu")
    _, _, mig = TD.build_disagg_meshes(1, ["cpu"] * (1 + n_dec))
    recs = []
    TPD.reset_launches()
    got = TD.run_disagg_engine(mig, TF.FlagshipConfig(**_cfg_kw()),
                               params, trace, sc=sc, emit=recs.append)
    assert TPD.launches == {"dma_permute": 0, "dma_ship": 0}  # plain
    assert _streams(got) == _streams(want)
    assert _streams(got) == {rid: toks for rid, toks in colocated.items()
                             if rid in _streams(got)}
    assert got["requests"] + got["shed"] == sc.requests
    for key in _SUMMARY:
        assert got[key] == want[key], key
    assert got["migrate_events"] == want["migrate_events"]
    _events_equal(got["events"], want["events"])
    assert [r["obs"] for r in recs] == [r["obs"] for r in want_recs]
    for g, w in zip(recs, want_recs):
        if g["obs"] == "request":
            assert {k: g.get(k) for k in _REC_FIELDS} \
                == {k: w.get(k) for k in _REC_FIELDS}
    b = got["batcher"]
    assert b.pool_p.available(0) == b.pool_p.capacity
    assert all(b.pool_d.available(d) == b.pool_d.capacity
               for d in range(n_dec))
    if name == "1+3_preempt":
        assert got["preemptions"] > 0
        assert all(r.migrations >= 2 for r in got["finished"]
                   if r.preemptions)
    if name == "1+1_shed_eos":
        assert got["shed"] > 0


def test_disagg_engine_dry_twin_is_event_exact(weights):
    _, seeded = weights
    kw = _sc_kw(3, requests=6, rate=1.5, seed=3)
    sc = TServeConfig(**{**kw, "transport": "pallas_dma",
                         "migrate_chunks": 3})
    trace = TE.synthetic_trace(sc)
    cfg = TF.FlagshipConfig(**_cfg_kw())
    _, _, mig = TD.build_disagg_meshes(1, ["cpu"] * 4)
    got = TD.run_disagg_engine(
        mig, cfg, TF.params_from_numpy(
            {k: np.asarray(v) for k, v in seeded.items()}, "cpu"),
        trace, sc=sc)
    dry = TD.simulate_disagg_schedule(
        trace, slots=sc.slots, prefill_slots=sc.prefill_slots,
        page_len=8, num_pages=sc.num_pages,
        prefill_pages=sc.prefill_pages, max_blocks=3, chunk=4,
        n_decode_shards=3, cfg=cfg)
    assert dry["steps"] == got["steps"]
    _events_equal(got["events"], dry["events"])
    assert dry["migrate_events"] == got["migrate_events"]
    assert dry["kv_migrate_bytes"] == got["kv_migrate_bytes"]
    assert {e["dst_shard"] for e in got["migrate_events"]} == {0, 1, 2}


def test_kv_migrator_moves_pages_verbatim_over_both_transports():
    # A page pool of distinct values: what lands in the decode shard's
    # pages is the prefill pages' bytes, every chunk count; the other
    # shards' arrivals are zeros written to their trash page only.
    cfg = TF.FlagshipConfig(**_cfg_kw())
    rng = np.random.default_rng(0)
    shape = (2, 9, 2, 8, 8)
    pre = {k: torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)) for k in ("k", "v")}
    for transport in ("xla", "pallas_dma"):
        for chunks in (1, 3, 8):
            _, _, mig = TD.build_disagg_meshes(1, ["cpu"] * 3)
            dec = [{k: torch.full((2, 5, 2, 8, 8), 7.0) for k in "kv"}
                   for _ in range(2)]
            m = TD.KvMigrator(mig, cfg, page_len=8, transport=transport,
                              chunks=chunks)
            m.migrate(pre, [4, 2, 7], dec, [3, 1, 2], 1)
            for k in "kv":
                assert torch.equal(dec[1][k][:, [3, 1, 2]],
                                   pre[k][:, [4, 2, 7]])
                assert torch.equal(dec[1][k][:, 4], torch.full(
                    (2, 2, 8, 8), 7.0))
                assert torch.equal(dec[0][k][:, 0], torch.zeros(2, 2, 8, 8))
                assert torch.equal(dec[0][k][:, 1:], torch.full(
                    (2, 4, 2, 8, 8), 7.0))
            assert m.block_bytes(3) == 3 * 2 * 2 * 2 * 8 * 8 * 4


# ------------------------------------------ reuse across the migration
# tests/test_serve_reuse.py:414-476: the prefill side's prefix cache and
# the decode side's speculation inside the disaggregated batcher, on a
# shared-prefix trace (its ``_reuse_trace``: every third prompt is the
# exact prefix, the partial-tail copy-on-write case). The decode slots
# divide over the replicas: 2 on 1+1, 3 on 1+3.

_REUSE = {"prefix": dict(prefix_cache=True), "spec3": dict(spec_k=3),
          "prefix_spec3": dict(prefix_cache=True, spec_k=3)}
_REUSE_DEC = (1, 3)
_REUSE_COUNTS = ("step_idx", "idle_steps", "prefix_hits",
                 "prefix_pages_shared", "prefix_tokens_saved", "cow_forks",
                 "decode_steps", "decode_tokens", "spec_steps",
                 "spec_drafted", "spec_accepted", "kv_migrate_bytes")


def _reuse_geo(n_dec):
    return dict(slots=2 if n_dec < 3 else 3, prefill_slots=2, page_len=8,
                num_pages=24, prefill_pages=25, max_blocks=6, chunk=4)


def _reuse_traces(seed):
    from test_serve_reuse import _reuse_trace

    jt = _reuse_trace(64, 24, 8, np.random.default_rng(seed))
    tt = [TB.Request(rid=r.rid, prompt=r.prompt.copy(), max_new=r.max_new,
                     arrival_step=r.arrival_step) for r in jt]
    return jt, tt


def _reuse_cfgs():
    kw = dict(slots=2, page_len=8, num_pages=24, max_blocks=6, chunk=4,
              vocab=64, prompt_len=(4, 8))
    return (JE._engine_model(JServeConfig(**kw)),
            TE._engine_model(TServeConfig(**kw)))


def _batcher_record(b, fin):
    return {"streams": {r.rid: list(r.generated) for r in fin},
            "migrate_events": list(b.migrate_events),
            "reuse_events": list(b.reuse_events),
            **{k: getattr(b, k) for k in _REUSE_COUNTS}}


@pytest.fixture(scope="module")
def reuse_reference():
    """The reference's colocated streams (no reuse) on the trace, and its
    disaggregated batcher per (decode replicas, reuse mode)."""
    jcfg, _ = _reuse_cfgs()
    seeded = JF.init_flagship_params(jcfg)
    trace, _ = _reuse_traces(5)
    mesh = JE.serve_mesh(1)
    co = JB.Batcher(mesh, jcfg, JF.place_flagship_params(seeded, mesh),
                    slots=2, page_len=8, num_pages=24, max_blocks=6,
                    chunk=4).run([r.fresh() for r in trace])
    runs = {}
    for n_dec in _REUSE_DEC:
        pre, dec, mig = JD.build_disagg_meshes(
            1, devices=jax.devices()[:1 + n_dec])
        pp = JF.place_flagship_params(seeded, pre)
        pd = JF.place_flagship_params(seeded, dec)
        for name, kw in _REUSE.items():
            b = JD.DisaggBatcher(pre, dec, mig, jcfg, pp, pd,
                                 **_reuse_geo(n_dec), **kw)
            runs[n_dec, name] = _batcher_record(
                b, b.run([r.fresh() for r in trace]))
    return seeded, {r.rid: list(r.generated) for r in co}, runs


@pytest.mark.parametrize("transport", ["xla", "pallas_dma"])
@pytest.mark.parametrize("name", sorted(_REUSE))
@pytest.mark.parametrize("n_dec", _REUSE_DEC, ids=["1+1", "1+3"])
def test_disagg_reuse_streams_bitwise_vs_reference_and_colocated(
        reuse_reference, n_dec, name, transport):
    seeded, colocated, runs = reuse_reference
    want = runs[n_dec, name]
    _, tcfg = _reuse_cfgs()
    _, trace = _reuse_traces(5)
    params = TF.params_from_numpy({k: np.asarray(v)
                                   for k, v in seeded.items()}, "cpu")
    _, _, mig = TD.build_disagg_meshes(1, ["cpu"] * (1 + n_dec))
    b = TD.DisaggBatcher(mig, tcfg, params, **_reuse_geo(n_dec),
                         transport=transport, migrate_chunks=3,
                         **_REUSE[name])
    got = _batcher_record(b, b.run([r.fresh() for r in trace]))
    # Exact: token streams bitwise, every count and event equal.
    assert got["streams"] == colocated
    assert got == want
    assert len(got["migrate_events"]) > 0
    if "prefix" in name:
        # Reuse engaged on the prefill side, pages then crossed to the
        # decode side; the index's holds survive the post-migration
        # free, and the whole system balances once they are released.
        assert got["prefix_hits"] > 0 and got["cow_forks"] > 0
        assert b.prefix_index.held(0) > 0
        b.prefix_index.release_all()
    if "spec" in name:
        assert got["spec_drafted"] > 0
    assert b.pool_p.available(0) == b.pool_p.capacity
    assert all(b.pool_d.available(d) == b.pool_d.capacity
               for d in range(n_dec))


@pytest.mark.parametrize("n_dec", _REUSE_DEC, ids=["1+1", "1+3"])
def test_disagg_prefix_dry_schedule_matches_reference_and_real(n_dec):
    jcfg, tcfg = _reuse_cfgs()
    jt, tt = _reuse_traces(9)
    geo = dict(**_reuse_geo(n_dec), n_decode_shards=n_dec,
               prefix_cache=True)
    want = JD.simulate_disagg_schedule(jt, cfg=jcfg, **geo)
    got = TD.simulate_disagg_schedule(tt, cfg=tcfg, **geo)
    for key in ("steps", "busy_steps", "idle_steps", "prefix_hits",
                "prefix_tokens_saved", "migrations", "migrate_events",
                "kv_migrate_bytes"):
        assert got[key] == want[key], key
    _events_equal(got["events"], want["events"])
    assert _life(got["requests"]) == _life(want["requests"])
    assert got["prefix_hits"] > 0
    # The real run on CPU ranks takes the dry schedule's steps.
    _, _, mig = TD.build_disagg_meshes(1, ["cpu"] * (1 + n_dec))
    b = TD.DisaggBatcher(mig, tcfg, TF.params_from_numpy(
        {k: np.asarray(v) for k, v in JF.init_flagship_params(jcfg).items()},
        "cpu"), **_reuse_geo(n_dec), prefix_cache=True)
    b.run([r.fresh() for r in tt])
    assert (b.prefix_hits, b.prefix_tokens_saved, b.step_idx) \
        == (got["prefix_hits"], got["prefix_tokens_saved"], got["steps"])
    _events_equal(b.events, got["events"])


# --------------------------------------------------------------- CLI


def _cli(module, args):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-m", module, "serve", *args],
                          capture_output=True, text=True, cwd=REPO,
                          env=env, timeout=600)
    return proc.returncode, proc.stdout, proc.stderr


@pytest.fixture(scope="module")
def reference_cli():
    rc, out, err = _cli("tpu_p2p", ["--cpu-mesh", "2", "--disagg",
                                    "--prefill-tp", "1", "--requests", "6",
                                    "--seed", "0"])
    assert rc == 0, err[-2000:]
    return mask_floats(out)


@pytest.mark.parametrize("extra", [
    [], ["--transport", "pallas_dma", "--migrate-chunks", "3"],
], ids=["xla", "pallas_dma_chunks3"])
def test_serve_disagg_cli_matches_reference(reference_cli, extra):
    rc, out, err = _cli("tpu_p2p_torch", [
        "--disagg", "--device", "cpu", "--cpu-mesh", "2", "--requests",
        "6", "--seed", "0", *extra])
    assert rc == 0, err[-2000:]
    got, want = mask_floats(out).splitlines(), reference_cli.splitlines()
    # The title: the head names the mesh (reference) or the device
    # (port), and the line names the transport; the rest is equal.
    want_head, got_head = "serve mesh disagg ", "serve device cpu disagg "
    assert want[0].startswith(want_head) and got[0].startswith(got_head)
    transport = "pallas_dma" if extra else "xla"
    assert got[0][len(got_head):] == want[0][len(want_head):].replace(
        "transport=xla", f"transport={transport}")
    assert got[1:] == want[1:]
    assert got[-1].endswith("token parity OK (6/6 bitwise)")


def test_serve_disagg_cli_rejections(capsys):
    # A tensor-parallel prefill (the default partition on 4 ranks, and
    # --prefill-tp 2 on 3) serves, and its streams are the colocated
    # twin's, as the reference's are.
    assert TE.main(["--disagg", "--device", "cpu", "--cpu-mesh", "4"]) == 0
    out = capsys.readouterr().out
    assert "prefill {'dp': 1, 'tp': 2} + decode {'dp': 2}" in out
    assert "token parity OK (8/8 bitwise)" in out
    assert TE.main(["--disagg", "--device", "cpu", "--cpu-mesh", "3",
                    "--prefill-tp", "2", "--slots", "6"]) == 0
    out = capsys.readouterr().out
    assert "prefill {'dp': 1, 'tp': 2} + decode {'dp': 1}" in out
    assert "token parity OK (8/8 bitwise)" in out
    assert TE.main(["--disagg", "--device", "cpu"]) == 1   # one rank
    assert ">= 2 devices" in capsys.readouterr().err
    assert TE.main(["--device", "cpu", "--cpu-mesh", "2", "--requests",
                    "2"]) == 0         # colocated over 2 ranks: served
    assert "serve device cpu {'dp': 2}" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="drop --batching"):
        TE.main(["--disagg", "--device", "cpu", "--cpu-mesh", "2",
                 "--batching", "static"])
    assert TE.main(["--device", "cuda", "--cpu-mesh", "2",
                    "--disagg"]) == 1
    assert "--device cpu" in capsys.readouterr().err
