"""Serving across ranks against the JAX reference: the colocated engine
over the serve mesh, the pool shards and their page copy, the serve
faults, the LM rollout, and the ``serve`` CLI's mesh, ``--reuse`` and
``--chaos`` output against the reference's goldens.

The reference runs in this process on its 8 simulated CPU devices
(``serve_mesh(n)``); the port runs on ``LocalMesh``es of CPU ranks, one
controller, no process group. Params come from the reference's
``init_flagship_params`` through ``params_from_numpy``. Token streams,
schedule counts, request records and host-side fault application must
be equal; CLI output must equal the golden after
``tests/test_cli_golden.py::mask_floats``, bar the header's device word.
"""

import pathlib

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from test_cli_golden import mask_floats
from tpu_p2p import config as JC
from tpu_p2p.models import decode as JD
from tpu_p2p.models import flagship as JF
from tpu_p2p.obs import faults as JFaults
from tpu_p2p.serve import engine as JE
from tpu_p2p.serve import paged_cache as JP
from tpu_p2p.serve import resilience as JR
from tpu_p2p_torch import config as TC
from tpu_p2p_torch.models import decode as TD
from tpu_p2p_torch.models import flagship as TF
from tpu_p2p_torch.obs import faults as TFaults
from tpu_p2p_torch.serve import batcher as TB
from tpu_p2p_torch.serve import engine as TE
from tpu_p2p_torch.serve import paged_cache as TP
from tpu_p2p_torch.serve import resilience as TR

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"


def _cpu_mesh(n):
    return TE.serve_mesh(n, ["cpu"] * n)


def _carry(j_params):
    return TF.params_from_numpy(
        {k: np.asarray(v) for k, v in j_params.items()}, "cpu")


# ------------------------------------------------------ pool shards


def test_pool_shards_and_their_page_copy_match_reference():
    kw = dict(slots=4, vocab=64)
    jcfg = JE._engine_model(JC.ServeConfig(**kw))
    tcfg = TE._engine_model(TC.ServeConfig(**kw))
    jmesh, tmesh = JE.serve_mesh(2), _cpu_mesh(2)
    assert TP.pool_shards(tmesh) == JP.pool_shards(jmesh) == 2
    with pytest.raises(ValueError) as want:
        JP.init_paged_pool(jcfg, 9, 8, jmesh)
    with pytest.raises(ValueError) as got:
        TP.init_pool_shards(tcfg, 9, 8, tmesh)
    assert str(got.value) == str(want.value)
    pools = TP.init_pool_shards(tcfg, 10, 8, tmesh)
    assert [tuple(p["k"].shape) for p in pools] \
        == [(2, 5, 2, 8, 16)] * 2
    # The same bytes in both pools, then shard 1 forks page 2 → 4 while
    # shard 0 idles (trash → trash).
    rng = np.random.default_rng(3)
    full = {n: rng.standard_normal((2, 10, 2, 8, 16)).astype(np.float32)
            for n in ("k", "v")}
    for k, p in enumerate(pools):
        for n in ("k", "v"):
            p[n].copy_(torch.from_numpy(full[n][:, 5 * k:5 * (k + 1)]))
    jpool = JP.init_paged_pool(jcfg, 10, 8, jmesh)
    jpool = {n: jax.device_put(full[n], jpool[n].sharding)
             for n in ("k", "v")}
    src, dst = np.array([0, 2], np.int32), np.array([0, 4], np.int32)
    vec = NamedSharding(jmesh, PartitionSpec("dp"))
    jpool = JP.make_page_copy(jmesh, jcfg)(
        jpool, jax.device_put(src, vec), jax.device_put(dst, vec))
    pools = TP.make_page_copy(tmesh)(pools, src, dst)
    for n in ("k", "v"):
        got = np.concatenate([p[n].numpy() for p in pools], axis=1)
        np.testing.assert_array_equal(got, np.asarray(jpool[n]))
    assert not np.array_equal(full["k"], np.asarray(jpool["k"]))


# ------------------------------------------------------------ engine

_ENGINE = {
    "continuous": ({}, "continuous", None),
    "static": ({}, "static", None),
    "prefix_cache": (dict(prefix_cache=True, requests=16,
                          prompt_len=(24, 30), gen_len=(3, 6)),
                     "continuous", 16),
    "spec_k3": (dict(spec_k=3), "continuous", None),
}
_ENGINE_KEYS = ("requests", "steps", "idle_steps", "prompt_tokens",
                "gen_tokens", "shed", "preemptions", "prefix_hits",
                "prefix_pages_shared", "prefix_tokens_saved",
                "prefix_saved_bytes", "cow_forks", "spec_decode_steps",
                "spec_decode_tokens")
_RECORD_FIELDS = ("id", "prompt_tokens", "output_tokens", "enqueue_step",
                  "prefill_start_step", "first_token_step", "finish_step",
                  "outcome", "preemptions", "pool", "prefix_pages",
                  "prefix_tokens", "spec_drafted", "spec_accepted",
                  "decode_steps", "shed_step", "deadline_step")


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("name", sorted(_ENGINE))
def test_engine_over_the_serve_mesh_matches_reference(name, n):
    extra, mode, prefix_len = _ENGINE[name]
    kw = dict(slots=8, page_len=8, num_pages=48, max_blocks=5, chunk=4,
              requests=10, seed=0, rate=1.5, prompt_len=(4, 12),
              gen_len=(4, 8), vocab=64)
    kw.update(extra)
    jsc, tsc = JC.ServeConfig(**kw), TC.ServeConfig(**kw)
    if prefix_len:
        j_trace = JE.shared_prefix_trace(jsc, prefix_len)
        t_trace = TE.shared_prefix_trace(tsc, prefix_len)
    else:
        j_trace, t_trace = JE.synthetic_trace(jsc), TE.synthetic_trace(tsc)
    jcfg, tcfg = JE._engine_model(jsc), TE._engine_model(tsc)
    jmesh = JE.serve_mesh(n)
    j_params = JF.init_flagship_params(jcfg)
    j_recs, t_recs = [], []
    want = JE.run_engine(jmesh, jcfg,
                         JF.place_flagship_params(j_params, jmesh),
                         j_trace, sc=jsc, mode=mode, emit=j_recs.append)
    got = TE.run_engine(_cpu_mesh(n), tcfg, _carry(j_params), t_trace,
                        sc=tsc, mode=mode, emit=t_recs.append)

    def streams(out):
        return {r.rid: list(r.generated) for r in out["finished"]}

    assert streams(got) == streams(want)
    assert len(streams(got)) == kw["requests"]
    for key in _ENGINE_KEYS:
        assert got.get(key) == want.get(key), key
    assert [r["obs"] for r in t_recs] == [r["obs"] for r in j_recs]
    for t, j in zip(t_recs, j_recs):
        if t["obs"] == "request":
            assert {k: t.get(k) for k in _RECORD_FIELDS} \
                == {k: j.get(k) for k in _RECORD_FIELDS}
    if name == "prefix_cache":
        assert got["prefix_hits"] > 0
    if name == "spec_k3":
        assert got["spec_decode_tokens"] > got["spec_decode_steps"] > 0
    else:
        # The dry scheduler over n shards is step for step the device
        # batcher's.
        sim = TB.simulate_schedule(
            t_trace, slots=tsc.slots, page_len=tsc.page_len,
            num_pages=tsc.num_pages, max_blocks=tsc.max_blocks,
            chunk=tsc.chunk, mode=mode, n_shards=n,
            prefix_cache=tsc.prefix_cache)
        assert (sim["steps"], sim["idle_steps"]) \
            == (got["steps"] - got["idle_steps"], got["idle_steps"])
    b = got["batcher"]
    assert b.n_shards == n and len(b.pools) == n
    if b.prefix_index is not None:
        b.prefix_index.release_all()
    assert [b.pool_alloc.available(k) for k in range(n)] \
        == [b.pool_alloc.capacity] * n


def test_batcher_keeps_one_params_copy_a_device_and_checks_shards():
    cfg = TE._engine_model(TC.ServeConfig(slots=4, vocab=64))
    params = TF.init_flagship_params(cfg, device="cpu")
    b = TB.Batcher(_cpu_mesh(4), cfg, params, slots=4, page_len=8,
                   num_pages=8, max_blocks=2, chunk=4)
    assert list(b._params) == [torch.device("cpu")]
    assert b._params[torch.device("cpu")]["emb"] is params["emb"]
    with pytest.raises(ValueError, match="one shard a rank"):
        TB.Batcher(_cpu_mesh(2), cfg, params, slots=4, page_len=8,
                   num_pages=8, max_blocks=2, chunk=4, n_shards=1)
    with pytest.raises(ValueError, match="divide by the dp"):
        TB.Batcher(_cpu_mesh(4), cfg, params, slots=6, page_len=8,
                   num_pages=8, max_blocks=2, chunk=4)


def test_several_cards_become_dp_ranks_of_the_serve_mesh(monkeypatch):
    made = []

    class FakeStream:
        def __init__(self, device=None):
            made.append(torch.device(device))

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "Stream", FakeStream)
    args = TE._build_parser().parse_args([])
    devices = TE._serve_devices(args)
    assert devices == [torch.device("cuda", i) for i in range(4)]
    mesh = TE.serve_mesh(len(devices), devices)
    assert mesh.devices == tuple(devices)
    assert mesh.shape == {"dp": 4} and TP.pool_shards(mesh) == 4
    assert TE._mesh_tag(mesh) == " {'dp': 4}"
    # Each rank gets its stream and side stream on its own card, and
    # nothing else is made on them.
    assert sorted(made, key=str) == sorted(devices * 2, key=str)
    assert TE.serve_mesh(4).devices == tuple(devices)   # the default


# ------------------------------------------------------- serve faults


def _storm_plan(mod):
    return mod.FaultPlan(page_pool_clamp=3, storm_step=2,
                         storm_requests=5, slow_rank=0, slow_ms=7.0,
                         start_step=3)


def test_serve_faults_match_reference(monkeypatch):
    kw = dict(slots=4, requests=6, seed=4, rate=2.0, vocab=64)
    jsc, tsc = JC.ServeConfig(**kw), TC.ServeConfig(**kw)
    j_trace, t_trace = JE.synthetic_trace(jsc), TE.synthetic_trace(tsc)
    with JFaults.injecting(_storm_plan(JFaults)):
        j_out, j_clamp, j_hook = JR.apply_serve_faults(j_trace, jsc)
    with TFaults.injecting(_storm_plan(TFaults)):
        t_out, t_clamp, t_hook = TR.apply_serve_faults(t_trace, tsc)

    def rows(trace):
        return [(r.rid, r.arrival_step, r.prompt.tolist(), r.max_new)
                for r in trace]

    assert rows(t_out) == rows(j_out)
    assert len(t_out) == len(t_trace) + 5 and t_clamp == j_clamp == 3
    assert rows(TR.storm_burst(tsc, _storm_plan(TFaults), 10)) \
        == rows(JR.storm_burst(jsc, _storm_plan(JFaults), 10))
    assert TR.apply_serve_faults(t_trace, tsc) == (t_trace, None, None)
    # The hook sleeps slow_ms from start_step on, on the host only.
    slept = []
    real = TFaults.maybe_slow_host
    monkeypatch.setattr(
        TFaults, "maybe_slow_host",
        lambda plan, step: real(plan, step,
                                sleep=lambda s: slept.append((step, s))))
    for step in range(6):
        t_hook(step)
    assert slept == [(3, 7e-3), (4, 7e-3), (5, 7e-3)]
    for plan in (None, _storm_plan(TFaults)):
        jplan = plan and _storm_plan(JFaults)
        for step in (0, 2, 3, 9):
            got, want = [], []
            assert real(plan, step, sleep=got.append) \
                == JFaults.maybe_slow_host(jplan, step, sleep=want.append)
            assert got == want


def test_engine_runs_the_step_hook_on_busy_steps(monkeypatch):
    sc = TC.ServeConfig(slots=4, page_len=8, num_pages=20, max_blocks=3,
                        requests=4, seed=1, rate=0.3, vocab=64)
    cfg = TE._engine_model(sc)
    params = TF.init_flagship_params(cfg, device="cpu")
    slept = []
    real = TFaults.maybe_slow_host
    monkeypatch.setattr(
        TFaults, "maybe_slow_host",
        lambda plan, step: real(plan, step,
                                sleep=lambda s: slept.append(step)))
    plan = TFaults.FaultPlan(slow_rank=0, slow_ms=5.0)
    ref = TE.run_engine(_cpu_mesh(2), cfg, params, TE.synthetic_trace(sc),
                        sc=sc)
    with TFaults.injecting(plan):
        out = TE.run_engine(_cpu_mesh(2), cfg, params,
                            TE.synthetic_trace(sc), sc=sc)
    # Once a busy step, never on an idle one; nothing else changes.
    assert out["idle_steps"] > 0
    assert len(slept) == out["steps"] - out["idle_steps"]
    assert len(set(slept)) == len(slept)
    assert (out["steps"], out["idle_steps"]) \
        == (ref["steps"], ref["idle_steps"])
    assert {r.rid: r.generated for r in out["finished"]} \
        == {r.rid: r.generated for r in ref["finished"]}


# --------------------------------------------------- generate_tokens


def _tiny():
    kw = dict(batch=2, seq=16, heads=4, kv_heads=2, head_dim=8, stages=2,
              microbatches=1, dense_ffn=True, moe_mult=2, vocab=32,
              norm=True, rope=True, dtype="float32")
    return JF.FlagshipConfig(**kw), TF.FlagshipConfig(**kw)


def _logits_along(step, params, cfg, seq):
    """Teacher-forced logits of every position of ``seq [B, T]``."""
    cache = TD.init_kv_cache(cfg, max_len=24, device="cpu")
    out = []
    for t in range(seq.shape[1]):
        cache, lg = step(params, cache, seq[:, t:t + 1], t)
        out.append(lg[:, 0])
    return torch.stack(out, 1)


def test_generate_tokens_greedy_matches_reference_and_samples_in_support():
    jcfg, tcfg = _tiny()
    j_params = JF.init_flagship_params(jcfg)
    t_params = _carry(j_params)
    prompt = np.random.default_rng(5).integers(0, 32, (2, 5)).astype(
        np.int32)
    mesh1 = JE.serve_mesh(1)
    jstep = JD.make_flagship_lm_decode_step(mesh1, jcfg)
    jcache = JD.init_kv_cache(jcfg, max_len=24, mesh=mesh1)
    _, want = JD.generate_tokens(
        jstep, JF.place_flagship_params(j_params, mesh1), jcache,
        prompt, num_tokens=9)
    tstep = TD.make_flagship_lm_decode_step(tcfg)

    def run(**kw):
        cache = TD.init_kv_cache(tcfg, max_len=24, device="cpu")
        return TD.generate_tokens(tstep, t_params, cache, prompt,
                                  num_tokens=9, **kw)[1]

    greedy = run()
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(want))
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(run(temperature=0.7, top_k=1, generator=gen),
                       greedy)
    for kw in (dict(top_k=4), dict(top_p=0.6), dict(top_k=6, top_p=0.8)):
        gen = torch.Generator().manual_seed(1)
        seq = run(temperature=1.3, generator=gen, **kw)
        z = _logits_along(tstep, t_params, tcfg, seq)[:, 4:-1] / 1.3
        tok = seq[:, 5:]
        rank = (z > z.gather(-1, tok[..., None])).sum(-1)
        if kw.get("top_k"):
            assert (rank < kw["top_k"]).all(), kw
        if kw.get("top_p"):
            p = torch.softmax(z, -1)
            before = (p * (p > p.gather(-1, tok[..., None]))).sum(-1)
            assert (before < kw["top_p"] + 1e-6).all(), kw
        assert not torch.equal(seq, greedy), kw
    with pytest.raises(ValueError, match="needs a generator"):
        run(temperature=1.0)
    with pytest.raises(ValueError, match="no effect"):
        run(top_k=3)
    with pytest.raises(ValueError, match="overruns"):
        TD.generate_tokens(tstep, t_params,
                           TD.init_kv_cache(tcfg, max_len=8, device="cpu"),
                           prompt, num_tokens=9)


# --------------------------------------------------------------- CLI

_GOLDENS = {
    "serve": (["--requests", "6", "--seed", "0", "--batching", "both"],
              "cli_serve_8dev.txt",
              ("serve mesh {'dp': 8}: ", "serve device cpu {'dp': 8}: ")),
    "serve_reuse": (["--reuse"], "cli_serve_reuse_8dev.txt",
                    ("serve reuse mesh {'dp': 8}: ",
                     "serve reuse device cpu {'dp': 8}: ")),
    "serve_chaos": (["--chaos"], "cli_serve_chaos_8dev.txt", None),
}


def _chaos_verdict(out: str) -> bool:
    """The chaos smoke's slow_step grade from its printed line: the
    injected delay must show in the per-token p99 (the reference's rule,
    ``tok_ms_p99`` slow minus clean >= half the injected ms). It reads a
    wall clock, so on a loaded host it may fail in the reference as in
    the port; the step counts and streams beside it are exact."""
    import re

    from tpu_p2p_torch.serve.resilience import CHAOS_SLOW_MS

    ref, slow = map(float, re.search(
        r"tok_ms_p99 ([\d.]+)ms->([\d.]+)ms", out).groups())
    return slow - ref >= 0.5 * CHAOS_SLOW_MS


@pytest.mark.parametrize("name", sorted(_GOLDENS))
def test_serve_cli_over_eight_ranks_matches_golden(name, capsys):
    args, golden, heads = _GOLDENS[name]
    rc = TE.main(["--device", "cpu", "--cpu-mesh", "8", *args])
    out = capsys.readouterr().out
    got = mask_floats(out).splitlines()
    want = (GOLDEN / golden).read_text().splitlines()
    if name == "serve_chaos":
        # Every scenario's counts stay exact; the verdict, the JSON ok
        # and the exit code are held to the wall-clock grade's printed
        # numbers by its own rule (the golden's OK/true/0 are the
        # unloaded outcome).
        ok = _chaos_verdict(out)
        want = [w.replace("verdict: OK", "verdict: " + ("OK" if ok
                                                         else "FAIL"))
                .replace('"ok": true', f'"ok": {str(ok).lower()}')
                for w in want]
        assert rc == (0 if ok else 1)
    else:
        assert rc == 0
    if heads:
        want_head, got_head = heads
        assert want[0].startswith(want_head)
        assert got[0].startswith(got_head)
        got[0] = want_head + got[0][len(got_head):]
    assert got == want
