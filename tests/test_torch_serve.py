"""The port's serving layer against the JAX reference: the page pool and
prefix index, the resilience policy, the dry scheduler, the engine's
token streams, and the ``serve`` CLI.

Host logic (pools, indexes, schedules, traces, stop draws) must be
equal to the reference's exactly. Engine runs use float32 and the
reference's own tiny CLI model, fed the same weights through the carry;
their token streams and step counts must be equal. The CLI's output
must equal the reference's after ``tests/test_cli_golden.py::
mask_floats``, except the header line that names the mesh or device.
"""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_cli_golden import mask_floats
from tpu_p2p import config as JC
from tpu_p2p.models import decode as JD
from tpu_p2p.models import flagship as JF
from tpu_p2p.serve import batcher as JB
from tpu_p2p.serve import engine as JE
from tpu_p2p.serve import paged_cache as JP
from tpu_p2p.serve import resilience as JR
from tpu_p2p_torch import cli as TCLI
from tpu_p2p_torch import config as TC
from tpu_p2p_torch.models import decode as TD
from tpu_p2p_torch.models import flagship as TF
from tpu_p2p_torch.serve import batcher as TB
from tpu_p2p_torch.serve import engine as TE
from tpu_p2p_torch.serve import paged_cache as TP
from tpu_p2p_torch.serve import resilience as TR

REPO = pathlib.Path(__file__).resolve().parents[1]


# ------------------------------------------------------- page pool


def test_page_pool_alloc_free_invariants():
    pp = TP.PagePool(16, 8, n_shards=2)
    assert pp.capacity == 7  # 8 per shard minus the trash page
    got = [pp.alloc(0) for _ in range(7)]
    assert len(set(got)) == 7 and TP.TRASH_PAGE not in got
    with pytest.raises(TP.OutOfPages):
        pp.alloc(0)
    assert pp.available(1) == 7
    pp.free(got[:3], 0)
    assert pp.available(0) == 3
    for bad, shard in (([got[0]], 0), ([TP.TRASH_PAGE], 0), ([123], 1)):
        with pytest.raises(ValueError):
            pp.free(bad, shard)
    with pytest.raises(TP.OutOfPages):
        pp.alloc_n(4, 0)
    assert pp.available(0) == 3


def test_page_pool_free_is_atomic_and_validates():
    pp = TP.PagePool(16, 8)
    got = pp.alloc_n(4)
    avail = pp.available(0)
    with pytest.raises(ValueError):
        pp.free([got[0], 999], 0)       # bad tail: nothing freed
    assert pp.available(0) == avail
    pp.free([got[0]], 0)
    with pytest.raises(ValueError):
        pp.free([got[1], got[1]], 0)    # intra-call duplicate
    assert pp.available(0) == avail + 1
    pp.free(got[1:], 0)
    assert pp.available(0) == pp.capacity
    for args, match in (((8, 12), "page_len"), ((9, 8, 2), "divide"),
                        ((2, 8, 2), ">= 2 pages")):
        with pytest.raises(ValueError, match=match):
            TP.PagePool(*args)


def test_page_pool_refcounts():
    pool = TP.PagePool(9, 8, 1)
    a = pool.alloc(0)
    pool.retain([a])
    assert pool.ref(a) == 2
    pool.free([a])
    assert pool.ref(a) == 1 and a in pool.allocated(0)
    with pytest.raises(ValueError, match="retain"):
        pool.retain([a + 1])
    pool.retain([a, a])                 # a repeated pid takes two refs
    with pytest.raises(ValueError, match="not allocated"):
        pool.free([a, a])
    assert pool.ref(a) == 3
    for _ in range(3):
        pool.free([a])
    assert pool.ref(a) == 0 and pool.available(0) == pool.capacity


def _pool_state(pool, n_shards):
    return [(pool.available(s), sorted(pool.allocated(s)),
             sorted((p, pool.ref(p, s)) for p in pool.allocated(s)))
            for s in range(n_shards)]


def test_page_pool_fuzz_matches_reference():
    # One random op stream of allocs, frees (some invalid), retains and
    # a clamp, applied to both pools: every result, every refusal and
    # the whole state after every op must be equal.
    rng = np.random.default_rng(2024)
    for n_shards in (1, 2):
        pools = [JP.PagePool(24, 8, n_shards), TP.PagePool(24, 8, n_shards)]
        if n_shards == 2:
            for p in pools:
                p.clamp_capacity(9)
        held = []
        for _ in range(400):
            op, shard = int(rng.integers(0, 4)), int(rng.integers(n_shards))
            if op == 0:
                k = int(rng.integers(1, 4))
                calls = [lambda p: p.alloc_n(k, shard)]
            elif op == 1 and held:
                pages, sh = held[int(rng.integers(len(held)))]
                calls = [lambda p: p.free(pages, sh)]
            elif op == 2 and held:
                pages, sh = held[int(rng.integers(len(held)))]
                extra = [int(rng.integers(0, 13))]
                calls = [lambda p: p.retain(pages + extra, sh)]
            else:
                calls = [lambda p: p.alloc(shard)]
            out = []
            for p in pools:
                try:
                    out.append(("ok", calls[0](p)))
                except (ValueError, JP.OutOfPages, TP.OutOfPages) as e:
                    out.append(("raise", type(e).__name__))
            assert out[0] == out[1]
            if out[0][0] == "ok" and op == 0:
                held.append((out[0][1], shard))
            elif out[0][0] == "ok" and isinstance(out[0][1], int):
                held.append(([out[0][1]], shard))
            assert _pool_state(pools[0], n_shards) \
                == _pool_state(pools[1], n_shards)


def test_prefix_index_chain_lookup_and_dedupe():
    pool = TP.PagePool(17, 8, 1)
    idx = TP.PrefixIndex(pool)
    prompt = np.arange(20, dtype=np.int32)  # 2 full pages + tail
    pages = pool.alloc_n(3, 0)
    assert idx.register(prompt, pages[:2]) == 2
    pool.free(pages)
    assert pool.ref(pages[0]) == 1 and pool.ref(pages[2]) == 0
    assert idx.lookup(prompt) == pages[:2]
    other = np.concatenate([prompt[:8], np.full(12, 63, np.int32)])
    assert idx.lookup(other) == pages[:1]
    assert idx.lookup(prompt[1:]) == []
    p2 = pool.alloc_n(2, 0)
    assert idx.register(prompt, p2) == 0        # first writer wins
    pool.free(p2)
    assert idx.evict_one()                      # tail first
    assert idx.lookup(prompt) == pages[:1]
    idx.release_all()
    assert not idx.held() and pool.available(0) == pool.capacity


def test_prefix_index_matches_reference():
    rng = np.random.default_rng(7)
    for prev in (None, b"\x01" * 16):
        toks = rng.integers(0, 64, 8).astype(np.int32)
        assert TP._chain_key(prev, toks) == JP._chain_key(prev, toks)
    base = rng.integers(0, 64, 32).astype(np.int32)
    prompts = [np.concatenate([base[:int(rng.integers(0, 33))],
                               rng.integers(0, 64, 12).astype(np.int32)])
               for _ in range(12)]
    sides = []
    for mod in (JP, TP):
        pool = mod.PagePool(64, 8, 1)
        sides.append((pool, mod.PrefixIndex(pool)))
    for i, prompt in enumerate(prompts):
        pages = [side[0].alloc_n(len(prompt) // 8, 0) for side in sides]
        assert pages[0] == pages[1]
        got = [side[1].register(prompt, pg) for side, pg in zip(sides, pages)]
        assert got[0] == got[1]
        for side, pg in zip(sides, pages):
            side[0].free(pg)
        if i % 4 == 3:
            assert sides[0][1].evict_one() == sides[1][1].evict_one()
        for q in prompts:
            assert sides[0][1].lookup(q) == sides[1][1].lookup(q)
        assert _pool_state(sides[0][0], 1) == _pool_state(sides[1][0], 1)


def test_page_copy_forks_every_stage_and_projection():
    cfg = TF.FlagshipConfig(batch=2, heads=4, kv_heads=2, head_dim=8,
                            stages=2, dense_ffn=True, vocab=16)
    pool = TP.init_paged_pool(cfg, 4, 8, "cpu")
    for i, buf in enumerate(pool.values()):
        buf.copy_(torch.randn(buf.shape, generator=torch.Generator()
                              .manual_seed(i)))
    before = {k: v.clone() for k, v in pool.items()}
    TP.page_copy(pool, 1, 3)
    for k in ("k", "v"):
        assert torch.equal(pool[k][:, 3], before[k][:, 1])
        assert torch.equal(pool[k][:, :3], before[k][:, :3])


# ------------------------------------------------ resilience + drafts


def test_resilience_policy_matches_reference():
    for seed, rid, k, prob in [(0, 3, k, 0.3) for k in range(1, 40)] \
            + [(5, r, 2, 0.35) for r in range(20)]:
        assert TR.eos_stop(seed, rid, k, prob) \
            == JR.eos_stop(seed, rid, k, prob)
    reqs = []
    for rid, gen in enumerate(([1, 2, 3], [1], [1])):
        r = TB.Request(rid=rid, prompt=np.zeros(4, np.int32), max_new=8)
        r.generated = list(gen)
        reqs.append(r)
    slots = [TB._Slot(r, [i + 1], 8) for i, r in enumerate(reqs)] + [None]
    # Least generated wins; the tie goes to the younger (larger rid).
    assert TR.choose_victim(slots, 0, lambda i: 0) == 2
    assert TR.choose_victim([None, None], 0, lambda i: 0) is None
    reqs[0].preempt_recover_steps = [3, 5]
    assert TR.preempt_recover_steps(reqs) == 5
    assert TR.preempt_recover_steps(reqs[1:]) is None
    assert (TR.OUTCOME_COMPLETED, TR.SHED_OUTCOMES) \
        == (JR.OUTCOME_COMPLETED, JR.SHED_OUTCOMES)


def test_drafting_and_verify_match_reference():
    rng = np.random.default_rng(3)
    for _ in range(50):
        hist = rng.integers(0, 5, int(rng.integers(1, 12))).tolist()
        k = int(rng.integers(0, 5))
        assert TD.ngram_propose(hist, k) == JD.ngram_propose(hist, k)
        rows = rng.integers(0, 3, k + 1).tolist()
        drafts = rng.integers(0, 3, k).tolist()
        assert TD.spec_verify(rows, drafts) == JD.spec_verify(rows, drafts)
    with pytest.raises(ValueError, match="drafts"):
        TD.spec_verify([5, 7], [7, 9])
    vals = rng.random(17).tolist() + [None]
    for q in (0.0, 0.5, 0.99, 1.0):
        assert TB.percentile(vals, q) == JB.percentile(vals, q)
    assert TB.percentile([None], 0.5) is None


# ------------------------------------------------------ dry schedule


def _trace_pair(reqs):
    """The same requests as reference and port objects."""
    return ([JB.Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new,
                        arrival_step=r.arrival_step) for r in reqs],
            [TB.Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new,
                        arrival_step=r.arrival_step) for r in reqs])


def _fixed(n, n_prompt, max_new, seed=7):
    rng = np.random.default_rng(seed)
    return [TB.Request(rid=i, prompt=rng.integers(0, 64, n_prompt)
                       .astype(np.int32), max_new=max_new)
            for i in range(n)]


def _reuse_trace(vocab, prefix_len, n, rng, exact_every=3):
    """Shared-prefix requests; every ``exact_every``-th prompt is the
    exact prefix (the partial-tail copy-on-write fork)."""
    prefix = rng.integers(0, vocab, prefix_len).astype(np.int32)
    out = []
    for rid in range(n):
        if rid % exact_every == exact_every - 1:
            prompt = prefix.copy()
        else:
            sfx = rng.integers(0, vocab,
                               int(rng.integers(2, 6))).astype(np.int32)
            prompt = np.concatenate([prefix, sfx])
        out.append(TB.Request(rid=rid, prompt=prompt,
                              max_new=int(rng.integers(4, 8)),
                              arrival_step=rid))
    return out


_GEOM = dict(slots=4, page_len=8, num_pages=24, max_blocks=3, chunk=4)
_SCHEDULES = {
    "continuous": (lambda: TE.synthetic_trace(TC.ServeConfig(
        requests=8, rate=0.7, seed=5, vocab=64, **_GEOM)), _GEOM),
    "static": (lambda: TE.synthetic_trace(TC.ServeConfig(
        requests=8, rate=0.7, seed=5, vocab=64, **_GEOM)),
        {**_GEOM, "mode": "static"}),
    "preempt": (lambda: _fixed(4, 10, 8),
                dict(slots=2, page_len=8, num_pages=8, max_blocks=3,
                     chunk=4, pool_clamp=4, deadline_steps=2)),
    "eos": (lambda: _fixed(6, 8, 12),
            dict(slots=2, page_len=8, num_pages=20, max_blocks=3, chunk=4,
                 stop="eos", stop_seed=5, eos_prob=0.35)),
    "shed": (lambda: TE.synthetic_trace(TC.ServeConfig(
        requests=10, rate=6.0, seed=1, vocab=64, **_GEOM)),
        {**_GEOM, "slots": 2, "queue_depth": 3, "deadline_steps": 4}),
    "prefix": (lambda: _reuse_trace(64, 24, 8, np.random.default_rng(9)),
               dict(slots=2, page_len=8, num_pages=24, max_blocks=6,
                    chunk=4, n_shards=2, prefix_cache=True)),
}


@pytest.mark.parametrize("name", sorted(_SCHEDULES))
def test_simulate_schedule_event_exact_vs_reference(name):
    make, kw = _SCHEDULES[name]
    j_trace, t_trace = _trace_pair(make())
    want = JB.simulate_schedule(j_trace, **kw)
    got = TB.simulate_schedule(t_trace, **kw)
    for key in ("steps", "idle_steps", "tokens", "preempt_events",
                "preemptions", "prefix_hits", "prefix_tokens_saved"):
        assert got[key] == want[key], key
    assert sorted(got["stacked"]) == sorted(want["stacked"])
    for key, arr in want["stacked"].items():
        np.testing.assert_array_equal(got["stacked"][key], arr, err_msg=key)

    def life(reqs):
        return [(r.rid, r.enqueue_step, r.prefill_start_step,
                 r.first_token_step, r.finish_step, r.preempt_steps,
                 r.preempt_recover_steps, r.outcome, r.shed_step,
                 r.deadline_step, r.prefix_pages, r.prefix_tokens,
                 len(r.generated)) for r in reqs]

    assert life(got["requests"]) == life(want["requests"])
    assert life(got["shed"]) == life(want["shed"])
    assert got["steps"] > 0


def test_dry_batcher_refuses_speculation_and_oversized_requests():
    with pytest.raises(ValueError, match="VALUE-driven"):
        TB.Batcher(None, None, slots=2, page_len=8, num_pages=8,
                   max_blocks=2, chunk=2, dry=True, spec_k=2)
    b = TB.Batcher(None, None, slots=2, page_len=8, num_pages=8,
                   max_blocks=2, chunk=4, dry=True)
    b.submit(TB.Request(rid=0, prompt=np.zeros(40, np.int32), max_new=8))
    with pytest.raises(ValueError, match="max_blocks"):
        b.step()
    with pytest.raises(ValueError, match="dry-only"):
        TB.Batcher(None, {"emb": torch.zeros(1)}, slots=2, page_len=8,
                   num_pages=8, max_blocks=2, chunk=4, n_shards=2)


# ------------------------------------------------------------ engine


def _traces_equal(j_trace, t_trace):
    assert [(r.rid, r.arrival_step, r.max_new, r.prompt.tolist())
            for r in j_trace] \
        == [(r.rid, r.arrival_step, r.max_new, r.prompt.tolist())
            for r in t_trace]


_ENGINE = {
    "continuous": ({}, "continuous", None),
    "static": ({}, "static", None),
    "prefix_cache": (dict(prefix_cache=True, slots=2, requests=6,
                          prompt_len=(24, 30), gen_len=(3, 6)),
                     "continuous", 16),
    "spec_k3": (dict(spec_k=3), "continuous", None),
}
_ENGINE_KEYS = ("requests", "steps", "idle_steps", "prompt_tokens",
                "gen_tokens", "shed", "preemptions", "prefix_hits",
                "prefix_pages_shared", "prefix_tokens_saved",
                "prefix_saved_bytes", "cow_forks", "spec_decode_steps",
                "spec_decode_tokens")
_STEP_FIELDS = ("id", "prompt_tokens", "output_tokens", "enqueue_step",
                "prefill_start_step", "first_token_step", "finish_step",
                "outcome", "preemptions", "pool", "prefix_pages",
                "prefix_tokens", "spec_drafted", "spec_accepted",
                "decode_steps")


@pytest.mark.parametrize("name", sorted(_ENGINE))
def test_engine_streams_match_reference(name):
    extra, mode, prefix_len = _ENGINE[name]
    kw = dict(slots=4, page_len=8, num_pages=40, max_blocks=5, chunk=4,
              requests=6, seed=0, rate=1.0, prompt_len=(4, 12),
              gen_len=(4, 8), vocab=64)
    kw.update(extra)
    jsc, tsc = JC.ServeConfig(**kw), TC.ServeConfig(**kw)
    if prefix_len:
        j_trace = JE.shared_prefix_trace(jsc, prefix_len)
        t_trace = TE.shared_prefix_trace(tsc, prefix_len)
    else:
        j_trace, t_trace = JE.synthetic_trace(jsc), TE.synthetic_trace(tsc)
    _traces_equal(j_trace, t_trace)
    jcfg, tcfg = JE._engine_model(jsc), TE._engine_model(tsc)
    mesh = JE.serve_mesh(1)
    j_params = JF.init_flagship_params(jcfg)
    t_params = TF.params_from_numpy(
        {k: np.asarray(v) for k, v in j_params.items()}, "cpu")
    j_recs, t_recs = [], []
    want = JE.run_engine(mesh, jcfg, JF.place_flagship_params(j_params, mesh),
                         j_trace, sc=jsc, mode=mode, emit=j_recs.append)
    got = TE.run_engine(tcfg, t_params, t_trace, sc=tsc, mode=mode,
                        emit=t_recs.append)

    def streams(out):
        return {r.rid: list(r.generated) for r in out["finished"]}

    assert streams(got) == streams(want)
    assert len(streams(got)) == kw["requests"]
    for key in _ENGINE_KEYS:
        assert got.get(key) == want.get(key), key
    assert [r["obs"] for r in t_recs] == [r["obs"] for r in j_recs]
    for t, j in zip(t_recs, j_recs):
        if t["obs"] == "request":
            assert {k: t.get(k) for k in _STEP_FIELDS} \
                == {k: j.get(k) for k in _STEP_FIELDS}
    if name == "prefix_cache":
        assert got["prefix_hits"] > 0 and got["cow_forks"] >= 0
    if name == "spec_k3":
        assert got["spec_decode_tokens"] > got["spec_decode_steps"] > 0
    b = got["batcher"]
    if b.prefix_index is not None:
        b.prefix_index.release_all()
    assert b.pool_alloc.available(0) == b.pool_alloc.capacity


# --------------------------------------------------------------- CLI


def _cli(module, args):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-m", module, "serve", *args],
                          capture_output=True, text=True, cwd=REPO,
                          env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


@pytest.mark.parametrize("args", [
    [],
    ["--batching", "continuous", "--rate", "8", "--queue-depth", "3",
     "--stop", "eos", "--eos-prob", "0.2", "--spec-k", "3",
     "--prefix-cache"],
], ids=["default", "resilience_reuse"])
def test_serve_cli_output_matches_reference(args):
    want = mask_floats(_cli("tpu_p2p", ["--cpu-mesh", "1", *args]))
    got = mask_floats(_cli("tpu_p2p_torch", ["--device", "cpu", *args]))
    want_lines, got_lines = want.splitlines(), got.splitlines()
    want_head, got_head = "serve mesh {'dp': 1}: ", "serve device cpu: "
    assert want_lines[0].startswith(want_head)
    assert got_lines[0].startswith(got_head)
    assert got_lines[0][len(got_head):] == want_lines[0][len(want_head):]
    assert got_lines[1:] == want_lines[1:]


def test_serve_cli_never_falls_back_to_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.resolve_device("cuda")
    assert TE.main(["--requests", "1"]) == 1     # default device: cuda
    assert "no CUDA device" in capsys.readouterr().err
    for flag in (["--chaos"], ["--trace", "t.json"]):
        assert TE.main(["--device", "cpu", *flag]) == 2
        assert "not ported yet" in capsys.readouterr().err
    assert TE.main(["--disagg", "--requests", "1"]) == 1  # cuda: no card
    assert "no CUDA device" in capsys.readouterr().err
    assert TCLI.main(["train"]) == 1                      # cuda: no card
    assert "no CUDA device" in capsys.readouterr().err
    assert TE.main(["--device", "cpu", "--reuse"]) == 0
    assert "NULL" in capsys.readouterr().out


# ------------------------------------------------------------ imports


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((REPO / "tpu_p2p_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "serve_profile.py",
              REPO / "flash_tiles.py", REPO / "flagship_cards.py",
              REPO / "collectives_cards.py"]
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            elif (isinstance(node, ast.Call)
                  and getattr(node.func, "id", getattr(node.func, "attr",
                                                       "")) in
                  ("__import__", "import_module")):
                names = [a.value for a in node.args
                         if isinstance(a, ast.Constant)]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "tpu_p2p", "optax",
                                    "ml_dtypes", "orbax"), \
                    f"{path.relative_to(REPO)}:{node.lineno} imports {name}"
