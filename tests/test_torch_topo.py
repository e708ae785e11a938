"""The port's topology engine (``tpu_p2p_torch/topo``) against the JAX
reference's ``tpu_p2p/topo``, case for case with ``tests/test_topo.py``.

- Host code is equal on equal input: the model's ladder, presets,
  degraded marks and views, the ring-order search (against brute force
  and against the reference's own choice), migration placement and the
  per-link tick bill.
- The repo's own ``MULTICHIP_r*.json`` are TPU runs of another kind:
  they yield no history, so no TPU number prices or orders a ring of
  cards.
- On a gloo world of 8 (``tests/torch_topo_world.py``, spawned once):
  the throttled probe on 4 ranks routes the ring and the migrations
  around the edge; one flagship SGD step a mesh shape on a reordered
  mesh is bitwise equal where every sum has at most 2 members, else
  equal to float32 reassociation; ``make_runtime`` threads a given ring
  order through its 1-D world (the pipeline step bitwise the rank-order
  world's) and leaves 2-D, mismatched, unasked and history-less worlds
  in rank order; every library reduction, the all-to-all, the
  reduction patterns under ``--check`` and the obs live capture run on
  the reordered world as in rank order; the smoke's ring parity holds
  over both transports.
- The disagg engine's placement on CPU ranks: dry == real under the topo
  policy and token streams bitwise the default's, equal to the
  reference's.
- ``topo --cpu-mesh 8 --preset ring`` equals the golden after masking.
"""

import io
import itertools
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

import conftest
from tpu_p2p.topo import place as JPL
from tpu_p2p.topo.model import Topology as JTopology
from tpu_p2p_torch.parallel.launch import run_world
from tpu_p2p_torch.topo import place as PL
from tpu_p2p_torch.topo.model import DEGRADED_PENALTY, Topology

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORLD = os.path.join(HERE, "torch_topo_world.py")
GOLDEN = os.path.join(HERE, "golden", "cli_topo_8dev.txt")


def _same(t, j):
    """Port model == reference model, cell for cell."""
    assert (t.n, t.gbps, t.provenance, t.source, t.degraded) == \
        (j.n, j.gbps, j.provenance, j.source, j.degraded)


# --------------------------------------------------- model / ladder


def test_from_matrix_median_inherit_never_zero():
    mat = [[None, 10.0, None],
           [float("nan"), None, 30.0],
           [None, None, None]]
    t = Topology.from_matrix(mat, "probe")
    _same(t, JTopology.from_matrix(mat, "probe"))
    assert t.link_gbps(0, 1) == 10.0 and t.provenance[0][1] == "probe"
    assert t.link_gbps(2, 0) == 20.0 and t.provenance[2][0] == "median"
    assert all(t.link_gbps(i, j) > 0
               for i in range(3) for j in range(3) if i != j)
    assert t.gbps[1][1] == 0.0


def test_from_matrix_refuses_all_unmeasured():
    with pytest.raises(ValueError, match="no measured") as got:
        Topology.from_matrix([[None, None], [None, None]], "probe")
    with pytest.raises(ValueError) as want:
        JTopology.from_matrix([[None, None], [None, None]], "probe")
    assert str(got.value) == str(want.value)


def test_presets():
    from tpu_p2p.parallel.topology import TorusInfo

    for n, g in ((4, 80.0), (8, 100.0), (1, 5.0)):
        _same(Topology.preset_uniform(n, g), JTopology.preset_uniform(n, g))
        _same(Topology.preset_ring(n, g), JTopology.preset_ring(n, g))
    r = Topology.preset_ring(8, 100.0)
    assert r.link_gbps(0, 4) == 25.0 and r.link_gbps(0, 7) == 100.0
    torus = TorusInfo(dims=(2, 2), coords=((0, 0), (0, 1), (1, 0),
                                           (1, 1)))
    tt = Topology.preset_torus(torus, 100.0)
    _same(tt, JTopology.preset_torus(torus, 100.0))
    assert tt.link_gbps(0, 3) == 50.0
    for bad in (Topology.preset_uniform, Topology.preset_ring):
        with pytest.raises(ValueError, match="n >= 1"):
            bad(0)


def test_history_prefers_trace_over_probe(tmp_path):
    from tpu_p2p_torch.obs import regress as R

    with open(os.path.join(str(tmp_path), "MULTICHIP_r01.json"),
              "w") as fh:
        json.dump({"kind": "obs_link_matrix", "n_devices": 2,
                   "matrix_gbps": [[None, 5.0], [None, None]]}, fh)
    R.write_probe_artifact([[None, 50.0], [7.0, None]], 2,
                           str(tmp_path))
    t = Topology.from_history(str(tmp_path))
    _same(t, JTopology.from_history(str(tmp_path)))
    assert t.source == "history" and t.link_gbps(0, 1) == 5.0
    assert t.provenance[0][1] == "trace" and t.provenance[1][0] == "probe"


def test_history_same_source_keeps_max(tmp_path):
    from tpu_p2p_torch.obs import regress as R

    R.write_probe_artifact([[None, 3.0], [None, None]], 2, str(tmp_path))
    R.write_probe_artifact([[None, 9.0], [None, None]], 2, str(tmp_path))
    t = Topology.from_history(str(tmp_path))
    _same(t, JTopology.from_history(str(tmp_path)))
    assert t.link_gbps(0, 1) == 9.0


def test_best_available_ladder(tmp_path):
    from tpu_p2p_torch.obs import regress as R

    for kw in (dict(trace_matrix=[[None, 3.0], [4.0, None]]), {}):
        _same(Topology.best_available(2, artifacts_dir=str(tmp_path), **kw),
              JTopology.best_available(2, artifacts_dir=str(tmp_path),
                                       **kw))
    R.write_probe_artifact([[None, 6.0], [None, None]], 2, str(tmp_path))
    t = Topology.best_available(2, artifacts_dir=str(tmp_path))
    _same(t, JTopology.best_available(2, artifacts_dir=str(tmp_path)))
    assert t.source == "history" and t.link_gbps(0, 1) == 6.0
    empty = str(tmp_path / "empty")
    assert Topology.best_available(4, artifacts_dir=empty).source == \
        "preset"


def test_multichip_writer_records_trace_source(tmp_path):
    # The repo's own MULTICHIP_r01-05 are TPU runs, none of them an
    # obs_link_matrix: no history, so a TPU number never prices or
    # orders a ring of cards.
    from tpu_p2p_torch.obs import ledger as TL
    from tpu_p2p_torch.obs.regress import write_multichip_artifact

    names = sorted(f for f in os.listdir(REPO)
                   if f.startswith("MULTICHIP_r"))
    assert names, "the repo's MULTICHIP history is gone"
    assert Topology.from_history(REPO) is None
    assert Topology.best_available(8, artifacts_dir=REPO).source == \
        "preset"
    led = TL.CollectiveLedger()
    with TL.recording(led):
        TL.record_issue("ppermute", "d", nbytes=1000, axis_size=2,
                        edges=[(0, 1), (1, 0)])
    join = TL.join_trace(led, [(
        "ncclDevKernel_SendRecv(x)", 0.0, 1e-4)])
    path = write_multichip_artifact(join, 2, str(tmp_path))
    with open(path) as fh:
        art = json.load(fh)
    assert art["source"] == "trace" and art["kind"] == "obs_link_matrix"
    t = Topology.from_history(str(tmp_path))
    assert t.source == "history" and t.provenance[0][1] == "trace"


def test_degraded_marks_and_views():
    t, j = Topology.preset_uniform(4, 100.0), JTopology.preset_uniform(4,
                                                                       100.0)
    flag = [{"src": 0, "dst": 1, "gbps": 1.0}]
    assert t.mark_degraded(flag) == j.mark_degraded(flag) == 1
    assert t.effective_gbps(0, 1) == pytest.approx(
        100.0 * DEGRADED_PENALTY)
    assert t.link_gbps(0, 1) == 100.0
    edges = [(0, 1), (2, 3)]
    for eff in (True, False):
        assert t.ship_time_s(1000, edges, effective=eff) == \
            j.ship_time_s(1000, edges, effective=eff)
        assert t.bottleneck_edge(edges, effective=eff) == \
            j.bottleneck_edge(edges, effective=eff)
    assert t.ship_time_s(1000, edges) > t.ship_time_s(1000, edges,
                                                      effective=False)
    again = [{"src": 0, "dst": 1}, {"src": 9, "dst": 1}]
    assert t.mark_degraded(again) == j.mark_degraded(again) == 0


def test_worst_links_sorts_degraded_first():
    t, j = Topology.preset_uniform(3, 100.0), JTopology.preset_uniform(3,
                                                                       100.0)
    for m in (t, j):
        m.gbps[1][2] = 40.0
        m.mark_degraded([{"src": 2, "dst": 0}])
    assert t.worst_links(2) == j.worst_links(2)
    assert t.worst_links(2)[0][:2] == (2, 0)
    assert t.fleet_median() == j.fleet_median()


# ------------------------------------------------- ring-order search


def _rand(n, seed):
    rng = np.random.default_rng(seed)
    mat = rng.uniform(1.0, 100.0, (n, n)).tolist()
    for i in range(n):
        mat[i][i] = None
    return Topology.from_matrix(mat, "probe"), \
        JTopology.from_matrix(mat, "probe")


@pytest.mark.parametrize("n,seed", [(4, 0), (5, 1), (6, 2), (6, 3)])
def test_ring_order_matches_brute_force(n, seed):
    t, j = _rand(n, seed)
    got = PL.ring_order(t)
    assert got == JPL.ring_order(j)
    assert got[0] == 0 and sorted(got) == list(range(n))
    best = max(PL.ring_min_gbps(t, (0,) + p)
               for p in itertools.permutations(range(1, n)))
    assert PL.ring_min_gbps(t, got) == pytest.approx(best)
    assert PL.ring_order(t, exact_max=0) == JPL.ring_order(j, exact_max=0)


def test_ring_order_avoids_slow_edge_and_greedy_never_hurts():
    t, j = Topology.preset_uniform(8, 100.0), JTopology.preset_uniform(8,
                                                                       100.0)
    t.gbps[3][4] = j.gbps[3][4] = 1.0
    exact = PL.ring_order(t)
    assert exact == JPL.ring_order(j)
    assert (3, 4) not in PL.ring_order_edges(exact)
    assert PL.ring_min_gbps(t, exact) == 100.0
    greedy = PL.ring_order(t, exact_max=0)
    assert greedy == JPL.ring_order(j, exact_max=0)
    assert PL.ring_min_gbps(t, greedy) >= PL.ring_min_gbps(
        t, tuple(range(8)))


def test_ring_order_identity_on_symmetric_meshes():
    assert PL.ring_order(Topology.preset_uniform(6)) == tuple(range(6))
    assert PL.ring_order(Topology.preset_ring(8)) == tuple(range(8))
    assert PL.ring_order(Topology.preset_uniform(2)) == (0, 1)
    assert PL.ring_order(Topology.preset_uniform(1)) == (0,)


def test_ordered_devices_validates_permutation():
    with pytest.raises(ValueError, match="permutation") as got:
        PL.ordered_devices([1, 2, 3], (0, 1))
    with pytest.raises(ValueError) as want:
        JPL.ordered_devices([1, 2, 3], (0, 1))
    assert str(got.value) == str(want.value)
    assert PL.ordered_devices(["a", "b", "c"], (2, 0, 1)) \
        == ["c", "a", "b"]


# --------------------------------------------- migration placement


def test_free_pages_first_is_the_legacy_rule():
    from tpu_p2p_torch.serve import disagg as TD

    for cands in ([(0, 3), (1, 7), (2, 7)], [(2, 5), (0, 5)], [(1, 1)]):
        assert PL.free_pages_first(1, cands, 0) == \
            JPL.free_pages_first(1, cands, 0)
    assert PL.free_pages_first(1, [(0, 3), (1, 7), (2, 7)], 0) == 1
    # disagg takes its default from the topology module
    assert not hasattr(TD, "free_pages_first")
    b = TD.DisaggBatcher(None, None, None, slots=4, prefill_slots=2,
                         page_len=8, num_pages=14, prefill_pages=19,
                         max_blocks=3, chunk=4, dry=True,
                         n_decode_shards=2)
    assert b.placement is PL.free_pages_first


def test_topo_policy_prefers_fast_links_then_pages():
    def pair(n, g=100.0):
        return Topology.preset_uniform(n, g), JTopology.preset_uniform(n, g)

    t, j = pair(4)
    t.gbps[1][2] = j.gbps[1][2] = 1.0
    cases = ([(0, 5), (1, 5)], [(0, 5), (1, 9)], [(0, 9), (1, 1)])
    for cands in cases:
        assert PL.topo_migration_placement(t, 2)(1, cands, 4096) == \
            JPL.topo_migration_placement(j, 2)(1, cands, 4096)
    assert PL.topo_migration_placement(t, 2)(1, [(0, 5), (1, 5)],
                                             4096) == 1
    u = Topology.preset_uniform(4)
    assert PL.topo_migration_placement(u, 2)(1, [(0, 5), (1, 9)], 4096) == 1
    assert PL.topo_migration_placement(u, 2)(1, [(0, 5), (1, 5)], 4096) == 0
    t2, j2 = pair(4)
    for m in (t2, j2):
        m.mark_degraded([{"src": 0, "dst": 2}])
    assert PL.topo_migration_placement(t2, 2)(1, [(0, 9), (1, 1)],
                                              4096) == 1 == \
        JPL.topo_migration_placement(j2, 2)(1, [(0, 9), (1, 1)], 4096)
    assert PL.migration_edges(2, 1) == JPL.migration_edges(2, 1)
    assert PL.predict_migrate_time_s(t, 2, 0, 4096) == \
        JPL.predict_migrate_time_s(j, 2, 0, 4096)


def test_rank_decode_shards_orders_by_predicted_gbps():
    t, j = Topology.preset_uniform(4, 100.0), JTopology.preset_uniform(4,
                                                                       100.0)
    t.gbps[0][2] = j.gbps[0][2] = 2.0
    ranked = PL.rank_decode_shards(t, 2, 2, 1 << 20)
    assert ranked == JPL.rank_decode_shards(j, 2, 2, 1 << 20)
    assert [s for s, _ in ranked] == [1, 0]


# -------------------------------------------- per-link tick pricing


def test_price_program_unchanged_without_topology():
    from tpu_p2p.models import schedule as JS
    from tpu_p2p_torch.models import schedule as SCH

    bill = SCH.price_program(SCH.compile_1f1b(2, 4), 1024)
    assert bill == JS.price_program(JS.compile_1f1b(2, 4), 1024)
    assert "hop_s_total" not in bill and "topology_source" not in bill
    assert all("hop_s" not in r for r in bill["rows"])


def test_price_program_bills_per_link():
    from tpu_p2p.models import schedule as JS
    from tpu_p2p_torch.models import schedule as SCH

    t, j = Topology.preset_uniform(4, 100.0), JTopology.preset_uniform(4,
                                                                       100.0)
    t.gbps[2][3] = j.gbps[2][3] = 1.0
    bill = SCH.price_program(SCH.compile_zb(2, 4), 1024, topology=t)
    assert bill == JS.price_program(JS.compile_zb(2, 4), 1024, topology=j)
    base = SCH.price_program(SCH.compile_zb(2, 4), 1024)
    assert bill["wire_bytes_total"] == base["wire_bytes_total"]
    assert bill["topology_source"] == "preset"
    assert bill["bottleneck_gbps_min"] == 1.0
    fwd = [r for r in bill["rows"] if r["payload"] == "activation"]
    assert fwd and all(r["bottleneck_edge"] == (2, 3) for r in fwd)


# ----------------------------------------------- the world of 8 ranks


def _flagship_cases():
    """The reference's four parity meshes as (dp, pp, sp, tp, ep) dims,
    with conftest's tiny flagship config and seeded numpy inputs."""
    from tpu_p2p.models import flagship as JF

    out = []
    for name, dims, kw in (
            ("pp4", (1, 4, 1, 1, 1), dict(stages=4, microbatches=4)),
            ("dp4", (4, 1, 1, 1, 1), {}),
            ("dp2tp2", (2, 1, 1, 2, 1), {}),
            ("dp2pp2sp2", (2, 2, 2, 1, 1), {})):
        cfg = conftest.flagship_cfg(**kw)
        params = {k: np.asarray(v)
                  for k, v in JF.init_flagship_params(cfg).items()}
        rng = np.random.default_rng(1)
        shape = (cfg.batch, cfg.seq, cfg.model_dim)
        batch = tuple(rng.standard_normal(shape).astype(np.float32)
                      for _ in range(2))
        cfg_kw = {f: getattr(cfg, f) for f in (
            "batch", "seq", "heads", "head_dim", "stages", "microbatches",
            "num_experts", "capacity_factor")}
        out.append({"name": name, "dims": dims, "cfg": cfg_kw,
                    "params": params, "batch": batch})
    return out


@pytest.fixture(scope="module")
def world():
    cfg, params, x, target = conftest.pipeline_setup(stages=8, m=4)
    problem = {"cfg": {"d_model": cfg.d_model, "d_ff": cfg.d_ff,
                       "stages": cfg.stages,
                       "microbatches": cfg.microbatches},
               "params": {k: np.asarray(v) for k, v in params.items()},
               "batch": (np.asarray(x), np.asarray(target))}
    got = run_world(8, f"{WORLD}:topo_case",
                    {"flagship_cases": _flagship_cases(),
                     "pipeline_problem": problem,
                     "probe_kw": {"msg_bytes": 128 * 1024, "iters": 4,
                                  "repeats": 2}}, timeout=400)
    return got[0]


def test_throttled_probe_routes_ring_and_migrations(world):
    from tpu_p2p_torch.obs.health import detect_degraded_links

    mat = world["probe"]
    topo = Topology.from_matrix(mat, "probe")
    flags = detect_degraded_links(mat)
    assert any(f["src"] == 1 and f["dst"] == 2 for f in flags)
    topo.mark_degraded(flags)
    order = PL.ring_order(topo)
    assert (1, 2) not in PL.ring_order_edges(order)
    assert PL.ring_min_gbps(topo, order, effective=False) \
        > PL.ring_min_gbps(topo, tuple(range(4)), effective=False)
    pol = PL.topo_migration_placement(topo, 2)
    assert pol(1, [(0, 5), (1, 5)], 4096) == 1
    # The reference's optimizers on the port's measured matrix decide
    # alike.
    jt = JTopology.from_matrix(mat, "probe")
    jt.mark_degraded(flags)
    assert JPL.ring_order(jt) == order


@pytest.mark.slow  # the full graded smoke, as the reference marks its own
def test_topo_smoke_full():
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_p2p_torch", "topo", "--cpu-mesh", "8",
         "--smoke"], cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["ok"] and res["topo_route_gain"] > 1.0
    assert res["topo_migrate_gbps_gain"] > 1.0
    assert "token streams bitwise OK" in proc.stdout
    assert "dry==real migration events OK" in proc.stdout


# The meshes whose every sum has at most two members. The library's
# all-reduce adds in group-rank order, so a reordered mesh reassociates a
# sum over more ranks (dp 4; the dp x sp gradient plane of 4): there the
# step is equal to float32 reassociation, not bitwise.
_BITWISE = {"pp4": True, "dp4": False, "dp2tp2": True, "dp2pp2sp2": False}


@pytest.mark.parametrize("name", ["pp4", "dp4", "dp2tp2", "dp2pp2sp2"])
def test_flagship_step_bitwise_under_reordered_mesh(world, name):
    got = world["flagship"][name]
    (l_n, p_n), (l_t, p_t) = got["naive"], got["topo"]
    if _BITWISE[name]:
        assert l_n == l_t
        for k in p_n:
            np.testing.assert_array_equal(p_n[k], p_t[k], err_msg=k)
        return
    assert l_n == pytest.approx(l_t, rel=1e-6)
    for k in p_n:
        np.testing.assert_allclose(p_n[k], p_t[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_make_runtime_threads_ring_order_and_step_stays_bitwise(world):
    rt = world["runtime"]
    t = Topology.preset_uniform(8, 100.0)
    t.gbps[3][4] = 1.0
    j = JTopology.preset_uniform(8, 100.0)
    j.gbps[3][4] = 1.0
    assert rt["order"] == JPL.ring_order(j) != tuple(range(8))
    assert rt["topo_ranks"] == rt["order"]
    assert rt["raw_ranks"] == tuple(range(8))
    (l_t, p_t), (l_r, p_r) = rt["topo"], rt["raw"]
    assert l_t == l_r
    for k in p_r:
        np.testing.assert_array_equal(p_t[k], p_r[k], err_msg=k)


def test_make_runtime_ring_order_leaves_small_and_2d_worlds_alone(world):
    from tpu_p2p_torch.parallel import runtime as RT

    rt = world["runtime"]
    assert rt["two_d"] == tuple(range(8))
    assert rt["mismatch"] == tuple(range(8))
    assert rt["default"] == tuple(range(8))  # no history unless asked
    assert rt["history"] == tuple(range(8))  # the repo's files: none
    t = Topology.preset_uniform(8, 100.0)
    t.gbps[3][4] = 1.0
    assert RT._ring_ordered(8, t) == rt["order"]
    assert RT._ring_ordered(8, Topology.preset_uniform(4)) == \
        tuple(range(8))
    one = RT.make_runtime(device="cpu", ring_topology=t)  # a world of 1
    try:
        assert one.mesh.ranks == (0,)
    finally:
        one.close()


@pytest.mark.parametrize("arm", ["topo", "raw"])
def test_reductions_patterns_and_capture_on_a_reordered_mesh(world, arm):
    red = world["reductions"]
    assert red["ranks"] == world["runtime"]["order"] != tuple(range(8))
    got = red[arm]
    assert len(got["verdicts"]) == 8
    for rank, verdicts in enumerate(got["verdicts"]):
        assert len(verdicts) == 8 and all(verdicts.values()), (rank,
                                                               verdicts)
    for pattern in ("allreduce", "reduce_scatter", "all_gather",
                    "all_to_all"):
        assert got["text"].count(f"{pattern} 1KiB") == 2, got["text"]
    # The ledger's totals do not depend on which rank sits where.
    assert got["totals"] == red["raw"]["totals"]
    assert got["totals"]


def test_wave_and_allgather_ring_bitwise_under_reordered_mesh(world):
    assert world["parity"] == {"xla": [True, True],
                               "pallas_dma": [True, True]}
    assert world["parity_log"].count("bitwise OK under reordered mesh") \
        == 4


# -------------------------- migration placement: dry == real events


def _serve_setup():
    from tpu_p2p.config import ServeConfig as JServeConfig
    from tpu_p2p.models import flagship as JF
    from tpu_p2p_torch.config import ServeConfig
    from tpu_p2p_torch.models import flagship as F

    sc_kw = dict(slots=4, page_len=8, num_pages=2 * (2 * 3 + 1),
                 max_blocks=3, chunk=4, requests=5, seed=0, rate=1.0,
                 prompt_len=(4, 12), gen_len=(4, 8), vocab=64, disagg=True,
                 prefill_tp=2, prefill_slots=2,
                 prefill_pages=(2 + 4) * 3 + 1)
    cfg_kw = dict(batch=4, seq=16, heads=4, kv_heads=2, head_dim=8,
                  stages=2, microbatches=1, num_experts=2,
                  capacity_factor=2.0, vocab=64, norm=True, rope=True)
    return (ServeConfig(**sc_kw), JServeConfig(**sc_kw),
            F.FlagshipConfig(**cfg_kw), JF.FlagshipConfig(**cfg_kw))


def test_topo_placement_dry_equals_real_and_token_parity():
    from tpu_p2p.models import flagship as JF
    from tpu_p2p.serve import disagg as JD
    from tpu_p2p.serve.engine import synthetic_trace as j_trace
    from tpu_p2p_torch.models import flagship as F
    from tpu_p2p_torch.serve import disagg as TD
    from tpu_p2p_torch.serve.engine import synthetic_trace

    sc, jsc, cfg, jcfg = _serve_setup()
    topo = Topology.preset_uniform(4, 100.0)
    topo.gbps[1][2] = 1.0
    jtopo = JTopology.preset_uniform(4, 100.0)
    jtopo.gbps[1][2] = 1.0
    policy = PL.topo_migration_placement(topo, 2)
    trace = synthetic_trace(sc)
    seeded = JF.init_flagship_params(jcfg)
    params = F.params_from_numpy({k: np.asarray(v)
                                  for k, v in seeded.items()}, "cpu")
    _, _, mig = TD.build_disagg_meshes(2, ["cpu"] * 4)
    runs = {label: TD.run_disagg_engine(mig, cfg, params, trace, sc=sc,
                                        placement=place)
            for label, place in (("naive", None), ("topo", policy))}
    dry = TD.simulate_disagg_schedule(
        trace, slots=sc.slots, prefill_slots=sc.prefill_slots,
        page_len=sc.page_len, num_pages=sc.num_pages,
        prefill_pages=sc.prefill_pages, max_blocks=sc.max_blocks,
        chunk=sc.chunk, n_decode_shards=2, placement=policy, cfg=cfg)
    assert dry["migrate_events"] == runs["topo"]["migrate_events"]
    topo_shards = [e["dst_shard"] for e in runs["topo"]["migrate_events"]]
    naive_shards = [e["dst_shard"]
                    for e in runs["naive"]["migrate_events"]]
    assert topo_shards and topo_shards != naive_shards
    assert topo_shards.count(0) < naive_shards.count(0)
    want = {r.rid: list(r.generated) for r in runs["naive"]["finished"]}
    got = {r.rid: list(r.generated) for r in runs["topo"]["finished"]}
    assert got == want and got
    # The reference's dry schedule under its own policy places alike.
    jdry = JD.simulate_disagg_schedule(
        j_trace(jsc), slots=sc.slots, prefill_slots=sc.prefill_slots,
        page_len=sc.page_len, num_pages=sc.num_pages,
        prefill_pages=sc.prefill_pages, max_blocks=sc.max_blocks,
        chunk=sc.chunk, n_decode_shards=2,
        placement=JPL.topo_migration_placement(jtopo, 2), cfg=jcfg)
    assert jdry["migrate_events"] == dry["migrate_events"]


def test_default_placement_unchanged_without_topology():
    from tpu_p2p.serve.batcher import Request as JRequest
    from tpu_p2p.serve.disagg import simulate_disagg_schedule as j_sim
    from tpu_p2p_torch.serve.batcher import Request
    from tpu_p2p_torch.serve.disagg import simulate_disagg_schedule

    def _trace(cls):
        rng = np.random.default_rng(0)
        return [cls(rid=i, prompt=rng.integers(0, 64, 6).astype(np.int32),
                    max_new=4, arrival_step=i) for i in range(5)]

    kw = dict(slots=4, prefill_slots=2, page_len=8, num_pages=14,
              prefill_pages=19, max_blocks=3, chunk=4, n_decode_shards=2)
    a = simulate_disagg_schedule(_trace(Request), **kw)
    b = simulate_disagg_schedule(_trace(Request),
                                 placement=PL.free_pages_first, **kw)
    assert a["migrate_events"] == b["migrate_events"]
    assert a["steps"] == b["steps"]
    assert a["migrate_events"] == j_sim(_trace(JRequest),
                                        **kw)["migrate_events"]


# --------------------------------------------------------------- CLI


def test_cli_preset_ring_matches_golden():
    from test_cli_golden import mask_floats

    proc = subprocess.run(
        [sys.executable, "-m", "tpu_p2p_torch", "topo", "--cpu-mesh", "8",
         "--preset", "ring"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    with open(GOLDEN) as fh:
        assert mask_floats(proc.stdout) == fh.read()
    # The same render in-process, for the uniform preset, equals the
    # reference's render of the same model.
    from tpu_p2p.topo.cli import render_topology as j_render
    from tpu_p2p_torch.topo.cli import render_topology

    t, j = Topology.preset_uniform(5, 50.0), JTopology.preset_uniform(5,
                                                                      50.0)
    t.gbps[2][3] = j.gbps[2][3] = 5.0
    t.mark_degraded([{"src": 2, "dst": 3}])
    j.mark_degraded([{"src": 2, "dst": 3}])
    a, b = io.StringIO(), io.StringIO()
    render_topology(t, payload_bytes=1 << 20, stream=a)
    j_render(j, payload_bytes=1 << 20, stream=b)
    assert a.getvalue() == b.getvalue()
    assert not math.isnan(t.fleet_median())
