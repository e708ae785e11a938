"""The port's Chrome-trace exporter (``tpu_p2p_torch/obs/trace.py``)
against the reference's (``tpu_p2p/obs/trace.py``) on equal input: the
written JSON must be equal apart from ``otherData.exporter``, the
validator must report the same problems, and ``serve --trace PATH``
through the port's CLI must write a trace the validator accepts."""

import copy
import json
import os

import pytest

from tpu_p2p.obs import trace as JT
from tpu_p2p_torch.obs import trace as TT

FIXTURE = os.path.join(os.path.dirname(__file__), "golden",
                       "serve_obs_fixture.jsonl")

_REUSE = [
    {"obs": "request", "id": 0, "enqueue_step": 0,
     "prefill_start_step": 0, "prefill_done_step": 1,
     "first_token_step": 1, "finish_step": 5, "outcome": "finished"},
    {"obs": "request", "id": 1, "enqueue_step": 0,
     "prefill_start_step": 1, "prefill_done_step": 2,
     "first_token_step": 2, "finish_step": 6, "outcome": "finished"},
    {"obs": "serve_reuse", "kind": "prefix_hit", "rid": 1, "step": 0,
     "pages": 6, "tokens": 48},
    {"obs": "serve_reuse", "kind": "spec_accept", "rid": 0, "step": 3,
     "drafted": 3, "accepted": 3},
    {"obs": "serve_reuse", "kind": "spec_reject", "rid": 1, "step": 4,
     "drafted": 3, "accepted": 0},
    {"obs": "serve_reuse", "kind": "prefix_hit", "rid": 99, "step": 2,
     "pages": 1, "tokens": 8},
]

_TICKS = [
    {"rank": 0, "tick": 0, "start": 5.0, "compute_end": 5.002,
     "end": 5.003, "kind": "fwd"},
    {"rank": 0, "tick": 1, "start": 5.003, "compute_end": 5.006,
     "end": 5.009, "kind": "bwd_input"},
    {"rank": 1, "tick": 0, "start": 5.001, "compute_end": 5.004,
     "end": 5.005, "kind": "noop"},
]

_LINKS = [{"name": "collective-permute.1", "t0": 10.0, "t1": 10.5,
           "kind": "ppermute", "wire_bytes": 4096, "tick": 3},
          {"name": "collective-permute.2", "t0": 10.2, "t1": 10.9,
           "kind": "ppermute"}]

_UNATTR = [("fusion.7", 10.1, 10.4), ("copy.2", 10.0, 10.05)]


def _sections(case):
    """The writer's keyword sections of each case of the reference's
    own exporter tests."""
    if case == "fixture":
        return {"obs_records": JT.load_obs_records(FIXTURE),
                "meta": {"source": "serve"}}
    if case == "fixture_nometa":
        return {"obs_records": JT.load_obs_records(FIXTURE)}
    if case == "reuse":
        return {"obs_records": _REUSE}
    if case == "ticks":
        return {"tick_spans": _TICKS}
    if case == "links":
        return {"link_events": _LINKS, "unattributed": _UNATTR}
    if case == "all":
        return {"tick_spans": _TICKS, "link_events": _LINKS,
                "unattributed": _UNATTR,
                "obs_records": JT.load_obs_records(FIXTURE) + _REUSE,
                "meta": {"source": "all", "run": 3}}
    raise KeyError(case)


@pytest.mark.parametrize("case", ["fixture", "fixture_nometa", "reuse",
                                  "ticks", "links", "all"])
def test_chrome_trace_equals_reference(case, tmp_path):
    want = JT.write_chrome_trace(str(tmp_path / "ref.json"),
                                 **copy.deepcopy(_sections(case)))
    got = TT.write_chrome_trace(str(tmp_path / "port.json"),
                                **copy.deepcopy(_sections(case)))
    assert got["otherData"].pop("exporter") == "tpu_p2p_torch.obs.trace"
    assert want["otherData"].pop("exporter") == "tpu_p2p.obs.trace"
    assert got == want
    with open(tmp_path / "port.json") as fh:
        on_disk = json.load(fh)
    on_disk["otherData"].pop("exporter")
    assert on_disk == want
    assert TT.validate_chrome_trace(str(tmp_path / "port.json")) == []


def test_loader_and_lanes_equal_reference():
    assert TT.load_obs_records(FIXTURE) == JT.load_obs_records(FIXTURE)
    reqs = [r for r in TT.load_obs_records(FIXTURE)
            if r["obs"] == "request"]
    assert TT.serve_lanes(reqs) == JT.serve_lanes(reqs) \
        == {0: 0, 1: 1, 2: 2, 3: 0}
    assert TT.SPAN_KINDS == ("data", "gather", "forward", "backward",
                             "optimizer", "step", "eval", "checkpoint")


def _good():
    return {"traceEvents": [
        {"name": "process_name", "ph": "M", "pid": 1, "tid": 0, "ts": 0,
         "args": {"name": "p"}},
        {"name": "a", "cat": "c", "ph": "X", "pid": 1, "tid": 0,
         "ts": 0.0, "dur": 5.0},
        {"name": "b", "cat": "c", "ph": "X", "pid": 1, "tid": 0,
         "ts": 5.0, "dur": 1.0},
    ]}


def _corrupt(kind):
    t = _good()
    ev = t["traceEvents"]
    if kind == "good":
        pass
    elif kind == "missing_ts":
        del ev[1]["ts"]
    elif kind == "negative_ts":
        ev[2]["ts"] = -1.0
    elif kind == "not_monotonic":
        ev[1]["ts"] = 9.0
    elif kind == "unclosed":
        ev.append({"name": "x", "cat": "link", "ph": "b", "id": 1,
                   "pid": 1, "tid": 0, "ts": 6.0})
    elif kind == "end_only":
        ev.append({"name": "x", "cat": "link", "ph": "e", "id": 2,
                   "pid": 1, "tid": 0, "ts": 6.0})
    elif kind == "undeclared_pid":
        ev[1]["pid"] = 9
    elif kind == "duplicate_meta":
        ev.append(dict(ev[0]))
    elif kind == "negative_dur":
        ev[1]["dur"] = -1.0
    elif kind == "empty":
        t = {"traceEvents": []}
    elif kind == "no_events":
        t = {}
    return t


@pytest.mark.parametrize("kind", [
    "good", "missing_ts", "negative_ts", "not_monotonic", "unclosed",
    "end_only", "undeclared_pid", "duplicate_meta", "negative_dur",
    "empty", "no_events"])
def test_validator_equals_reference(kind):
    got = TT.validate_chrome_trace(_corrupt(kind))
    assert got == JT.validate_chrome_trace(_corrupt(kind))
    assert (got == []) == (kind == "good")


def test_validator_unreadable_path(tmp_path):
    probs = TT.validate_chrome_trace(str(tmp_path / "missing.json"))
    assert len(probs) == 1 and "unreadable" in probs[0]
