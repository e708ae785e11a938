"""The port's training slice against the JAX reference on a one-device
mesh: the LM and MSE SGD steps, the SGD update's dtype promotion, the
LM forward, the batch streams, the device loader, the ``train`` CLI and
its "not ported yet" flags.

Inputs come from numpy seeds; params come from the same seeded init
(bitwise equal on both sides, tests/test_torch_model.py). Tolerances
are the reference's own for flash vs dense steps
(tests/test_flash_train.py): loss ``rtol 1e-5``, params ``atol = rtol =
2e-5`` — float32 reassociation between XLA's and ATen's CPU matmuls and
between tiled and whole-row attention sums. Host logic (batches, keys)
is exact, and the bf16 SGD update is bitwise.
"""

import contextlib
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

from tpu_p2p import train as JT
from tpu_p2p.models import flagship as JF
from tpu_p2p.models.flagship_steps import _sgd_update as j_sgd_update
from tpu_p2p_torch import train as TT
from tpu_p2p_torch.models import flagship as TF
from tpu_p2p_torch.utils.data import DeviceLoader

REPO = pathlib.Path(__file__).resolve().parents[1]
LOSS = dict(rtol=1e-5)
PARAMS = dict(atol=2e-5, rtol=2e-5)
LM = dict(batch=4, seq=32, heads=4, kv_heads=2, head_dim=8, stages=2,
          microbatches=2, dense_ffn=True, rope=True, norm=True, vocab=64)
MSE = dict(batch=4, seq=16, heads=4, kv_heads=2, head_dim=8, stages=2,
           microbatches=2, dense_ffn=True, rope=True, norm=True)


def _mesh1():
    return JF.build_mesh(1, devices=jax.devices()[:1])


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _tokens(cfg, seed):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, (cfg.batch, cfg.seq + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _assert_params_close(got, want):
    assert sorted(got) == sorted(want)  # jit returns dicts key-sorted
    for k in want:
        np.testing.assert_allclose(got[k].detach().float().numpy(),
                                   np.asarray(want[k], np.float32),
                                   err_msg=k, **PARAMS)


# ------------------------------------------------------------ LM step


@pytest.mark.parametrize("use_flash,window", [(False, 0), (True, 0),
                                              (True, 12), (False, 12)],
                         ids=["dense", "flash", "flash_window12",
                              "dense_window12"])
def test_lm_train_steps_match_reference(use_flash, window):
    kw = {**LM, "use_flash": use_flash, "attn_window": window}
    jcfg, tcfg = JF.FlagshipConfig(**kw), TF.FlagshipConfig(**kw)
    mesh = _mesh1()
    jstep = JF.make_flagship_lm_train_step(mesh, jcfg, lr=1e-2)
    tstep = TF.make_flagship_lm_train_step(tcfg, lr=1e-2)
    jp = JF.place_flagship_params(JF.init_flagship_params(jcfg, seed=0),
                                  mesh, jcfg)
    tp = TF.init_flagship_params(tcfg, seed=0, device="cpu")
    for step in range(3):
        x, t = _tokens(jcfg, 10 + step)
        jp, jl = jstep(jp, jnp.asarray(x), jnp.asarray(t))
        tp, tl = tstep(tp, torch.from_numpy(x), torch.from_numpy(t))
        np.testing.assert_allclose(float(tl), float(jl), err_msg=str(step),
                                   **LOSS)
        if step in (0, 2):  # one step and three steps
            _assert_params_close(tp, _np(jp))


def test_lm_forward_matches_reference():
    cfg_kw = {**LM, "use_flash": True, "attn_window": 12}
    jcfg, tcfg = JF.FlagshipConfig(**cfg_kw), TF.FlagshipConfig(**cfg_kw)
    mesh = _mesh1()
    params = JF.init_flagship_params(jcfg, seed=1)
    x, _ = _tokens(jcfg, 3)
    want = JF.make_flagship_lm_forward(mesh, jcfg)(
        JF.place_flagship_params(params, mesh, jcfg), jnp.asarray(x))
    got = TF.make_flagship_lm_forward(tcfg)(
        TF.params_from_numpy(_np(params), "cpu"), torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, 32, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


# ----------------------------------------------------------- MSE step


@pytest.mark.parametrize("use_flash", [False, True], ids=["dense", "flash"])
def test_mse_train_steps_match_reference(use_flash):
    kw = {**MSE, "use_flash": use_flash}
    jcfg, tcfg = JF.FlagshipConfig(**kw), TF.FlagshipConfig(**kw)
    mesh = _mesh1()
    jstep = JF.make_flagship_train_step(mesh, jcfg, lr=1e-2)
    tstep = TF.make_flagship_train_step(tcfg, lr=1e-2)
    jp = JF.place_flagship_params(JF.init_flagship_params(jcfg, seed=2),
                                  mesh, jcfg)
    tp = TF.init_flagship_params(tcfg, seed=2, device="cpu")
    for step in range(2):
        x, t = JF.flagship_host_batch(jcfg, np.random.default_rng(step))
        tx, tt = TF.flagship_host_batch(tcfg, np.random.default_rng(step))
        np.testing.assert_array_equal(tx.numpy(), x)
        np.testing.assert_array_equal(tt.numpy(), t)
        jp, jl = jstep(jp, jnp.asarray(x), jnp.asarray(t))
        tp, tl = tstep(tp, tx, tt)
        np.testing.assert_allclose(float(tl), float(jl), **LOSS)
        _assert_params_close(tp, _np(jp))


def test_mse_step_donate_updates_in_place():
    cfg = TF.FlagshipConfig(**MSE)
    params = TF.init_flagship_params(cfg, seed=2, device="cpu")
    before = {k: v.clone() for k, v in params.items()}
    x, t = TF.flagship_host_batch(cfg, np.random.default_rng(0))
    fresh, _ = TF.make_flagship_train_step(cfg)(params, x, t)
    assert all(torch.equal(params[k], before[k]) for k in params)
    donated, _ = TF.make_flagship_train_step(cfg, donate=True)(params, x, t)
    assert donated is params
    for k in params:
        assert torch.equal(params[k], fresh[k])


# ------------------------------------------------- the bf16 SGD update


@pytest.mark.parametrize("param_dtype", ["bfloat16", "float32"])
def test_sgd_update_promotion_is_bitwise_reference(param_dtype):
    # One bf16 LM step of the reference gives real bf16 grads; both
    # updates then see the same params and grads. With f32 masters the
    # grads are made bf16 by hand, so the bf16 rounding of lr*g/denom
    # (and of lr and denom) shows in the f32 result.
    kw = {**LM, "dtype": "bfloat16", "use_flash": True}
    jcfg = JF.FlagshipConfig(**kw)
    mesh = _mesh1()
    params = JF.place_flagship_params(JF.init_flagship_params(jcfg, seed=0),
                                      mesh, jcfg)
    x, t = _tokens(jcfg, 5)
    grads, _ = JF.make_flagship_lm_grad_fn(mesh, jcfg)(
        params, jnp.asarray(x), jnp.asarray(t))
    assert all(g.dtype == jnp.bfloat16 for g in grads.values())
    params = {k: v.astype(param_dtype) for k, v in params.items()}
    denom = jcfg.batch * jcfg.seq * 3  # not a power of two
    want = _np(j_sgd_update(params, grads, 1e-2, denom))
    tparams = TF.params_from_numpy(_np(params), "cpu")
    tgrads = TF.params_from_numpy(_np(grads), "cpu")
    got = TF._sgd_update(tparams, tgrads, 1e-2, denom)
    for k in want:
        assert got[k].dtype == tparams[k].dtype
        g = got[k].float().numpy()
        np.testing.assert_array_equal(g, np.asarray(want[k], np.float32),
                                      err_msg=k)
    if param_dtype == "float32":
        # A Python-scalar lr would round differently: the pin matters.
        naive = (tparams["wq"] - 1e-2 * tgrads["wq"] / denom).numpy()
        assert not np.array_equal(naive, want["wq"])


def test_bf16_lm_step_matches_reference_loss():
    # One bf16 step end to end: the loss agrees to bf16 accuracy (the
    # two frameworks round bf16 activations at different places).
    kw = {**LM, "dtype": "bfloat16", "use_flash": True}
    jcfg, tcfg = JF.FlagshipConfig(**kw), TF.FlagshipConfig(**kw)
    mesh = _mesh1()
    jp = JF.place_flagship_params(JF.init_flagship_params(jcfg, seed=0),
                                  mesh, jcfg)
    tp = TF.init_flagship_params(tcfg, seed=0, device="cpu")
    x, t = _tokens(jcfg, 5)
    _, jl = JF.make_flagship_lm_train_step(mesh, jcfg)(
        jp, jnp.asarray(x), jnp.asarray(t))
    new, tl = TF.make_flagship_lm_train_step(tcfg)(
        tp, torch.from_numpy(x), torch.from_numpy(t))
    assert all(v.dtype == torch.bfloat16 for v in new.values())
    np.testing.assert_allclose(float(tl), float(jl), rtol=2e-2)


# ------------------------------------------------ data and the loader


@pytest.mark.parametrize("kw", [LM, MSE], ids=["tokens", "regression"])
def test_per_step_batches_are_the_reference_stream(kw):
    jcfg, tcfg = JF.FlagshipConfig(**kw), TF.FlagshipConfig(**kw)
    jsrc = JT._per_step_batches(jcfg, 7, 3)
    tsrc = TT._per_step_batches(tcfg, 7, 3)
    for _ in range(3):
        for j, t in zip(next(jsrc), next(tsrc)):
            t = t.numpy() if isinstance(t, torch.Tensor) else t
            assert t.dtype == j.dtype and t.shape == j.shape
            assert t.tobytes() == np.ascontiguousarray(j).tobytes()


def test_token_batch_matches_reference():
    jcfg, tcfg = JF.FlagshipConfig(**LM), TF.FlagshipConfig(**LM)
    jx, jt = JF.flagship_token_batch(jcfg, seed=4)
    tx, tt = TF.flagship_token_batch(tcfg, seed=4)
    assert tx.dtype == torch.int32
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_device_loader_prefetches_and_defers_errors():
    def source():
        for i in range(3):
            yield np.full((2,), i, np.int32), torch.full((2,), float(i))
        raise RuntimeError("source broke")

    loader = DeviceLoader(source(), "cpu", prefetch=2)
    assert loader.in_flight == 0
    x, t = next(loader)
    assert loader.in_flight == 2
    assert isinstance(x, torch.Tensor) and x.tolist() == [0, 0]
    assert t.tolist() == [0.0, 0.0]
    assert [int(b[0][0]) for b in (next(loader), next(loader))] == [1, 2]
    with pytest.raises(RuntimeError, match="source broke"):
        next(loader)
    with pytest.raises(StopIteration):
        next(loader)
    with pytest.raises(ValueError, match="prefetch"):
        DeviceLoader(iter(()), "cpu", prefetch=0)


# ---------------------------------------------------------------- CLI

_ARGS = ["--steps", "4", "--log-every", "2", "--batch", "4", "--seq", "32",
         "--heads", "4", "--kv-heads", "2", "--head-dim", "8", "--stages",
         "2", "--microbatches", "2", "--dense-ffn", "--rope", "--norm",
         "--vocab", "64", "--flash"]


def test_train_cli_matches_reference_run_training():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_p2p_torch.train", "--device", "cpu",
         *_ARGS], capture_output=True, text=True, cwd=REPO, env=env,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [json.loads(s) for s in proc.stdout.splitlines()]
    got, summary = lines[:-1], lines[-1]["summary"]

    cfg = JF.FlagshipConfig(batch=4, seq=32, heads=4, kv_heads=2,
                            head_dim=8, stages=2, microbatches=2,
                            dense_ffn=True, rope=True, norm=True, vocab=64,
                            use_flash=True)
    buf = io.StringIO()
    out = JT.run_training(_mesh1(), cfg, steps=4, log_every=2,
                          log_stream=buf)
    want = [json.loads(s) for s in buf.getvalue().splitlines()]
    assert [r["step"] for r in got] == [r["step"] for r in want] == [2, 4]
    for g, w in zip(got, want):
        assert list(g) == list(w) == ["step", "loss", "wall_s",
                                      "tokens_per_s_wall"]
        np.testing.assert_allclose(g["loss"], w["loss"], **LOSS)
    out.pop("params")
    assert list(summary) == list(out)
    assert summary["steps_run"] == out["steps_run"] == 4
    np.testing.assert_allclose(summary["final_loss"], out["final_loss"],
                               **LOSS)


def test_train_cli_dispatch_and_log_file(tmp_path, capsys):
    from tpu_p2p_torch import cli as TCLI

    log = tmp_path / "train.jsonl"
    assert TCLI.main(["train", "--device", "cpu", *_ARGS[:2],
                      "--log-every", "1", *_ARGS[4:], "--log-jsonl",
                      str(log)]) == 0
    out = capsys.readouterr().out.splitlines()
    recs = [json.loads(s) for s in log.read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2, 3, 4]
    assert [json.loads(s) for s in out[:-1]] == recs
    assert json.loads(out[-1])["summary"]["steps_run"] == 4


_NOT_PORTED_ARGV = {
    "--heal": [], "--fault-degrade-edge": ["0:1"],
    "--fault-degrade-factor": ["4"], "--fault-slow-rank": ["0"],
    "--fault-slow-ms": ["5"], "--fault-lost-host": ["1"],
    "--obs-jsonl": ["obs.jsonl"], "--obs-window-step": ["2"],
    "--trace": ["t.json"],
}
# The tick-IR knobs parse and reach the config; the loop's GPipe step
# then refuses them with the reference's own error (exit 1), as the
# reference's loop does.
_GPIPE_REFUSED_ARGV = {"--pp-schedule": ["zb"], "--tick-lowering": ["switch"]}
# The overlap knobs run: on a world of one each axis has size 1, so each
# is the plain step, bitwise (the reference's size-1 degrade).
_OVERLAP_ARGV = {
    "--tp-overlap": ["ring"], "--ep-overlap": ["ring"],
    "--pp-overlap": ["wave"], "--pp-chunks": ["2"],
}


def test_not_ported_table_covers_every_rejected_flag():
    assert sorted(_NOT_PORTED_ARGV) == sorted(f for _, f in
                                              TT._FLAGS_NOT_PORTED)


def _reference_refusal(**cfg_kw) -> str:
    """The reference GPipe step's refusal of a tick-IR knob."""
    from tpu_p2p.models.flagship_steps import _reject_zb_schedule

    with pytest.raises(ValueError) as e:
        _reject_zb_schedule(JF.FlagshipConfig(**cfg_kw))
    return str(e.value)


@pytest.mark.parametrize("flag", sorted({**_NOT_PORTED_ARGV,
                                         **_GPIPE_REFUSED_ARGV}))
def test_train_cli_rejects_flags_not_ported(flag, capsys):
    if flag in _GPIPE_REFUSED_ARGV:
        argv = ["--device", "cpu", "--dense-ffn", flag,
                *_GPIPE_REFUSED_ARGV[flag]]
        assert TT.main(argv) == 1
        kw = {"--pp-schedule": {"pp_schedule": "zb"},
              "--tick-lowering": {"tick_lowering": "switch"}}[flag]
        assert f"Failed: ValueError '{_reference_refusal(**kw)}'" in \
            capsys.readouterr().err
        return
    argv = ["--device", "cpu", "--dense-ffn", flag, *_NOT_PORTED_ARGV[flag]]
    assert TT.main(argv) == 2
    err = capsys.readouterr().err
    assert flag in err and "not ported yet" in err


@pytest.fixture(scope="module")
def plain_summary():
    """The world-of-one run the overlap knobs are held to."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert TT.main(["--device", "cpu", *_ARGS]) == 0
    return json.loads(buf.getvalue().splitlines()[-1])["summary"]


@pytest.mark.parametrize("flag", sorted(_OVERLAP_ARGV))
def test_train_cli_runs_the_overlap_knobs(flag, plain_summary, capsys):
    argv = ["--device", "cpu", *_ARGS, flag, *_OVERLAP_ARGV[flag]]
    if flag == "--pp-chunks":
        argv += ["--pp-overlap", "wave"]
    assert TT.main(argv) == 0
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])["summary"]
    assert summary == plain_summary
    cfg = TT.config_from_args(TT._build_parser().parse_args(argv))
    want = {"--tp-overlap": ("tp_overlap", "ring"),
            "--ep-overlap": ("ep_overlap", "ring"),
            "--pp-overlap": ("pp_overlap", "wave"),
            "--pp-chunks": ("pp_chunks", 2)}[flag]
    assert getattr(cfg, want[0]) == want[1]


def test_train_cli_rejects_moe_and_a_missing_card(monkeypatch, capsys):
    # The MoE FFN (no --dense-ffn) is ported: a small run exits 0.
    assert TT.main(["--device", "cpu", "--batch", "2", "--seq", "16",
                    "--heads", "2", "--head-dim", "8", "--steps", "1",
                    "--log-every", "1"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert json.loads(out[-1])["summary"]["steps_run"] == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert TT.main(["--dense-ffn", "--steps", "1"]) == 1   # default: cuda
    assert "no CUDA device" in capsys.readouterr().err
    cfg = TF.FlagshipConfig(**LM)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.run_training(cfg, steps=1)


@pytest.mark.parametrize("name", sorted(TT._RUN_NOT_PORTED))
def test_run_training_rejects_keywords_not_ported(name):
    default = TT._RUN_NOT_PORTED[name]
    value = {None: "x", False: True, 0: 3, 0.0: 0.5}.get(default, "other")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        TT.run_training(TF.FlagshipConfig(**LM), steps=1, device="cpu",
                        **{name: value})


@pytest.mark.parametrize("name,good,bad", [
    ("tp_overlap", "ring", "rings"), ("ep_overlap", "ring", "Ring"),
    ("pp_overlap", "wave", "waves"), ("pp_chunks", 2, 0)])
def test_config_takes_the_overlap_knobs(name, good, bad):
    # Validated as the reference validates them
    # (tpu_p2p/models/flagship_config.py:244-267): the same message.
    assert getattr(TF.FlagshipConfig(**{name: good}), name) == good
    with pytest.raises(ValueError) as port:
        TF.FlagshipConfig(**{name: bad})
    with pytest.raises(ValueError) as ref:
        JF.FlagshipConfig(**{name: bad})
    assert str(port.value) == str(ref.value)
    assert getattr(TF.FlagshipConfig(), name) == getattr(
        JF.FlagshipConfig(), name)


@pytest.mark.parametrize("name", ["pp_schedule", "tick_lowering"])
def test_config_rejects_fields_not_ported(name):
    # Ported: the config takes the tick-IR knobs (the reference's
    # defaults and values), and the GPipe steps refuse them with the
    # reference's message (the tick-IR executor runs them).
    value = {"pp_schedule": "zb", "tick_lowering": "switch"}[name]
    cfg = TF.FlagshipConfig(dense_ffn=True, **{name: value})
    assert getattr(cfg, name) == value
    with pytest.raises(ValueError) as e:
        TF.make_flagship_train_step(cfg)
    assert str(e.value) == _reference_refusal(**{name: value})
    assert getattr(TF.FlagshipConfig(), name) == getattr(
        JF.FlagshipConfig(), name)
