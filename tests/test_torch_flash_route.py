"""The flash wrappers' launch path on the CPU, against a fake library.

``tpu_p2p_torch/ops/flash_attention.py`` sends bfloat16 to the
tensor-core kernels (``tp_flash_fwd_wgmma``, ``tp_flash_bwd_dkdv_wgmma``,
``tp_flash_bwd_dq_wgmma``) and float32 to the SIMT kernels
(``tp_flash_fwd``, ``tp_flash_bwd_dkdv``, ``tp_flash_bwd_dq``). A CPU
host cannot launch them, so these tests
stand a recording fake in for the built library and let CPU tensors
take the kernel path: which entry point each dtype reaches, the
arguments in the C order, the launch counts, and that what the kernels
cannot take raises before any launch. The kernels themselves are held
against their plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import contextlib
import ctypes

import pytest
import torch

from tpu_p2p_torch.ops import flash_attention as TFA

B, HQ, HKV, TQ, TK, D = 2, 4, 2, 24, 40, 32


class FakeLib:
    """Stands in for the built ``flash_attention`` library: each
    ``tp_flash_*`` entry point records its name and arguments and
    returns ``err``."""

    def __init__(self, err: int = 0):
        self.calls = []
        self.err = err

    def __getattr__(self, name):
        if not name.startswith("tp_flash_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return self.err

        return entry


@pytest.fixture
def fake(monkeypatch):
    """CPU tensors take the kernel path, into a fake library on a fake
    stream."""
    lib = FakeLib()
    monkeypatch.setattr(TFA, "_lib", lambda: lib)
    monkeypatch.setattr(TFA, "_on_card", lambda t: True)
    monkeypatch.setattr(TFA, "_card_stream",
                        lambda device: contextlib.nullcontext(77))
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "fake card")
    return lib


def _inputs(dtype, d=D, tq=TQ, tk=TK):
    g = torch.Generator().manual_seed(0)
    q = torch.randn((B * HQ, tq, d), generator=g).to(dtype)
    k, v = (torch.randn((B * HKV, tk, d), generator=g).to(dtype)
            for _ in range(2))
    do = torch.randn((B * HQ, tq, d), generator=g).to(dtype)
    o0, m0, l0 = TFA.zero_carry(B * HQ, tq, d, "cpu")
    L = torch.randn((B * HQ, tq), generator=g)
    delta = torch.randn((B * HQ, tq), generator=g)
    return q, k, v, do, (o0, m0, l0), L, delta


@pytest.mark.parametrize("dtype,fwd,dkdv,dq", [
    (torch.bfloat16, "tp_flash_fwd_wgmma", "tp_flash_bwd_dkdv_wgmma",
     "tp_flash_bwd_dq_wgmma"),
    (torch.float32, "tp_flash_fwd", "tp_flash_bwd_dkdv", "tp_flash_bwd_dq"),
], ids=["bf16_tensor_cores", "f32_simt"])
def test_dtype_picks_the_entry_points(fake, dtype, fwd, dkdv, dq):
    q, k, v, do, carry, L, delta = _inputs(dtype)
    before = dict(TFA.launches)
    TFA._flash_call(q, k, v, *carry, causal=True, q_heads=HQ)
    TFA._flash_bwd_call(q, k, v, do, L, delta, causal=True, q_heads=HQ)
    assert [name for name, _ in fake.calls] == [fwd, dkdv, dq]
    assert {n: TFA.launches[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_bwd_dkdv": 1, "flash_bwd_dq": 1}
    assert TFA.ENTRY[("flash_fwd", dtype)] == fwd
    assert TFA.ENTRY[("flash_bwd_dkdv", dtype)] == dkdv
    assert TFA.ENTRY[("flash_bwd_dq", dtype)] == dq


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_forward_passes_its_arguments_in_c_order(fake, dtype):
    q, k, v, _, (o0, m0, l0), _, _ = _inputs(dtype)
    o, m, l = TFA._flash_call(q, k, v, o0, m0, l0, 7, 3, causal=True,
                              q_heads=HQ, window=5)
    (name, args), = fake.calls
    ptrs = [t.data_ptr() for t in (q, k, v, o0, m0, l0, o, m, l)]
    assert list(args[:9]) == ptrs
    assert list(args[9:20]) == [B * HQ, TQ, TK, D, HQ, HQ // HKV, 7, 3, 1,
                                5, TFA._DTYPE_CODE[dtype]]
    assert args[20] == pytest.approx(TFA._fold(D))
    assert args[21] == 77
    assert o.shape == o0.shape and m.shape == l.shape == m0.shape


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_passes_its_arguments_in_c_order(fake, dtype):
    q, k, v, do, _, L, delta = _inputs(dtype)
    dq, dk, dv = TFA._flash_bwd_call(q, k, v, do, L, delta, 0, 2,
                                     causal=False, q_heads=HQ)
    (n_kv, a_kv), (n_q, a_q) = fake.calls
    ins = [t.data_ptr() for t in (q, k, v, do, L, delta)]
    assert list(a_kv[:8]) == ins + [dk.data_ptr(), dv.data_ptr()]
    assert list(a_q[:7]) == ins + [dq.data_ptr()]
    ints = [HQ // HKV, 0, 2, 0, 0, TFA._DTYPE_CODE[dtype]]
    assert list(a_kv[8:19]) == [B * HKV, TQ, TK, D, HQ] + ints
    assert list(a_q[7:18]) == [B * HQ, TQ, TK, D, HQ] + ints
    for a in (a_kv[19:], a_q[18:]):
        assert a[0] == pytest.approx(TFA._fold(D))
        assert a[1] == pytest.approx(D ** -0.5)
        assert a[2] == 77
    assert dk.shape == dv.shape == k.shape and dq.shape == q.shape
    assert dq.dtype == dk.dtype == torch.float32


def test_bf16_dq_passes_the_arguments_of_the_f32_entry(fake):
    # tp_flash_bwd_dq_wgmma keeps tp_flash_bwd_dq's C signature: the
    # same pointers, ints and floats in the same order; only the dtype
    # code and the entry point differ.
    calls = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do, _, L, delta = _inputs(dtype)
        dq = TFA._flash_bwd_dq(q, k, v, do, L, delta, 9, 4, causal=True,
                               q_heads=HQ, window=6)
        (name, args), = fake.calls
        fake.calls.clear()
        assert list(args[:7]) == [t.data_ptr()
                                  for t in (q, k, v, do, L, delta, dq)]
        calls[dtype] = (name, args[7:])
    (n32, a32), (n16, a16) = calls[torch.float32], calls[torch.bfloat16]
    assert (n32, n16) == ("tp_flash_bwd_dq", "tp_flash_bwd_dq_wgmma")
    assert list(a16[:11]) == [B * HQ, TQ, TK, D, HQ, HQ // HKV, 9, 4, 1, 6,
                              TFA._DTYPE_CODE[torch.bfloat16]]
    assert a16[:10] == a32[:10] and a16[11:] == a32[11:]
    assert (a16[10], a32[10]) == (1, 0)


def test_declare_gives_the_dq_entries_one_signature():
    class Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    lib = TFA.declare(Lib())
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    want = [p] * 7 + [i] * 11 + [f, f, p]
    assert lib.tp_flash_bwd_dq_wgmma.argtypes == want
    assert lib.tp_flash_bwd_dq.argtypes == want
    assert lib.tp_flash_bwd_dq_wgmma.restype is i


def test_a_misaligned_bf16_do3_reaches_the_dq_launch_aligned(fake):
    q, k, v, do, _, L, delta = _inputs(torch.bfloat16)
    store = torch.empty(do.numel() + 1, dtype=do.dtype)
    store[1:] = do.reshape(-1)
    do_odd = store[1:].view(do.shape)
    assert do_odd.is_contiguous() and do_odd.data_ptr() % 16
    TFA._flash_bwd_dq(q, k, v, do_odd, L, delta, causal=True, q_heads=HQ)
    (name, args), = fake.calls
    assert name == "tp_flash_bwd_dq_wgmma"
    assert all(ptr % 16 == 0 for ptr in args[:7])
    assert args[3] != do_odd.data_ptr()


def test_operands_off_a_16_byte_boundary_are_copied(fake):
    # A contiguous bf16 view 2 bytes into its storage: the tensor-core
    # kernels copy 16 bytes at a time, so the wrapper passes a copy.
    q, k, v, _, carry, _, _ = _inputs(torch.bfloat16)
    store = torch.empty(q.numel() + 1, dtype=q.dtype)
    store[1:] = q.reshape(-1)
    q_odd = store[1:].view(q.shape)
    assert q_odd.is_contiguous() and q_odd.data_ptr() % 16
    TFA._flash_call(q_odd, k, v, *carry, causal=True, q_heads=HQ)
    (_, args), = fake.calls
    assert all(p % 16 == 0 for p in args[:9])
    assert args[0] != q_odd.data_ptr()


@pytest.mark.parametrize("make,match", [
    (lambda: _inputs(torch.bfloat16, d=48), "head dims"),
    (lambda: _inputs(torch.float16), "float32 or bfloat16"),
    (lambda: _inputs(torch.bfloat16, tk=0), "empty sequence"),
], ids=["head_dim_48", "float16", "empty_keys"])
def test_what_the_kernels_cannot_take_raises_before_launch(fake, make, match):
    q, k, v, do, carry, L, delta = make()
    before = dict(TFA.launches)
    with pytest.raises(ValueError, match=match):
        TFA._flash_call(q, k, v, *carry, causal=True, q_heads=HQ)
    with pytest.raises(ValueError, match=match):
        TFA._flash_bwd_call(q, k, v, do, L, delta, causal=True, q_heads=HQ)
    assert fake.calls == [] and TFA.launches == before


def test_a_refused_launch_raises_and_counts_nothing(fake):
    fake.err = 1  # cudaErrorInvalidValue
    q, k, v, do, carry, L, delta = _inputs(torch.bfloat16)
    before = dict(TFA.launches)
    with pytest.raises(RuntimeError, match="flash_fwd kernel launch failed"):
        TFA._flash_call(q, k, v, *carry, causal=True, q_heads=HQ)
    with pytest.raises(RuntimeError, match="flash_bwd_dkdv kernel launch"):
        TFA._flash_bwd_dkdv(q, k, v, do, L, delta, causal=True, q_heads=HQ)
    assert TFA.launches == before


def test_cpu_tensors_launch_nothing_without_the_fake(monkeypatch):
    lib = FakeLib()
    monkeypatch.setattr(TFA, "_lib", lambda: lib)
    q, k, v, do, carry, L, delta = _inputs(torch.bfloat16)
    TFA._flash_call(q, k, v, *carry, causal=True, q_heads=HQ)
    TFA._flash_bwd_call(q, k, v, do, L, delta, causal=True, q_heads=HQ)
    assert lib.calls == []
