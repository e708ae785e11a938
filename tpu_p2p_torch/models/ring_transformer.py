"""RingTransformer — the port of ``tpu_p2p/models/ring_transformer.py``.

A deliberately small transformer block whose sharding is the point: one
SGD step exercises every parallelism axis the benchmark's transports
measure — **dp** (the batch split, gradients summed over it), **sp**
(the sequence split, ring attention's shift-by-1 hops) and **tp**
(heads split Megatron-style, the output projection's partial sums
joined).

Params are a ``dict[str, Tensor]`` keyed by the reference's names; on a
mesh each rank holds its shard (:func:`param_specs`: the head params
split over tp, the MLP replicated) and its block of each batch
(:func:`data_spec`: batch over dp, sequence over sp). The forward is
plain functions of a rank's shards; the mesh enters as the rank's sp
and tp lines (``mesh=None``: a world of one, dense attention).

Gradient accounting. The reference's step holds no explicit gradient
collective: ``shard_map``'s autodiff sums the cotangents of inputs
replicated over an axis, and counts the loss that every tp rank computes
after the join as one loss. Here each sum is explicit. The tp join is
:func:`~tpu_p2p_torch.parallel.collectives.psum_join` (an all-reduce
forward, the identity backward), so each tp rank's head shards get
their whole gradient and the replicated MLP's gradient is whole on
every tp rank already: nothing is summed over tp. After the backward
every gradient and the loss are summed over the (dp, sp) plane, and the
loss is divided by the global ``B·T·Dm``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpu_p2p_torch.models.flagship_params import tensor_from_numpy, \
    torch_dtype
from tpu_p2p_torch.models.flagship_steps import _sgd_update
from tpu_p2p_torch.ops.attention import dense_attention, \
    ring_attention_local
from tpu_p2p_torch.parallel.collectives import all_reduce_flat, psum_join
from tpu_p2p_torch.parallel.runtime import local_shard, pick_device

Params = Dict[str, torch.Tensor]

HEAD_PARAMS = ("wq", "wk", "wv", "wo")  # [H, ...], tp-shardable
MLP_PARAMS = ("w1", "w2")  # replicated everywhere


@dataclass(frozen=True)
class ModelConfig:
    """Global shapes; the reference's defaults."""

    batch: int = 8
    seq: int = 512
    heads: int = 8
    head_dim: int = 64
    mlp_mult: int = 4
    causal: bool = True
    dtype: str = "bfloat16"
    use_flash: bool = False  # the flash kernels on the forward; the
    # train step runs without them, as the reference's does

    @property
    def model_dim(self) -> int:
        return self.heads * self.head_dim

    def tiny(self, mesh) -> "ModelConfig":
        """Shrink to dryrun scale while keeping every axis of ``mesh``
        shardable."""
        axes = mesh.shape
        return replace(
            self,
            batch=2 * axes.get("dp", 1),
            seq=16 * axes.get("sp", 1),
            heads=max(2, axes.get("tp", 1)) * axes.get("tp", 1),
            head_dim=8,
            mlp_mult=2,
        )


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Params:
    """The reference's seeded init: the same ``default_rng(seed)`` draws
    in the same order, scaled by ``1/sqrt(fan_in)`` and rounded from
    float64 on the host, then moved to ``device`` (default: the rank's
    card, :func:`~tpu_p2p_torch.parallel.runtime.pick_device`)."""
    device = pick_device(device)
    rng = np.random.default_rng(seed)
    dm, dh, nh = cfg.model_dim, cfg.head_dim, cfg.heads
    dtype = torch_dtype(cfg.dtype)

    def w(*shape):
        fan_in = shape[-2] if len(shape) > 1 else shape[0]
        a = rng.standard_normal(shape) / math.sqrt(fan_in)
        return torch.from_numpy(a).to(dtype).to(device)

    return {
        "wq": w(nh, dm, dh),
        "wk": w(nh, dm, dh),
        "wv": w(nh, dm, dh),
        "wo": w(nh, dh, dm),
        "w1": w(dm, cfg.mlp_mult * dm),
        "w2": w(cfg.mlp_mult * dm, dm),
    }


def _axis(mesh, name: str) -> Optional[str]:
    return name if mesh is not None and name in mesh.axis_names else None


def _line(mesh, name: str):
    return mesh.line(name) if _axis(mesh, name) else None


def param_specs(mesh) -> Dict[str, tuple]:
    """Each leaf's spec: the head params split over tp on their head
    dim, the MLP replicated."""
    tp = _axis(mesh, "tp")
    specs = {k: (tp, None, None) for k in HEAD_PARAMS}
    specs.update({k: (None, None) for k in MLP_PARAMS})
    return specs


def data_spec(mesh) -> tuple:
    """A batch ``[B, T, Dm]``: batch over dp, sequence over sp."""
    return (_axis(mesh, "dp"), _axis(mesh, "sp"), None)


def _data_plane(mesh):
    """This rank's plane over the mesh's (dp, sp) axes, or None."""
    axes = tuple(a for a in ("dp", "sp") if _axis(mesh, a))
    if not axes:
        return None
    return mesh.line(axes[0]) if len(axes) == 1 else mesh.plane(axes)


def _forward(params: Params, x: torch.Tensor, cfg: ModelConfig, sp, tp,
             allow_flash: bool = True) -> torch.Tensor:
    """This rank's forward: ``x [B_loc, T_loc, Dm]``, the head params
    holding this tp rank's heads; ``sp``/``tp`` are this rank's lines
    (or None)."""
    q = torch.einsum("btm,hmd->bhtd", x, params["wq"])
    k = torch.einsum("btm,hmd->bhtd", x, params["wk"])
    v = torch.einsum("btm,hmd->bhtd", x, params["wv"])
    if sp is not None:
        a = ring_attention_local(q, k, v, sp, causal=cfg.causal,
                                 use_flash=cfg.use_flash and allow_flash)
    else:
        a = dense_attention(q, k, v, causal=cfg.causal)
    y = psum_join(torch.einsum("bhtd,hdm->btm", a, params["wo"]), tp)
    h = F.gelu(torch.einsum("btm,mf->btf", x + y, params["w1"]),
               approximate="tanh")  # jax.nn.gelu's default
    return x + y + torch.einsum("btf,fm->btm", h, params["w2"])


def make_forward(mesh, cfg: ModelConfig):
    """``(params, x) → out`` of this rank's shards over ``mesh``."""
    sp, tp = _line(mesh, "sp"), _line(mesh, "tp")

    def forward(params: Params, x: torch.Tensor) -> torch.Tensor:
        return _forward(params, x, cfg, sp, tp)

    return forward


def make_train_step(mesh, cfg: ModelConfig, lr: float = 1e-3):
    """One SGD step over a (dp, sp, tp) mesh: ``(params, x, target) →
    (params, loss)``, ``loss`` the global sum of squared error over
    ``B·T·Dm``, the same on every rank. The forward runs without the
    flash kernels (the reference's ``allow_flash=False``); the sums are
    the module docstring's."""
    sp, tp = _line(mesh, "sp"), _line(mesh, "tp")
    plane = _data_plane(mesh)
    n_out = cfg.batch * cfg.seq * cfg.model_dim  # global normalizer

    def step(params: Params, x: torch.Tensor, target: torch.Tensor):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        out = _forward(leaves, x, cfg, sp, tp, allow_flash=False)
        loss = torch.sum((out.float() - target.float()) ** 2)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        loss = loss.detach()
        if plane is not None:
            all_reduce_flat([loss.reshape(1), *grads.values()], plane,
                            "the gradient all-reduce")
        return _sgd_update(params, grads, lr, n_out), loss / n_out

    return step


def _device(mesh, device) -> torch.device:
    """``device`` when given, else the mesh's, else the rank's card."""
    if device is None and mesh is not None:
        return mesh.device
    return pick_device(device)


def place_params(params: Params, mesh, device=None) -> Params:
    """This rank's shard of each global leaf, contiguous on ``device``
    (default: the mesh's device; without a mesh, the rank's card)."""
    specs = param_specs(mesh)
    device = _device(mesh, device)
    return {k: local_shard(v, mesh, specs[k]).contiguous().to(device)
            for k, v in params.items()}


def params_from_reference(np_params: Dict[str, np.ndarray], device,
                          mesh=None) -> Params:
    """The weight carry: the reference's params as numpy arrays
    (``{k: np.asarray(v)}``, bf16 through its bits) → this rank's shards
    on ``device``."""
    return place_params({k: tensor_from_numpy(a, "cpu")
                         for k, a in np_params.items()}, mesh, device)


def example_batch(cfg: ModelConfig, mesh=None, seed: int = 1,
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's block of the reference's ``(x, target)`` batch: two
    ``standard_normal`` draws from ``default_rng(seed)``, rounded from
    float64 on the host, on ``device`` (default: the mesh's device;
    without a mesh, the rank's card)."""
    device = _device(mesh, device)
    rng = np.random.default_rng(seed)
    dtype = torch_dtype(cfg.dtype)
    shape = (cfg.batch, cfg.seq, cfg.model_dim)
    x = torch.from_numpy(rng.standard_normal(shape)).to(dtype)
    t = torch.from_numpy(rng.standard_normal(shape)).to(dtype)
    spec = data_spec(mesh)
    return tuple(local_shard(a, mesh, spec).contiguous().to(device)
                 for a in (x, t))
