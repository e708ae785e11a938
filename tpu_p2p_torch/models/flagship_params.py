"""Flagship parameters: shapes, seeded init, placement on the mesh, and
the weight carry.

The port's copy of ``tpu_p2p/models/flagship_params.py``. Params are a
``dict[str, Tensor]`` keyed by the reference's leaf names (``wq wk wv wo
wf1 wf2 ln1 ln2 lnf emb``, or the MoE ``router we1 we2``), stage-major
like the reference. On a mesh each rank holds its shard of each leaf: a
spec names the mesh axis (or None) each dim is split over, as the
reference's ``PartitionSpec`` does, and :func:`place_flagship_params`
slices a rank's shard from the global leaves. Under ``cfg.zero_dp`` the
ZeRO plan (:func:`_fsdp_plan`) adds ``dp`` to each planned leaf's spec.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpu_p2p_torch.models.flagship_config import FlagshipConfig, _axis
from tpu_p2p_torch.parallel import fsdp
from tpu_p2p_torch.parallel.runtime import _dim_axes, local_shard

Params = Dict[str, torch.Tensor]

# Leaves with no leading stage dim (applied around the block stack).
STAGELESS_LEAVES = ("emb", "lnf")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config dtype string (``"bfloat16"`` …)."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(
            f"unsupported dtype {name!r}; expected one of "
            f"{tuple(_DTYPES)}"
        ) from None


def flagship_param_shapes(cfg: FlagshipConfig) -> Dict[str, Tuple[int, ...]]:
    """Parameter shapes from the config alone, in the reference's
    order (the order fixes the seeded init's draws)."""
    s, h, hkv = cfg.stages, cfg.heads, cfg.num_kv_heads
    dm, dh = cfg.model_dim, cfg.head_dim
    e, f = cfg.num_experts, cfg.moe_mult * cfg.model_dim
    shapes = {
        "wq": (s, h, dm, dh),
        "wk": (s, hkv, dm, dh),
        "wv": (s, hkv, dm, dh),
        "wo": (s, h, dh, dm),
    }
    if cfg.dense_ffn:
        shapes["wf1"] = (s, dm, f)
        shapes["wf2"] = (s, f, dm)
    else:
        shapes["router"] = (s, dm, e)
        shapes["we1"] = (s, e, dm, f)
        shapes["we2"] = (s, e, f, dm)
    if cfg.norm:
        shapes["ln1"] = (s, dm)
        shapes["ln2"] = (s, dm)
        if cfg.vocab:
            shapes["lnf"] = (dm,)
    if cfg.vocab:
        shapes["emb"] = (cfg.vocab, dm)
    return shapes


_FAN_IN_DIM = {"wq": 2, "wk": 2, "wv": 2, "wo": 2, "router": 1,
               "we1": 2, "we2": 2, "emb": 1, "wf1": 1, "wf2": 1}
_GAIN_PARAMS = ("ln1", "ln2", "lnf")  # RMSNorm gains: init to ones


def init_flagship_params(cfg: FlagshipConfig, seed: int = 0, *,
                         device="cuda") -> Params:
    """The reference's seeded init: the same ``default_rng(seed)``
    draws in the same order, scaled by ``1/sqrt(fan_in)``, rounded from
    float64 to the storage dtype on the host, then moved to
    ``device``."""
    rng = np.random.default_rng(seed)
    dtype = torch_dtype(cfg.params_dtype)
    device = torch.device(device)
    out: Params = {}
    for name, shape in flagship_param_shapes(cfg).items():
        if name in _GAIN_PARAMS:
            out[name] = torch.ones(shape, dtype=dtype, device=device)
            continue
        a = rng.standard_normal(shape) / math.sqrt(shape[_FAN_IN_DIM[name]])
        out[name] = torch.from_numpy(a).to(dtype).to(device)
    return out


# A spec: per dim, the mesh axis it is split over, a tuple of axes split
# jointly (the first major), or None (replicated); see local_shard.
Spec = Tuple[object, ...]


def _base_param_specs(mesh) -> Dict[str, Spec]:
    """Every leaf's spec (reference ``_base_param_specs``): the stage dim
    over pp, heads over tp, experts over ep; the dense FFN Megatron-split
    (``wf1`` by columns, ``wf2`` by rows); norms per stage; the tied
    embedding and the final norm replicated."""
    pp, tp, ep = _axis(mesh, "pp"), _axis(mesh, "tp"), _axis(mesh, "ep")
    return {
        "wq": (pp, tp, None, None),
        "wk": (pp, tp, None, None),
        "wv": (pp, tp, None, None),
        "wo": (pp, tp, None, None),
        "router": (pp, None, None),
        "we1": (pp, ep, None, None),
        "we2": (pp, ep, None, None),
        "wf1": (pp, None, tp),
        "wf2": (pp, tp, None),
        "ln1": (pp, None),
        "ln2": (pp, None),
        "lnf": (None,),
        "emb": (None, None),
    }


def _fsdp_plan(mesh, cfg: Optional[FlagshipConfig]):
    """The static ZeRO plan, or None when FSDP is off or does not apply
    (no ``cfg.zero_dp``, no dp axis, or a dp axis of size 1)."""
    if cfg is None or not cfg.zero_dp or _axis(mesh, "dp") is None:
        return None
    plan = fsdp.fsdp_plan(flagship_param_shapes(cfg),
                          _base_param_specs(mesh), mesh.shape["dp"])
    return plan if any(d is not None for d in plan.values()) else None


def flagship_param_specs(mesh, cfg: Optional[FlagshipConfig] = None
                         ) -> Dict[str, Spec]:
    """Param specs: pp stage-major, tp heads, ep experts — plus the dp
    dim from the ZeRO plan under ``cfg.zero_dp``. With ``cfg`` the keys
    are this config's leaves; without, every stage-major leaf."""
    base = _base_param_specs(mesh)
    plan = _fsdp_plan(mesh, cfg)
    specs = fsdp.fsdp_specs(base, plan, "dp") if plan else base
    if cfg is not None:
        return {k: specs[k] for k in flagship_param_shapes(cfg)}
    return {k: v for k, v in specs.items() if k not in STAGELESS_LEAVES}


def _placement_specs(mesh, cfg: Optional[FlagshipConfig]):
    """Every leaf's spec for placing and gathering: ``cfg``'s (ZeRO
    included), or the base specs of every leaf without a config."""
    return (flagship_param_specs(mesh, cfg) if cfg is not None
            else _base_param_specs(mesh))


def flagship_data_spec(mesh) -> Spec:
    """A regression batch ``[B, T, Dm]``: batch over (dp, ep) jointly,
    sequence over sp."""
    batch = tuple(a for a in (_axis(mesh, "dp"), _axis(mesh, "ep")) if a)
    return (batch or None, _axis(mesh, "sp"), None)


def _lm_token_spec(mesh) -> Spec:
    """Token ids ``[B, T]``: batch over (dp, ep), sequence over sp."""
    return flagship_data_spec(mesh)[:2]


def place_flagship_params(params, mesh,
                          cfg: Optional[FlagshipConfig] = None) -> Params:
    """This rank's shard of each leaf of the global ``params`` (tensors,
    or the reference's numpy arrays as :func:`params_from_numpy` takes
    them), as contiguous tensors on ``mesh.device`` (the CPU without a
    mesh). With ``cfg`` the specs are :func:`flagship_param_specs`',
    so a ``zero_dp`` config's planned leaves hold their dp shard."""
    specs = _placement_specs(mesh, cfg)
    device = mesh.device if mesh is not None else torch.device("cpu")
    out = {}
    for k, v in params.items():
        shard = local_shard(v, mesh, specs[k])
        out[k] = (shard.contiguous().to(device)
                  if isinstance(shard, torch.Tensor)
                  else tensor_from_numpy(shard, device))
    return out


def _gather_dim(x: torch.Tensor, line, dim: int) -> torch.Tensor:
    from tpu_p2p_torch.parallel.collectives import axis_group

    group = axis_group(line, "all_gather")
    parts = [torch.empty_like(x) for _ in range(line.size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def gather_flagship_params(params: Params, mesh,
                           cfg: Optional[FlagshipConfig] = None) -> Params:
    """The global leaves from every rank's shards (the inverse of
    :func:`place_flagship_params` with the same ``cfg``), on every rank:
    one all-gather along each split axis's line, dp included. Collective
    over the mesh: every rank calls it."""
    specs = _placement_specs(mesh, cfg)
    return {k: gather_leaf(params[k], mesh, specs[k])
            for k in sorted(params)}


def gather_leaf(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """One leaf's global tensor from every rank's shard under ``spec``
    (collective over the lines of its split axes)."""
    for dim, entry in enumerate(spec):
        for a in reversed(_dim_axes(entry)):
            line = mesh.line(a)
            if line.size > 1:
                x = _gather_dim(x, line, dim)
    return x


def flagship_host_batch(cfg: FlagshipConfig, rng: np.random.Generator
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One host-side ``(x, target)`` regression batch ``[B, T, Dm]`` in
    the compute dtype: the reference's two ``standard_normal`` draws
    from ``rng``, rounded from float64 on the host (CPU tensors)."""
    shape = (cfg.batch, cfg.seq, cfg.model_dim)
    dtype = torch_dtype(cfg.dtype)
    return (torch.from_numpy(rng.standard_normal(shape)).to(dtype),
            torch.from_numpy(rng.standard_normal(shape)).to(dtype))


def flagship_token_batch(cfg: FlagshipConfig, seed: int = 1,
                         device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Random ``(tokens, next-token targets)`` int32 ``[B, T]`` on
    ``device``, the reference's draws from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (cfg.batch, cfg.seq + 1))
    return (torch.from_numpy(toks[:, :-1].astype(np.int32)).to(device),
            torch.from_numpy(toks[:, 1:].astype(np.int32)).to(device))


def tensor_from_numpy(a: np.ndarray, device,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One host array → a tensor on ``device``, bitwise. A bfloat16
    array (``ml_dtypes.bfloat16``, what ``np.asarray`` of a JAX bf16
    array gives) is carried through its 16-bit pattern, since
    ``torch.from_numpy`` does not know that dtype. A read-only array (a
    JAX array's host view) is copied, since the tensor may be written
    in place."""
    a = np.ascontiguousarray(a).reshape(np.shape(a))  # keeps 0-dim
    if not a.flags.writeable:
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(np_params: Dict[str, np.ndarray], device,
                      dtype: Optional[torch.dtype] = None) -> Params:
    """The weight carry: the reference's params as numpy arrays
    (``{k: np.asarray(v)}``) → the port's dict on ``device``. Bitwise
    for float32 and bfloat16; ``dtype`` casts after the carry."""
    return {k: tensor_from_numpy(v, device, dtype)
            for k, v in np_params.items()}


def pool_from_numpy(np_pool: Dict[str, np.ndarray], device
                    ) -> Dict[str, torch.Tensor]:
    """The same carry for a KV page pool or dense cache (``{"k", "v"}``),
    so a test can hand a mid-trace state across."""
    return {k: tensor_from_numpy(v, device) for k, v in np_pool.items()}
