"""Flagship parameters: shapes, seeded init, and the weight carry.

The port's copy of ``tpu_p2p/models/flagship_params.py`` minus the mesh
placement. Params are a ``dict[str, Tensor]`` keyed by the reference's
leaf names (``wq wk wv wo wf1 wf2 ln1 ln2 lnf emb``, or the MoE
``router we1 we2``), stage-major like the reference.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpu_p2p_torch.models.flagship_config import FlagshipConfig

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


def tensor_from_numpy(a: np.ndarray, device,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One host array → a tensor on ``device``, bitwise. A bfloat16
    array (``ml_dtypes.bfloat16``, what ``np.asarray`` of a JAX bf16
    array gives) is carried through its 16-bit pattern, since
    ``torch.from_numpy`` does not know that dtype. A read-only array (a
    JAX array's host view) is copied, since the tensor may be written
    in place."""
    a = np.ascontiguousarray(a)
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
