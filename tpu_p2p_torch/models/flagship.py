"""Flagship model façade — re-exports the config, params and forward
pieces, like ``tpu_p2p/models/flagship.py``. Import from here."""

from __future__ import annotations

from tpu_p2p_torch.models.flagship_config import FlagshipConfig  # noqa: F401
from tpu_p2p_torch.models.flagship_forward import (  # noqa: F401
    _dense_ffn,
    _rms_norm,
)
from tpu_p2p_torch.models.flagship_params import (  # noqa: F401
    Params,
    STAGELESS_LEAVES,
    flagship_param_shapes,
    init_flagship_params,
    params_from_numpy,
    pool_from_numpy,
    tensor_from_numpy,
    torch_dtype,
)

__all__ = [
    "FlagshipConfig",
    "Params",
    "flagship_param_shapes",
    "init_flagship_params",
    "params_from_numpy",
    "pool_from_numpy",
    "tensor_from_numpy",
    "torch_dtype",
]
