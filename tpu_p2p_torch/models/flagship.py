"""Flagship model façade — re-exports the config, params, forward and
train-step pieces, like ``tpu_p2p/models/flagship.py``. Import from
here."""

from __future__ import annotations

from tpu_p2p_torch.models.flagship_config import (  # noqa: F401
    NOT_PORTED_FIELDS,
    FlagshipConfig,
)
from tpu_p2p_torch.models.flagship_forward import (  # noqa: F401
    _dense_ffn,
    _forward_local,
    _lm_logits_local,
    _rms_norm,
    _stage_block,
    _stage_sub_block,
    _unembed,
    make_flagship_forward,
    make_flagship_lm_forward,
)
from tpu_p2p_torch.models.flagship_params import (  # noqa: F401
    Params,
    STAGELESS_LEAVES,
    flagship_host_batch,
    flagship_param_shapes,
    flagship_token_batch,
    init_flagship_params,
    params_from_numpy,
    pool_from_numpy,
    tensor_from_numpy,
    torch_dtype,
)
from tpu_p2p_torch.models.flagship_steps import (  # noqa: F401
    _sgd_update,
    make_flagship_grad_fn,
    make_flagship_lm_grad_fn,
    make_flagship_lm_train_step,
    make_flagship_train_step,
)

__all__ = [
    "FlagshipConfig",
    "Params",
    "flagship_host_batch",
    "flagship_param_shapes",
    "flagship_token_batch",
    "init_flagship_params",
    "make_flagship_forward",
    "make_flagship_grad_fn",
    "make_flagship_lm_forward",
    "make_flagship_lm_grad_fn",
    "make_flagship_lm_train_step",
    "make_flagship_train_step",
    "params_from_numpy",
    "pool_from_numpy",
    "tensor_from_numpy",
    "torch_dtype",
]
