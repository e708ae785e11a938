"""Flagship model façade — re-exports the config, params, forward and
train-step pieces, like ``tpu_p2p/models/flagship.py``. Import from
here."""

from __future__ import annotations

from tpu_p2p_torch.models.flagship_config import (  # noqa: F401
    AXES,
    NOT_PORTED_FIELDS,
    FlagshipConfig,
    _axis,
    _data_axes,
    _mesh_axes,
    build_mesh,
    mesh_dims,
)
from tpu_p2p_torch.models.flagship_forward import (  # noqa: F401
    _dense_ffn,
    _forward_local,
    _fsdp_prepare,
    _lm_logits_local,
    _moe_ffn,
    _pipeline_schedule,
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
    _base_param_specs,
    _fsdp_plan,
    _lm_token_spec,
    flagship_data_spec,
    flagship_host_batch,
    flagship_param_shapes,
    flagship_param_specs,
    flagship_token_batch,
    gather_flagship_params,
    init_flagship_params,
    local_shard,
    place_flagship_params,
    params_from_numpy,
    pool_from_numpy,
    tensor_from_numpy,
    torch_dtype,
)
from tpu_p2p_torch.models.moe import MoEConfig  # noqa: F401
from tpu_p2p_torch.models.flagship_steps import (  # noqa: F401
    _reject_zb_schedule,
    _sgd_update,
    make_flagship_grad_fn,
    make_flagship_lm_grad_fn,
    make_flagship_lm_train_step,
    make_flagship_train_step,
)

__all__ = [
    "AXES",
    "FlagshipConfig",
    "MoEConfig",
    "Params",
    "build_mesh",
    "flagship_data_spec",
    "flagship_host_batch",
    "flagship_param_shapes",
    "flagship_param_specs",
    "flagship_token_batch",
    "gather_flagship_params",
    "init_flagship_params",
    "local_shard",
    "make_flagship_forward",
    "make_flagship_grad_fn",
    "make_flagship_lm_forward",
    "make_flagship_lm_grad_fn",
    "make_flagship_lm_train_step",
    "make_flagship_train_step",
    "mesh_dims",
    "params_from_numpy",
    "place_flagship_params",
    "pool_from_numpy",
    "tensor_from_numpy",
    "torch_dtype",
]
