"""Flagship model config — the port's copy of
``tpu_p2p/models/flagship_config.py``.

The model-shape fields, ``use_flash``, and every training field the
reference's train CLI sets. Field names and defaults match the
reference, so one keyword set builds both configs. The port runs on one
device, so the fields that schedule a mesh (sequence-parallel strategy,
FSDP and its overlap, the tp/ep/pp overlaps, the pipeline schedule and
its lowering) and rematerialization are not ported yet: a non-default
value raises rather than being ignored.
"""

from __future__ import annotations

from dataclasses import dataclass

# Fields whose machinery is not ported, with the reference's default.
NOT_PORTED_FIELDS = {
    "sp_strategy": "ring", "zero_dp": False, "overlap": "none",
    "tp_overlap": "none", "ep_overlap": "none", "pp_overlap": "none",
    "pp_chunks": 4, "pp_schedule": "1f1b", "tick_lowering": "masked",
    "remat": False, "remat_policy": "",
}


@dataclass(frozen=True)
class FlagshipConfig:
    """Global shapes of the flagship transformer, and how it trains."""

    batch: int = 8
    seq: int = 256
    heads: int = 8
    kv_heads: int = 0        # 0 → same as heads (MHA); otherwise GQA
    head_dim: int = 32
    stages: int = 2          # transformer blocks
    microbatches: int = 2
    num_experts: int = 4
    capacity_factor: float = 2.0
    moe_mult: int = 2        # FFN width = moe_mult * model_dim
    causal: bool = True
    dtype: str = "float32"   # compute dtype (activations, cache, the
    # in-block cast of params)
    param_dtype: str = ""    # storage dtype ("" = same as dtype)
    rope: bool = False       # rotary position embeddings on q/k
    vocab: int = 0           # > 0: tied token embedding "emb"
    norm: bool = False       # pre-norm RMSNorm gains ln1/ln2 (+ lnf)
    dense_ffn: bool = False  # dense gelu MLP (wf1/wf2) instead of MoE
    attn_window: int = 0     # > 0: sliding-window attention
    use_flash: bool = False  # attention through the flash kernels
    # (dense attention otherwise)
    sp_strategy: str = "ring"
    zero_dp: bool = False
    overlap: str = "none"
    tp_overlap: str = "none"
    ep_overlap: str = "none"
    pp_overlap: str = "none"
    pp_chunks: int = 4
    pp_schedule: str = "1f1b"
    tick_lowering: str = "masked"
    remat: bool = False
    remat_policy: str = ""

    def __post_init__(self) -> None:
        for name, default in NOT_PORTED_FIELDS.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"FlagshipConfig.{name}={getattr(self, name)!r} is not "
                    f"ported yet (the port runs one device; only "
                    f"{name}={default!r} is)"
                )
        if self.attn_window < 0:
            raise ValueError(
                f"attn_window must be >= 0, got {self.attn_window}"
            )
        if self.attn_window and not self.causal:
            raise ValueError("attn_window requires causal=True")
        kv = self.num_kv_heads
        if kv <= 0 or self.heads % kv:
            raise ValueError(
                f"heads ({self.heads}) must divide by kv_heads ({kv})"
            )

    @property
    def model_dim(self) -> int:
        return self.heads * self.head_dim

    @property
    def params_dtype(self) -> str:
        return self.param_dtype or self.dtype

    @property
    def num_kv_heads(self) -> int:
        return self.kv_heads or self.heads
