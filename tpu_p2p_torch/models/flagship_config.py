"""Flagship model config and mesh factoring — the port's copy of
``tpu_p2p/models/flagship_config.py``.

The model-shape fields, ``use_flash``, the sequence-parallel strategy,
ZeRO storage (``zero_dp``) and its prefetch schedule (``overlap``), the
tp/ep/pp overlap knobs (``tp_overlap``, ``ep_overlap``, ``pp_overlap``
with ``pp_chunks``), rematerialization (``remat``, ``remat_policy``),
every training field the reference's train CLI sets, the tick-IR
executor's schedule and lowering (``pp_schedule``, ``tick_lowering``),
and the MoE FFN's config (:meth:`FlagshipConfig.moe`). Field names and
defaults match the reference, so one keyword set builds both configs.
The mesh has the reference's five axes (``AXES``); :func:`build_mesh`
factors a world over them.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Sequence, Tuple

from tpu_p2p_torch.config import PP_SCHEDULES, TICK_LOWERINGS
from tpu_p2p_torch.models.moe import MoEConfig
from tpu_p2p_torch.utils.remat import REMAT_POLICIES

AXES = ("dp", "pp", "sp", "tp", "ep")
SP_STRATEGIES = ("ring", "ring_zigzag", "ulysses")


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
    sp_strategy: str = "ring"  # "ring" (KV rotation), "ring_zigzag"
    # (the same ring on a load-balanced causal layout: the model reads
    # its sequence shards as zigzag chunks, see
    # tpu_p2p_torch.ops.attention.zigzag_chunks; attention is the only
    # position-dependent op, so the data needs no permutation), or
    # "ulysses" (head <-> sequence all-to-all; heads % sp == 0)
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
        # Strict, because a typo ("zigzag") would fall through to the
        # contiguous layout and train silently wrong.
        if self.sp_strategy not in SP_STRATEGIES:
            raise ValueError(
                f"unknown sp_strategy {self.sp_strategy!r}; expected "
                "'ring', 'ring_zigzag', or 'ulysses'"
            )
        if self.attn_window < 0:
            raise ValueError(
                f"attn_window must be >= 0, got {self.attn_window}"
            )
        if self.attn_window and not self.causal:
            raise ValueError("attn_window requires causal=True")
        # Strict like sp_strategy: a typo would train on the bulk-gather
        # path while the run's logs claim overlap.
        if self.overlap not in ("none", "prefetch"):
            raise ValueError(
                f"unknown overlap {self.overlap!r}; expected 'none' "
                "or 'prefetch'"
            )
        # prefetch schedules ZeRO gathers: without zero_dp there are
        # none. A dp axis of size 1 under zero_dp stays a legal no-op
        # (a mesh property, known when a step is built).
        if self.overlap == "prefetch" and not self.zero_dp:
            raise ValueError(
                "overlap='prefetch' requires zero_dp=True (the prefetch "
                "schedule is a ZeRO parameter-gather schedule; without "
                "FSDP storage there is nothing to prefetch)"
            )
        # Strict like overlap: a typo would train on the blocking path
        # while the run's logs claim the overlapped one.
        if self.tp_overlap not in ("none", "ring"):
            raise ValueError(
                f"unknown tp_overlap {self.tp_overlap!r}; expected "
                "'none' or 'ring'"
            )
        if self.ep_overlap not in ("none", "ring"):
            raise ValueError(
                f"unknown ep_overlap {self.ep_overlap!r}; expected "
                "'none' or 'ring'"
            )
        if self.pp_overlap not in ("none", "wave"):
            raise ValueError(
                f"unknown pp_overlap {self.pp_overlap!r}; expected "
                "'none' or 'wave'"
            )
        if self.pp_chunks < 1:
            raise ValueError(
                f"pp_chunks must be >= 1, got {self.pp_chunks}"
            )
        # Strict like the overlap knobs: a typo ("ZB", "zero_bubble")
        # would train the fused schedule while the logs claim
        # zero-bubble; one definition with config.py and the CLI.
        if self.pp_schedule not in PP_SCHEDULES:
            raise ValueError(
                f"unknown pp_schedule {self.pp_schedule!r}; expected "
                f"one of {PP_SCHEDULES}"
            )
        if self.tick_lowering not in TICK_LOWERINGS:
            raise ValueError(
                f"unknown tick_lowering {self.tick_lowering!r}; "
                f"expected one of {TICK_LOWERINGS}"
            )
        # The reference accepts the names of jax.checkpoint_policies'
        # POLICIES and refuses the factories that build one.
        if self.remat_policy and self.remat_policy not in REMAT_POLICIES:
            raise ValueError(
                f"unknown remat_policy {self.remat_policy!r}; expected "
                f"one of {sorted(REMAT_POLICIES)} — factory names that "
                "build policies from arguments are not accepted"
            )
        if self.remat_policy and not self.remat:
            raise ValueError("remat_policy requires remat=True")
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

    def moe(self) -> MoEConfig:
        """The MoE FFN's config (the reference's ``moe``): experts as
        wide as the dense FFN, routing groups of 256 tokens."""
        return MoEConfig(
            d_model=self.model_dim, d_ff=self.moe_mult * self.model_dim,
            num_experts=self.num_experts,
            capacity_factor=self.capacity_factor, group_size=256,
            ep_overlap=self.ep_overlap,
        )

    def tiny(self, mesh) -> "FlagshipConfig":
        """Shrink to dryrun scale while keeping every axis of ``mesh``
        shardable (the reference's ``tiny``)."""
        ax = mesh.shape
        tp, sp, pp = ax.get("tp", 1), ax.get("sp", 1), ax.get("pp", 1)
        dpep = ax.get("dp", 1) * ax.get("ep", 1)
        heads = 2 * tp * sp
        # Keep the GQA ratio where it gives a valid KV head count at the
        # shrunken query head count (divisible, tp-shardable); else MHA.
        ratio = self.heads // self.num_kv_heads
        kv = heads // ratio if heads % ratio == 0 else 0
        if kv and (heads % kv or kv % tp):
            kv = 0
        return replace(
            self,
            batch=2 * dpep * self.microbatches,
            seq=16 * sp,
            heads=heads,
            kv_heads=kv,
            head_dim=8,
            stages=pp,
            num_experts=2 * ax.get("ep", 1),
            capacity_factor=float(2 * ax.get("ep", 1)),
        )


def _axis(mesh, name: str) -> Optional[str]:
    return name if mesh is not None and name in mesh.axis_names else None


def _data_axes(axes) -> tuple:
    """The axes data (and thus loss and gradient partial sums) shard
    over."""
    return tuple(a for a in ("dp", "ep", "sp") if a in axes)


def _mesh_axes(mesh) -> Dict[str, object]:
    """Each of ``AXES`` → this rank's line along it (a one-rank line
    where the axis has size 1), or None where ``mesh`` lacks the axis
    (``mesh=None``: a world of one, every axis None)."""
    return {a: (mesh.line(a) if _axis(mesh, a) else None) for a in AXES}


def mesh_dims(n_devices: int) -> Tuple[int, ...]:
    """Factor ``n_devices`` over ``AXES`` (the reference's
    ``build_mesh``, ``tpu_p2p/models/flagship_config.py:398``): prime
    factors, largest first, dealt round-robin in the priority order
    sp → dp → pp → tp → ep; axes without a factor stay size 1."""
    factors = []
    m = n_devices
    for p in (2, 3, 5, 7, 11, 13):
        while m % p == 0:
            factors.append(p)
            m //= p
    if m > 1:
        factors.append(m)
    dims = {a: 1 for a in AXES}
    order = ["sp", "dp", "pp", "tp", "ep"]
    for i, f in enumerate(sorted(factors, reverse=True)):
        dims[order[i % len(order)]] *= f
    return tuple(dims[a] for a in AXES)


def build_mesh(n_devices: int, device=None,
               dims: Optional[Sequence[int]] = None, runtime=None):
    """The five-axis mesh over this world of ``n_devices`` ranks (one
    process a rank: ``torchrun``, or ``--cpu-mesh N``): ``dims`` (dp,
    pp, sp, tp, ep), by default :func:`mesh_dims`. Makes the runtime
    (``mesh.runtime``; close it when done) and the groups of every line
    of every axis of size > 1. ``device`` as
    :func:`tpu_p2p_torch.parallel.runtime.make_runtime` takes it.
    ``runtime``: lay the mesh over that world instead (the benchmark's,
    whose process group exists already); its groups are reused where a
    line's ranks match a group it made."""
    from tpu_p2p_torch.parallel.runtime import make_runtime

    dims = tuple(dims or mesh_dims(n_devices))
    if runtime is not None:
        if runtime.world != n_devices:
            raise ValueError(f"a mesh of {n_devices} devices over a world "
                             f"of {runtime.world}")
        return runtime.axis_mesh(dims, AXES)
    rt = make_runtime(num_devices=n_devices, device=device,
                      mesh_shape=dims, axis_names=AXES)
    return rt.mesh
