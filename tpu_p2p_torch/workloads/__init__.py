"""Benchmark workloads, registered by name for the CLI — every pattern
of the reference: ``pairwise``, ``latency``, ``loopback``, ``ring``,
``torus2d``, ``all_to_all``, ``allreduce``, ``reduce_scatter``,
``all_gather``, ``ring_attention``, ``ulysses_attention`` and
``flagship_step``.

Importing this package registers them in
:data:`tpu_p2p_torch.workloads.base.WORKLOADS`.
"""

from tpu_p2p_torch.workloads.base import WORKLOADS, WorkloadContext, workload  # noqa: F401
from tpu_p2p_torch.workloads import (  # noqa: F401  (registration)
    allreduce,
    alltoall,
    flagship_step,
    latency,
    pairwise,
    ring,
    ring_attn,
    torus,
    ulysses_attn,
)
