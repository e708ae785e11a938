"""Benchmark workloads, registered by name for the CLI — the patterns
ported so far: ``pairwise``, ``latency``, ``loopback``, ``ring``,
``torus2d``, ``all_to_all``, ``allreduce``, ``reduce_scatter`` and
``all_gather``.

Importing this package registers them in
:data:`tpu_p2p_torch.workloads.base.WORKLOADS`.
"""

from tpu_p2p_torch.workloads.base import WORKLOADS, WorkloadContext, workload  # noqa: F401
from tpu_p2p_torch.workloads import (  # noqa: F401  (registration)
    allreduce,
    alltoall,
    latency,
    pairwise,
    ring,
    torus,
)
