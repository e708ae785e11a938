"""Benchmark workloads, registered by name for the CLI — the patterns
ported so far: ``pairwise``, ``latency`` and ``loopback``.

Importing this package registers them in
:data:`tpu_p2p_torch.workloads.base.WORKLOADS`.
"""

from tpu_p2p_torch.workloads.base import WORKLOADS, WorkloadContext, workload  # noqa: F401
from tpu_p2p_torch.workloads import latency, pairwise  # noqa: F401  (registration)
