"""Topology discovery and the placement check — the port's copy of
``tpu_p2p/parallel/topology.py``.

As in the reference program (``check_process_placement_policy``,
``p2p_matrix.cc:44-100``): every rank hashes its host name with DJB2a,
the hashes are all-gathered over the host group (``Runtime`` does that),
and :func:`validate_placement` asserts (a) every host runs the same
number of ranks and (b) the ranks of one host form a contiguous block;
the local index of a rank is ``rank % ranks_per_host`` (``:99``). One
card has no torus and no slices, so the port keeps neither helper.
"""

from __future__ import annotations

import socket
from dataclasses import dataclass
from typing import Sequence

from tpu_p2p_torch.utils.errors import PlacementError

# Messages mirror the reference's stderr diagnostics (p2p_matrix.cc:84,96).
_MSG_NONUNIFORM = (
    "Please make sure that each host has the same number of devices"
)
_MSG_NONCONTIGUOUS = (
    "Please make sure that devices are placed in contiguous per-host blocks. "
    "For example, if there are 8 devices and 2 hosts, the first host should "
    "hold devices 0-3 while the second host holds devices 4-7."
)


def djb2a_hash(s: str) -> int:
    """DJB2a string hash ``h = h*33 ^ c`` from 5381, truncated to 64
    bits (``getHostHash``, ``p2p_matrix.cc:44-51``)."""
    h = 5381
    for ch in s.encode():
        h = ((h << 5) + h) ^ ch
        h &= 0xFFFFFFFFFFFFFFFF
    return h


def get_host_name() -> str:
    """Host name with the domain stripped at the first ``.``
    (``getHostName``, ``p2p_matrix.cc:53-61``)."""
    return socket.gethostname().split(".", 1)[0]


def host_hash() -> int:
    """This host's DJB2a host-name hash (``p2p_matrix.cc:68-69``)."""
    return djb2a_hash(get_host_name())


@dataclass(frozen=True)
class Placement:
    """Validated placement: ``host_of[i]`` is the host ordinal of rank
    ``i`` and ``local_ids[i]`` its index on that host."""

    num_devices: int
    num_hosts: int
    devices_per_host: int
    host_of: tuple
    local_ids: tuple


def validate_placement(host_keys: Sequence[int]) -> Placement:
    """Check the per-rank host keys in the reference's order — uniform
    ranks per host (``p2p_matrix.cc:83-86``), then contiguous per-host
    blocks (``:88-98``) — and return the global↔local map. Raises
    :class:`PlacementError` (the reference's ``exit(-1)``)."""
    n = len(host_keys)
    if n == 0:
        raise PlacementError("no devices visible")
    distinct = list(dict.fromkeys(host_keys))
    num_hosts = len(distinct)
    if n % num_hosts != 0:
        raise PlacementError(_MSG_NONUNIFORM)
    per_host = n // num_hosts
    contiguous = True
    for host in range(num_hosts):
        base = host * per_host
        for k in range(1, per_host):
            contiguous = contiguous and (
                host_keys[base + k] == host_keys[base + k - 1]
            )
    if not contiguous:
        raise PlacementError(_MSG_NONCONTIGUOUS)
    return Placement(
        num_devices=n,
        num_hosts=num_hosts,
        devices_per_host=per_host,
        host_of=tuple(i // per_host for i in range(n)),
        local_ids=tuple(i % per_host for i in range(n)),
    )
