"""Bootstrap, the world of ranks and synchronization — the port's copy
of ``tpu_p2p/parallel/runtime.py``.

One process per rank, as in the reference program (``mpirun -n N``,
``p2p_matrix.cc:105-122``), here as ``torchrun --nproc-per-node N`` or
``python -m tpu_p2p_torch --cpu-mesh N``:

- :func:`init_distributed` joins the launcher's world from its
  environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``PORT``);
  without one the process is a world of 1, as ``jax.distributed`` is
  off-cluster.
- :class:`Runtime` holds the rank, the world, the device, the validated
  placement (the reference's host-hash all-gather and contiguous-block
  check, ``p2p_matrix.cc:68-100``), a **host group** (gloo) for barriers,
  all-gathers and the IPC handle exchange, and a **device group** (NCCL)
  only when every rank has a card of its own.
- :class:`Mesh` is the port's counterpart of a 1-D ``jax.sharding.Mesh``
  over axis ``"d"``: the whole world (``rt.mesh``) or the pair of
  ``rt.submesh([a, b])``.
- :meth:`Mesh.barrier` is a stream sync on the card, then a barrier of
  the host group: ``MPI_Barrier`` (``p2p_matrix.cc:146,201``).
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from tpu_p2p_torch.parallel import pallas_dma, topology
from tpu_p2p_torch.utils.errors import PlacementError, check

MESH_AXIS = "d"  # the one axis of the benchmark's meshes
PG_TIMEOUT = datetime.timedelta(seconds=600)  # a collective waits this
# long for a peer before failing, instead of gloo's half hour


def init_distributed() -> bool:
    """Join the launcher's world; → True when there is one. Without the
    launcher's environment this is a world of 1 (an in-memory store),
    so barriers and gathers work the same everywhere."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group("gloo", init_method="env://",
                                timeout=PG_TIMEOUT)
        return True
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1, timeout=PG_TIMEOUT)
    return False


@dataclass(eq=False)
class Mesh:
    """A 1-D group of ranks, in mesh order (``ranks[i]`` is the global
    rank at mesh index ``i``), seen from one rank of the world. Only
    members may use its groups."""

    ranks: Tuple[int, ...]
    rank: int                      # this process's global rank
    device: torch.device
    host_group: object             # gloo, over the members
    device_group: object = None    # NCCL, when every member has a card
    # of its own (None: the members share a card, or run on the CPU)
    windows: Dict = field(default_factory=dict)  # pallas_dma windows of
    # this set of ranks, by capacity (shared by both orders of a pair)
    axis_names: Tuple[str, ...] = (MESH_AXIS,)

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def shape(self) -> Dict[str, int]:
        return {MESH_AXIS: self.size}

    @property
    def is_member(self) -> bool:
        return self.rank in self.ranks

    @property
    def index(self) -> int:
        """This rank's mesh index (its payload row)."""
        return self.ranks.index(self.rank)

    def barrier(self) -> None:
        """Drain this rank's stream on the card, surface a fault of the
        peer-push kernel, then meet the other members."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
            pallas_dma.check_faults()
        dist.barrier(group=self.host_group)


@dataclass(eq=False)
class Runtime:
    """A validated world of ranks — the framework's ``ncclComm_t``."""

    rank: int
    world: int
    device: torch.device
    placement: topology.Placement
    mesh: Mesh
    _groups: Dict = field(default_factory=dict)
    _meshes: Dict = field(default_factory=dict)

    @property
    def num_devices(self) -> int:
        return self.world

    @property
    def host_group(self):
        return self.mesh.host_group

    def submesh(self, device_ids: Sequence[int]) -> Mesh:
        """The mesh over ``device_ids`` (pair isolation). Every rank of
        the world must call it, members or not, in the same order:
        ``new_group`` is collective over the world. Groups are made once
        per set of ranks and cached."""
        ranks = tuple(int(i) for i in device_ids)
        mesh = self._meshes.get(ranks)
        if mesh is not None:
            return mesh
        key = tuple(sorted(set(ranks)))
        check(len(key) == len(ranks) and all(0 <= r < self.world
                                             for r in key),
              f"submesh ranks {ranks} are not distinct ranks of a world "
              f"of {self.world}")
        groups = self._groups.get(key)
        if groups is None:
            host = dist.new_group(list(key))
            dev = None
            if self.mesh.device_group is not None:
                dev = dist.new_group(list(key), backend="nccl")
            groups = (host, dev, {})
            self._groups[key] = groups
        mesh = Mesh(ranks=ranks, rank=self.rank, device=self.device,
                    host_group=groups[0], device_group=groups[1],
                    windows=groups[2])
        self._meshes[ranks] = mesh
        return mesh

    def barrier(self) -> None:
        """World barrier (``MPI_Barrier(MPI_COMM_WORLD)``)."""
        self.mesh.barrier()

    def broadcast(self, obj, src: int):
        """``obj`` as rank ``src`` holds it, on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=src, group=self.host_group)
        return box[0]

    def all_true(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on every rank."""
        t = torch.tensor([0 if flag else 1], dtype=torch.int32)
        dist.all_reduce(t, group=self.host_group)
        return int(t.item()) == 0

    def gather(self, obj) -> list:
        """Every rank's ``obj``, in rank order, on every rank."""
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.host_group)
        return out

    def close(self) -> None:
        """Wait for every rank's card and peers, release the peer-push
        windows and leave the world."""
        self.barrier()
        if self.device.type == "cuda":
            for windows in [self.mesh.windows] + [
                    g[2] for g in self._groups.values()]:
                pallas_dma.close_windows(windows)
        dist.destroy_process_group()


def pick_device(device=None) -> torch.device:
    """The rank's device: ``device`` when given (sharing a card is then
    the caller's choice), else ``cuda:{LOCAL_RANK}``, which must exist:
    more ranks on a host than it has cards is oversubscription."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", 0)
        return device
    local = int(os.environ.get("LOCAL_RANK", "0"))
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if local >= count:
        raise PlacementError(
            f"local rank {local} needs cuda:{local}, but this host has "
            f"{count} CUDA device(s): run one rank per card, or pass "
            "--cpu-mesh N for a world of CPU ranks"
        )
    return torch.device("cuda", local)


def _nccl_possible(keys: Sequence[Tuple[int, str]]) -> bool:
    """Every rank on a card of its own: ``keys`` are (host hash,
    device) per rank."""
    return all(d.startswith("cuda") for _, d in keys) \
        and len(set(keys)) == len(keys)


def make_runtime(num_devices: Optional[int] = None,
                 device=None) -> Runtime:
    """Bootstrap → device → placement check → groups (the setup block
    of ``p2p_matrix.cc:105-122``).

    ``num_devices`` must equal the world size when given: a launcher
    starts one rank per device, so the way to use N devices is a world
    of N (``--cpu-mesh N`` spawns exactly that many)."""
    device = pick_device(device)
    init_distributed()
    rank, world = dist.get_rank(), dist.get_world_size()
    if num_devices is not None:
        check(num_devices <= world,
              f"requested {num_devices} devices but only {world} visible")
        check(num_devices == world,
              f"requested {num_devices} devices in a world of {world} "
              f"ranks: launch {num_devices} ranks instead")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    keys = [None] * world
    dist.all_gather_object(keys, (topology.host_hash(), str(device)))
    placement = topology.validate_placement([k[0] for k in keys])
    device_group = None
    if _nccl_possible(keys):
        device_group = dist.new_group(list(range(world)), backend="nccl")
        # Form the communicator with every rank now: a later
        # batch_isend_irecv over a pair must not be its first call.
        dist.all_reduce(torch.zeros(1, device=device), group=device_group)
    mesh = Mesh(ranks=tuple(range(world)), rank=rank, device=device,
                host_group=dist.group.WORLD, device_group=device_group)
    return Runtime(rank=rank, world=world, device=device,
                   placement=placement, mesh=mesh)
