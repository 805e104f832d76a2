"""A run of several processes on ``torch.distributed`` — the counterpart of
fwumious_wabbit_tpu/parallel/distributed.py.

The flags are the JAX CLI's: ``--fwt_hosts N --fwt_host_id r
--fwt_coordinator host:port`` make this process rank ``r`` of a group of
``N`` (``init_method="tcp://host:port"``), NCCL on the card and gloo with
``--fwt_platform cpu``. A rank that never arrives fails the run after
:data:`TIMEOUT` instead of hanging it.

One process per device: where the JAX package runs one process per host
and every local device in it (``--fwt_table_axis 2`` alone spans 8 devices
of one process), the port runs one process per card, and a mesh of
``n_data × n_table`` needs exactly that many ranks. On one host one command
starts them (parallel/launch.py); across hosts each rank is started with
these flags. Each rank takes the card ``rank % device_count``
(utils/device.resolve_device), made current before anything is allocated,
and binds the NCCL group to it (``device_id``): the group's communicator,
and each subgroup's (parallel/mesh.py), is made when the group is, not at
a first collective on a guessed card.

Usage across hosts, one process per card, the same command everywhere but
the rank (every rank writes the ``-p`` and ``-f`` it is given, as every JAX
host does: ranks that share a host need paths of their own):

    python -m fwumious_wabbit_tpu_torch ... \\
        --fwt_hosts 8 --fwt_host_id $RANK --fwt_coordinator host0:7755 \\
        --fwt_data_axis 4 --fwt_table_axis 2
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from ..utils.logging import get_logger

log = get_logger(__name__)

# How long a collective, and the group's rendezvous, waits for a rank.
TIMEOUT = datetime.timedelta(seconds=300)


def wanted(coordinator: str | None, num_hosts: int | None) -> bool:
    """Whether the flags ask for a process group (the JAX module's rule:
    a coordinator, or more than one host)."""
    return bool(coordinator) or (num_hosts is not None and num_hosts > 1)


def initialize(coordinator: str | None, num_hosts: int | None,
               host_id: int | None, platform: str | None) -> torch.device:
    """Join the process group of ``--fwt_hosts``/``--fwt_host_id``/
    ``--fwt_coordinator`` and return this rank's device: the CPU with
    ``platform == "cpu"`` (gloo), else the rank's card (NCCL). Once per
    process; a second call returns the device without joining again."""
    if not coordinator:
        raise ValueError("--fwt_hosts needs --fwt_coordinator host:port")
    world = int(num_hosts or 1)
    rank = int(host_id or 0)
    if not 0 <= rank < world:
        raise ValueError(f"--fwt_host_id {rank} is not a rank of "
                         f"--fwt_hosts {world}")
    cpu = platform == "cpu"
    device = resolve_device("cpu" if cpu else platform, rank=None if cpu else rank)
    if dist.is_initialized():
        return device
    dist.init_process_group("gloo" if cpu else "nccl",
                            init_method=f"tcp://{coordinator}",
                            world_size=world, rank=rank, timeout=TIMEOUT,
                            device_id=None if cpu else device)
    log.info("process group: rank %d of %d (%s) on %s", rank, world,
             dist.get_backend(), device)
    return device


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def shutdown(wait: bool = False) -> None:
    """Leave the group; with ``wait``, once every rank has come here (a
    run that ended well: a gloo rank that tears its group down while a
    peer still writes its files, rank 0 of parallel/launch.py, can abort in
    the group's destructor). A failed rank does not wait: the others may be
    inside a collective it will never join."""
    if dist.is_initialized():
        if wait:
            dist.barrier()
        dist.destroy_process_group()
