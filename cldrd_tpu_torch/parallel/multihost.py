"""Multi-process bring-up on ``torch.distributed`` (port of
``cldrd_tpu/parallel/multihost.py``).

One process per device, as the reference's source trained under
``torch.distributed.launch`` with NCCL. A launcher sets the rendezvous in
the environment (``torchrun``: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``, ``LOCAL_RANK``); ``initialize_multihost`` joins it before
any device work. A launch that was configured but cannot be joined
raises: quietly training single-process on every rank would train each
on duplicated data. Only when nothing is configured does it stay
single-process, with a log line.
"""
from __future__ import annotations

import datetime
import logging
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# how long a rank waits at a host-side barrier: rank 0 alone may build a
# full corpus's evaluation index meanwhile (cli.curriculum)
HOST_TIMEOUT = datetime.timedelta(hours=6)

# (variable, needs_multi): a ``needs_multi`` variable counts only when its
# value implies more than one process (Slurm sets SLURM_NTASKS=1 for an
# ordinary one-task job)
_CLUSTER_ENV_VARS = (
    ("MASTER_ADDR", False),
    ("WORLD_SIZE", True),
    ("OMPI_COMM_WORLD_SIZE", True),
    ("SLURM_NTASKS", True),
)


def _implies_multi_process(var: str, value: str) -> bool:
    try:
        return int(value) > 1
    except ValueError:
        return False


def _already_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def _cluster_configured() -> bool:
    for var, needs_multi in _CLUSTER_ENV_VARS:
        value = os.environ.get(var)
        if not value:
            continue
        if not needs_multi or _implies_multi_process(var, value):
            return True
    return False


def _env_rank_world() -> Tuple[Optional[int], Optional[int]]:
    """(rank, world) from torchrun's, OpenMPI's or Slurm's variables."""
    for rank_var, world_var in (("RANK", "WORLD_SIZE"),
                                ("OMPI_COMM_WORLD_RANK",
                                 "OMPI_COMM_WORLD_SIZE"),
                                ("SLURM_PROCID", "SLURM_NTASKS")):
        if os.environ.get(world_var):
            return (int(os.environ.get(rank_var, 0)),
                    int(os.environ[world_var]))
    return None, None


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None) -> None:
    """Join the configured process group (``init_process_group``).
    ``coordinator_address`` is ``host:port`` (else ``MASTER_ADDR`` /
    ``MASTER_PORT``); ``backend`` defaults to NCCL when CUDA is
    available, else gloo. A no-op when a group already exists."""
    if _already_initialized():
        return
    explicit = coordinator_address is not None or num_processes is not None
    configured = explicit or _cluster_configured()
    env_rank, env_world = _env_rank_world()
    rank = process_id if process_id is not None else env_rank
    world = num_processes if num_processes is not None else env_world
    init_method = (f"tcp://{coordinator_address}" if coordinator_address
                   else "env://")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    try:
        if world is None or rank is None:
            raise ValueError("no rank / world size configured")
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world, rank=rank)
    except Exception as e:
        if configured:
            raise RuntimeError(
                "torch.distributed.init_process_group failed although a "
                "multi-process launch was configured: refusing to "
                "silently fall back to single-process (every rank would "
                f"train on duplicated data). Original error: {e}") from e
        logger.info("torch.distributed not initialized (%s); "
                    "single-process", e)
        return
    logger.info("torch.distributed up: rank %d/%d (%s)", dist.get_rank(),
                dist.get_world_size(), backend)


def host_shard() -> Tuple[int, Optional[int]]:
    """(rank, nranks) for per-rank input sharding, ``(-1, None)`` in a
    single process (the dataset factories' convention)."""
    n = dist.get_world_size() if _already_initialized() else 1
    return (dist.get_rank(), n) if n > 1 else (-1, None)


def is_first_host() -> bool:
    """The rank-0 guard for host side effects (checkpoints, logs)."""
    return not _already_initialized() or dist.get_rank() == 0


_host_group = (None, None)  # (default group, its gloo twin)


def host_group() -> Optional[dist.ProcessGroup]:
    """A gloo group over the default group's ranks, for what the hosts
    agree on: the SIGTERM flag at each step, "rank 0 has written the
    checkpoint", "rank 0 has evaluated". Its collectives take CPU
    tensors, so they never wait on the device, and a barrier waits up
    to HOST_TIMEOUT, not the NCCL default. The first call creates it,
    so every rank makes that call at the same point (the Trainer's
    constructor). None without a group."""
    global _host_group
    if not _already_initialized():
        return None
    default = dist.group.WORLD
    if _host_group[0] is not default:
        _host_group = (default, dist.new_group(backend="gloo",
                                               timeout=HOST_TIMEOUT))
    return _host_group[1]


def world() -> Tuple[int, int]:
    """(rank, world size) of the default group; (0, 1) without one."""
    if not _already_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def local_device(device=None) -> torch.device:
    """This rank's device: ``cuda`` becomes ``cuda:LOCAL_RANK`` under a
    group (rank modulo the visible GPUs when the launcher sets none);
    anything else stands."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    rank, n = world()
    if n == 1 or not torch.cuda.is_available():
        return dev
    local = os.environ.get("LOCAL_RANK")
    return torch.device("cuda", int(local) if local is not None
                        else rank % torch.cuda.device_count())
