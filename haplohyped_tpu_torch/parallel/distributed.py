"""Multi-process set-up on ``torch.distributed``.

The JAX package's ``parallel/distributed.py``: start the process group from
arguments or torchrun's environment, the strided slice of a task list a
process takes, a barrier, and a broadcast from rank 0.  Every collective of
:mod:`haplohyped_tpu_torch.parallel` runs over the groups of a
``DeviceMesh`` (:func:`~haplohyped_tpu_torch.parallel.mesh.make_mesh`) on
this process group, so nothing else changes from 1 to N processes.

A multi-process conversion, one process a card (``torchrun
--nproc_per_node=N convert_cohort.py``)::

    from haplohyped_tpu_torch.core.config import MeshConfig
    from haplohyped_tpu_torch.parallel import distributed, make_mesh
    from haplohyped_tpu_torch.parallel.sharded_convert import convert_sharded

    distributed.initialize()                    # torchrun's variables
    rank, world = distributed.process_info()
    mesh = make_mesh(MeshConfig(data=world, model=1))
    cohort = convert_sharded(vcf_for, donors, chroms, mesh)

The backend is NCCL on the card and gloo where the caller asks for the CPU;
a failed NCCL start raises and never falls back to gloo.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from haplohyped_tpu_torch.core.config import resolve_device

logger = logging.getLogger(__name__)


def backend_for(device: str | torch.device) -> str:
    """``"nccl"`` for a CUDA device, ``"gloo"`` for the CPU."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def initialize(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    device: str | torch.device = "cuda",
) -> bool:
    """Start the default process group when running multi-process.

    ``init_method`` (``tcp://host:port``, ``file://path``) is taken from the
    argument, else from torchrun's ``MASTER_ADDR``/``MASTER_PORT``; the world
    size and rank from the arguments, else ``WORLD_SIZE``/``RANK``.  With no
    coordinator set, nothing is set up and it returns False; it returns True
    once the group exists (also where it existed already).  On CUDA each
    process first takes the card ``LOCAL_RANK`` names (else its rank modulo
    the cards it sees) and the backend is NCCL; gloo only for
    ``device="cpu"``."""
    if dist.is_initialized():
        return True
    if init_method is None:
        addr = os.environ.get("MASTER_ADDR")
        if not addr:
            return False
        init_method = f"tcp://{addr}:{os.environ.get('MASTER_PORT', '29500')}"
    world_size = world_size if world_size is not None else int(os.environ.get("WORLD_SIZE", "1"))
    rank = rank if rank is not None else int(os.environ.get("RANK", "0"))
    backend = backend_for(device)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    logger.info("torch.distributed initialized: rank %d of %d over %s", rank, world_size, backend)
    return True


def process_info() -> tuple[int, int]:
    """``(rank, world_size)``; ``(0, 1)`` where no process group exists."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def host_local_tasks(tasks: list) -> list:
    """The strided slice of a global task list this process takes
    (round-robin; :class:`~haplohyped_tpu_torch.parallel.sharded_convert.
    ShardPlan` gives contiguous blocks instead, so each block is one
    single-pass ``frame_v2`` group)."""
    idx, count = process_info()
    return tasks[idx::count]


def barrier() -> None:
    """A sync point of every process (e.g. every shard written before the
    merge).  A no-op at world size 1."""
    if process_info()[1] > 1:
        dist.barrier()


def _comm_device() -> torch.device:
    """Where the default group's collectives take their tensors: the current
    card under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_from_host0(tree):
    """Rank 0's values of ``tree`` (nested dicts, lists and tuples of numpy
    arrays and tensors, the same shapes and dtypes on every rank) on every
    rank; identity at world size 1.  Leaves come back as they went in: numpy
    arrays as numpy arrays, tensors on their own device."""
    if process_info()[1] == 1:
        return tree
    dev = _comm_device()

    def bcast(leaf):
        if isinstance(leaf, dict):
            return {k: bcast(v) for k, v in leaf.items()}
        if isinstance(leaf, (list, tuple)):
            vals = [bcast(v) for v in leaf]
            return type(leaf)(*vals) if hasattr(leaf, "_fields") else type(leaf)(vals)
        t = torch.as_tensor(np.ascontiguousarray(leaf)) if isinstance(leaf, np.ndarray) else leaf
        buf = t.detach().to(dev, copy=True).contiguous()
        dist.broadcast(buf, src=0)
        if isinstance(leaf, np.ndarray):
            return buf.cpu().numpy()
        return buf.to(t.device)

    return bcast(tree)
