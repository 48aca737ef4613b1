"""Position-sharded genome with a halo.

The JAX package's ``parallel/genome_shard.py`` on ``torch.distributed``, for
genomes past one card's memory: the flat genome codes split into contiguous
chunks over the ``data`` axis, each extended by an ``L``-byte halo copied
from the start of the next chunk, so any window of at most ``L`` bases
resolves on the rank that owns its start.  The one collective is an int8
all-reduce that sums each rank's masked windows (exactly one rank owns each
start).  The chunk geometry is JAX's, so the same starts land on the same
shard; each rank holds only its own chunk and halo on its device, where the
JAX package keeps every chunk in one sharded array.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from haplohyped_tpu_torch.core.constants import N_CODE
from haplohyped_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size, mesh_device


@dataclass
class ShardedGenome:
    """This rank's chunk of genome codes split over ``axis``, with its halo."""

    chunk: int  # bases a shard (halo excluded), a multiple of 128
    halo: int  # halo bytes (>= the longest window)
    total_len: int
    chunk_local: torch.Tensor  # (chunk + halo,) int8 on this rank's device
    mesh: DeviceMesh
    axis: str = "data"

    @classmethod
    def from_codes(cls, codes: np.ndarray | torch.Tensor, mesh: DeviceMesh, halo: int,
                   axis: str = "data") -> "ShardedGenome":
        """Split flat int8 ``codes`` (host numpy or a tensor on any device, the
        same on every rank) into ``ceil(total / S)`` bases a shard, rounded up
        to a multiple of 128, padded with ``N_CODE`` past the end."""
        s = axis_size(mesh, axis)
        total = codes.shape[0]
        chunk = -(-total // s)
        chunk = -(-chunk // 128) * 128
        lo = axis_rank(mesh, axis) * chunk
        hi = min(lo + chunk + halo, total)
        row = torch.full((chunk + halo,), N_CODE, dtype=torch.int8, device=mesh_device(mesh))
        if hi > lo:
            part = codes[lo:hi]
            if isinstance(part, np.ndarray):
                part = torch.from_numpy(np.ascontiguousarray(part))
            row[: hi - lo].copy_(part)
        return cls(chunk=chunk, halo=halo, total_len=total, chunk_local=row, mesh=mesh, axis=axis)


def sharded_window_gather(genome: ShardedGenome, starts, L: int) -> torch.Tensor:
    """``(B, L)`` int8 windows at global 0-based ``starts`` (the same on
    every rank), on every rank.  Each rank slices the windows whose start
    it owns from its chunk and halo and zeros the rest; one all-reduce over
    the genome's axis sums them.  A start that no shard owns (negative, or
    at or past ``S * chunk``) gives zeros, as in the JAX package."""
    if L > genome.halo:
        raise ValueError(f"window length {L} exceeds halo {genome.halo}")
    row = genome.chunk_local
    if isinstance(starts, np.ndarray):
        starts = torch.from_numpy(starts)
    starts = torch.as_tensor(starts).to(row.device, torch.int64)
    local = starts - axis_rank(genome.mesh, genome.axis) * genome.chunk
    owned = (local >= 0) & (local < genome.chunk)
    safe = local.clamp(0, genome.chunk - 1)
    win = row[safe[:, None] + torch.arange(L, device=row.device)]
    win.masked_fill_(~owned[:, None], 0)
    dist.all_reduce(win, group=axis_group(genome.mesh, genome.axis))
    return win
