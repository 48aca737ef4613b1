"""Sharded decode, cohort merge, and the tensor-parallel collectives.

The JAX package's ``parallel/collectives.py`` on ``torch.distributed``:
framed VCF records shard over the ``data`` axis, each rank decodes its
contiguous block on its device (the decode64 Hopper kernel on the card, its
plain version on the CPU), and per-rank tensors merge into the cohort with
one all-gather.  Where the JAX functions take and return global arrays that
XLA shards, these take and return the rank's block: nothing here inserts a
collective that the code does not issue.

Also the Megatron pair that :func:`~haplohyped_tpu_torch.parallel.mesh.
shard_model` puts into HaploFormer's blocks: :func:`copy_to_group` (identity
forward, all-reduce backward) at the input of the column-sharded
projections, and :func:`reduce_over_group` (all-reduce forward, identity
backward) after the row-sharded ones.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from haplohyped_tpu_torch.ops.decode_kernel import decode_frames_kernel
from haplohyped_tpu_torch.ops.vcf_decode import DecodedVariants, unpack64_decoded
from haplohyped_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size, mesh_device


def _on_mesh(x, mesh: DeviceMesh) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(mesh_device(mesh)).contiguous()


def sharded_decode_frames(frames: np.ndarray | torch.Tensor, mesh: DeviceMesh) -> DecodedVariants:
    """This rank's block of the decode of ``(N, 64)`` frames (the same
    frames on every rank).  The record count is padded to a multiple of the
    ``data`` size and rank ``d`` takes rows ``[d * n, (d + 1) * n)`` of it,
    cut to the real records: the blocks concatenated in ``data``-rank order
    are the decode of ``frames``.  Ranks that share a ``data`` coordinate
    decode the same block."""
    n = frames.shape[0]
    per = -(-n // axis_size(mesh, "data"))
    lo = min(axis_rank(mesh, "data") * per, n)
    block = _on_mesh(frames[lo:min(lo + per, n)], mesh)
    return unpack64_decoded(*decode_frames_kernel(block))


def all_gather_cohort(local, mesh: DeviceMesh, axis: str = "data") -> torch.Tensor:
    """The ranks' blocks (each the same shape) concatenated along dim 0 in
    ``axis``-rank order, on every rank: the cohort-merge collective."""
    x = _on_mesh(local, mesh)
    parts = [torch.empty_like(x) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, x, group=axis_group(mesh, axis))
    return torch.cat(parts)


def psum_counts(local, mesh: DeviceMesh, axis: str = "data") -> torch.Tensor:
    """``(1,)``: the sum of every rank's block over ``axis`` (validation
    checksums), in the block's dtype."""
    x = _on_mesh(local, mesh)
    total = x.sum(dtype=x.dtype).reshape(1)
    dist.all_reduce(total, group=axis_group(mesh, axis))
    return total


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` unchanged; its gradient summed over ``group``.  It enters a
    tensor-parallel region whose ranks each use ``x`` for their share."""
    return _CopyToGroup.apply(x, group)


def reduce_over_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``; its gradient passed through unchanged
    (``torch.distributed.nn.functional.all_reduce`` would sum it again).  It
    leaves a tensor-parallel region of partial products."""
    return _ReduceOverGroup.apply(x, group)
