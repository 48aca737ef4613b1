"""Mesh-sharded cohort conversion, one file pass per (chromosome, shard).

The JAX package's ``parallel/sharded_convert.py`` on ``torch.distributed``:
(donor, chromosome) tasks go in contiguous blocks to the ``data`` shards
(one process each, on its own card), each shard parses its block, and the
per-shard variant tensors merge into the cohort with one all-gather over
``data``.  Each process reads only its own block's VCF bytes; the
collectives are the only communication.

Tasks are chromosome-major, so a shard's block is a run of donors within one
chromosome (spanning at most a few chromosome boundaries), and each
(chromosome, donor block) costs ONE ``frame_v2`` pass that extracts every
donor's genotypes, where the reference re-reads the file per donor.
``hostio.vcf.FRAME_COUNTS`` counts the passes.
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from haplohyped_tpu_torch.core.config import resolve_device
from haplohyped_tpu_torch.core.constants import BASE_LUT, INT32_MAX, SNP_STRUCT_DTYPE
from haplohyped_tpu_torch.data.cohort import CohortTensors
from haplohyped_tpu_torch.hostio.vcf import VCFSource
from haplohyped_tpu_torch.parallel.collectives import all_gather_cohort
from haplohyped_tpu_torch.parallel.mesh import axis_rank, axis_size, mesh_device
from haplohyped_tpu_torch.pipeline.records import snp_structs_from_v2
from haplohyped_tpu_torch.pipeline.vcf_to_h5 import _decode_v2, _device_lock

logger = logging.getLogger(__name__)

_EMPTY_STRUCT = np.zeros(0, dtype=SNP_STRUCT_DTYPE)


@dataclass
class ShardPlan:
    """Contiguous-block task assignment over the data axis: shard ``s``'s
    tasks are rows ``[s * r, (s + 1) * r)`` of the task list padded to a
    multiple of the shard count, the rows a ``P('data')`` sharding gives it.

    Tasks are chromosome-major: shard s's block is a run of donors within
    one chromosome, so the shard needs ~1 file pass a chromosome it touches."""

    tasks: list[tuple[str, str]]  # (donor, chrom_name), chromosome-major
    n_shards: int

    @property
    def t_pad(self) -> int:
        return -(-len(self.tasks) // self.n_shards) * self.n_shards

    @property
    def rows_per_shard(self) -> int:
        return self.t_pad // self.n_shards

    def shard_rows(self, shard: int) -> range:
        r = self.rows_per_shard
        return range(shard * r, (shard + 1) * r)

    def shard_tasks(self, shard: int) -> list[tuple[str, str]]:
        return [self.tasks[i] for i in self.shard_rows(shard) if i < len(self.tasks)]


def plan_shards(donors: list[str], chrom_names: list[str], n_shards: int) -> ShardPlan:
    tasks = [(d, c) for c in chrom_names for d in donors]
    return ShardPlan(tasks=tasks, n_shards=n_shards)


def _parse_task_group(vcf_path: str, donors: list[str], chrom: str, threads: int,
                      device: torch.device | None) -> dict[str, np.ndarray]:
    """One (chromosome, donor block) -> each donor's SNP struct from ONE
    file pass (``frame_v2`` extracts every donor's genotypes at once), the
    v2 decode on ``device`` (numpy where None)."""
    frame = VCFSource(vcf_path, threads=threads).frame_v2(samples=donors, region=chrom)
    if device is None:
        decoded = _decode_v2(frame, None)
    else:
        with _device_lock:  # one device decode at a time, as the converter's
            decoded = _decode_v2(frame, device)
    return snp_structs_from_v2(decoded, frame.chroms, frame.samples, chrom_filter=chrom)


def _structs_to_task_tensors(structs: list[np.ndarray], vmax: int):
    """Stack per-task structs into padded (T, V) columns."""
    T = len(structs)
    pos = np.full((T, vmax), INT32_MAX, np.int32)
    ref = np.zeros((T, vmax), np.int8)
    alt = np.zeros((T, vmax), np.int8)
    p1 = np.zeros((T, vmax), np.int8)
    p2 = np.zeros((T, vmax), np.int8)
    cnt = np.zeros((T,), np.int32)
    for i, s in enumerate(structs):
        n = s.shape[0]
        if n == 0:
            continue
        order = np.argsort(s["start"].astype(np.int64), kind="stable")
        s = s[order]
        pos[i, :n] = s["start"].astype(np.int32)
        rb = np.frombuffer(s["ref"].tobytes(), np.uint8).reshape(n, 10)[:, 0]
        ab = np.frombuffer(s["alt"].tobytes(), np.uint8).reshape(n, 10)[:, 0]
        ref[i, :n] = BASE_LUT[rb]
        alt[i, :n] = BASE_LUT[ab]
        p1[i, :n] = s["phase1"]
        p2[i, :n] = s["phase2"]
        cnt[i] = n
    return pos, ref, alt, p1, p2, cnt


def _local_data_shards(mesh: DeviceMesh) -> list[int]:
    """The data-axis indices this process parses: its own coordinate.  The
    ranks of one ``data`` coordinate (its ``model`` ranks) parse the same
    block; each needs the merged cohort and the parse is host work."""
    return [axis_rank(mesh, "data")]


def convert_sharded(
    vcf_path_for: dict[str, str],  # chrom_name -> vcf path
    donors: list[str],
    chrom_names: list[str],
    mesh: DeviceMesh,
    threads: int = 2,
    host_workers: int = 4,
    device_decode: bool = False,
    device: str | torch.device | None = None,
) -> CohortTensors:
    """Convert a cohort into numpy ``CohortTensors``, the same on every rank,
    by the sharded plan.

    Each process parses only the (donor, chromosome) rows of its ``data``
    coordinate: its rows grouped by chromosome, ONE ``frame_v2`` pass a
    group whatever its donor count, the groups over ``host_workers``
    threads.  ``device_decode=True`` runs the v2 decode as torch ops on
    ``device`` (the mesh's device where None); numpy decodes otherwise.
    ``V`` is the largest task's count over every rank (an all-reduce MAX),
    rounded up to 128, and each column merges with an all-gather over
    ``data``."""
    dev = resolve_device(device) if device is not None else mesh_device(mesh)
    n_shards = axis_size(mesh, "data")
    plan = plan_shards(donors, chrom_names, n_shards)
    my_rows = [i for s in _local_data_shards(mesh) for i in plan.shard_rows(s)]
    my_tasks = [plan.tasks[i] if i < len(plan.tasks) else None for i in my_rows]

    # group this process's rows by chromosome: one frame_v2 pass a
    # (chromosome, local donor set); None rows are padding
    groups: dict[str, list[int]] = {}
    for k, t in enumerate(my_tasks):
        if t is not None:
            groups.setdefault(t[1], []).append(k)

    structs: list[np.ndarray] = [_EMPTY_STRUCT] * len(my_tasks)

    def parse_group(item):
        chrom, idxs = item
        block_donors = list(dict.fromkeys(my_tasks[k][0] for k in idxs))
        per_donor = _parse_task_group(vcf_path_for[chrom], block_donors, chrom, threads,
                                      dev if device_decode else None)
        return idxs, per_donor

    with ThreadPoolExecutor(max_workers=host_workers) as ex:
        for idxs, per_donor in ex.map(parse_group, groups.items()):
            for k in idxs:
                structs[k] = per_donor[my_tasks[k][0]]

    # V must agree across processes: the largest task anywhere
    vmax_t = torch.tensor([max((s.shape[0] for s in structs), default=1)],
                          dtype=torch.int64, device=mesh_device(mesh))
    dist.all_reduce(vmax_t, op=dist.ReduceOp.MAX)
    vmax = -(-max(int(vmax_t), 1) // 128) * 128

    cols = _structs_to_task_tensors(structs, vmax)
    pos, ref, alt, p1, p2, cnt = (all_gather_cohort(c, mesh).cpu().numpy() for c in cols)

    D, C = len(donors), len(chrom_names)
    out = CohortTensors(
        donors=list(donors),
        chrom_names=list(chrom_names),
        pos=np.full((D, C, vmax), INT32_MAX, np.int32),
        ref_code=np.zeros((D, C, vmax), np.int8),
        alt_code=np.zeros((D, C, vmax), np.int8),
        phase1=np.zeros((D, C, vmax), np.int8),
        phase2=np.zeros((D, C, vmax), np.int8),
        counts=np.zeros((D, C), np.int32),
    )
    for i, (donor, chrom) in enumerate(plan.tasks):
        d = donors.index(donor)
        c = chrom_names.index(chrom)
        out.pos[d, c] = pos[i]
        out.ref_code[d, c] = ref[i]
        out.alt_code[d, c] = alt[i]
        out.phase1[d, c] = p1[i]
        out.phase2[d, c] = p2[i]
        out.counts[d, c] = cnt[i]
    return out
