"""One rank of the multi-process tests of the port's parallel layer
(``tests/test_torch_parallel_mp.py`` starts them); it holds no test itself
and imports no JAX.

    python tests/test_torch_parallel_worker.py <case> <rank> <world> <store> <inputs.npz> <out_dir>

Each rank joins a gloo group through the ``file://`` store, runs its case on
the CPU with one thread, checks what it can see alone (it exits non-zero on a
failed check) and writes what the test compares with the JAX package into
``out_dir``: ``rank{r}.npz`` for each rank, and the train steps' checkpoints.

- ``mesh4`` (4 ranks): one train step on a ``data=2 x model=2`` mesh in
  float32 and in bf16 from the inputs' params, each saved by
  ``save_checkpoint`` and restored into a fresh sharded state (bit-equal
  shards and AdamW slots), the model's shards held against the same cut of
  the global params; then on a ``data=4`` mesh ``sharded_decode_frames``,
  ``all_gather_cohort``, ``psum_counts``, ``sharded_window_gather`` (and its
  refusal of ``L > halo``) and ``convert_sharded`` with numpy decode.
- ``mesh2`` (2 ranks): ``convert_sharded`` with the decode as torch ops,
  ``host_local_tasks``, ``broadcast_from_host0`` and ``barrier``.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from haplohyped_tpu_torch.core.config import MeshConfig  # noqa: E402
from haplohyped_tpu_torch.hostio import vcf as hostio_vcf  # noqa: E402
from haplohyped_tpu_torch.models import train  # noqa: E402
from haplohyped_tpu_torch.models.haploformer import Attention, HaploFormerConfig  # noqa: E402
from haplohyped_tpu_torch.parallel import distributed  # noqa: E402
from haplohyped_tpu_torch.parallel.collectives import (  # noqa: E402
    all_gather_cohort,
    psum_counts,
    sharded_decode_frames,
)
from haplohyped_tpu_torch.parallel.genome_shard import (  # noqa: E402
    ShardedGenome,
    sharded_window_gather,
)
from haplohyped_tpu_torch.parallel.mesh import make_mesh, param_shardings  # noqa: E402
from haplohyped_tpu_torch.parallel.sharded_convert import convert_sharded  # noqa: E402

#: the train steps' widths: heads and MLP hidden dim divide over model=2
TRAIN_WIDTHS = dict(d_model=32, num_heads=4, num_layers=2)
COHORT_FIELDS = ("pos", "ref_code", "alt_code", "phase1", "phase2", "counts")


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def train_case(inp, out_dir: str, dtype: str, mesh) -> dict:
    """One sharded step from the inputs' global params; the checkpoint of
    the state after it under ``out_dir/<dtype>``."""
    cfg = HaploFormerConfig(**TRAIN_WIDTHS, dtype=dtype)
    batch = tuple(torch.from_numpy(inp[k]) for k in ("h1", "h2", "nv"))
    params = {k[len("param/"):]: torch.from_numpy(inp[k]) for k in inp.files
              if k.startswith("param/")}
    state = train.create_train_state(cfg, batch[:2], device="cpu", mesh=mesh)
    placements = param_shardings(state.model, mesh)
    with torch.no_grad():
        for n, p in state.model.named_parameters():
            want = placements[n].local(params[n])
            _check(p.shape == want.shape, f"{n}: shard shape {tuple(p.shape)}")
            p.copy_(want)
    heads = {m.heads for m in state.model.modules() if isinstance(m, Attention)}
    _check(heads == {TRAIN_WIDTHS["num_heads"] // 2}, f"local heads {heads}")
    state, metrics = train.make_train_step(mesh)(state, *batch)
    path = train.save_checkpoint(state, os.path.join(out_dir, dtype))

    fresh = train.create_train_state(cfg, batch[:2], seed=7, device="cpu", mesh=mesh)
    back = train.restore_checkpoint(path, fresh)
    _check(back.step == state.step == 1, "restored step")
    for (n, p), q in zip(state.model.named_parameters(), back.model.parameters()):
        _check(torch.equal(p, q), f"restored shard {n}")
    sa, sb = state.optimizer.state_dict()["state"], back.optimizer.state_dict()["state"]
    for i in sa:
        for k in sa[i]:
            _check(torch.equal(sa[i][k], sb[i][k]), f"restored AdamW slot {i} {k}")
    return {f"{dtype}/{k}": v.numpy() for k, v in metrics.items()}


def mesh4(rank: int, inp, out_dir: str) -> dict:
    out = {}
    mesh22 = make_mesh(MeshConfig(2, 2), device="cpu")
    for dtype in ("float32", "bfloat16"):
        out |= train_case(inp, out_dir, dtype, mesh22)
    # the model axis of the same mesh
    out["gather_model"] = all_gather_cohort(np.full((2, 1), rank, np.int32), mesh22,
                                            axis="model").numpy()

    mesh = make_mesh(MeshConfig(4, 1), device="cpu")
    dec = sharded_decode_frames(inp["frames"], mesh)
    out |= {f"decode/{k}": getattr(dec, k).numpy() for k in dec._fields}
    x = inp["cohort_x"]
    blk = x.shape[0] // 4
    out["gather"] = all_gather_cohort(x[rank * blk:(rank + 1) * blk], mesh).numpy()
    ones = inp["ones"]
    blk = ones.shape[0] // 4
    out["psum"] = psum_counts(ones[rank * blk:(rank + 1) * blk], mesh).numpy()

    genome = ShardedGenome.from_codes(inp["codes"], mesh, halo=int(inp["halo"]))
    out["genome_chunk"] = np.int64(genome.chunk)
    out["windows"] = sharded_window_gather(genome, inp["starts"], int(inp["L"])).numpy()
    try:
        sharded_window_gather(genome, inp["starts"], int(inp["halo"]) + 1)
    except ValueError as e:
        out["halo_refused"] = np.array(str(e))
    out |= convert_case(inp, mesh, device_decode=False)
    return out


def convert_case(inp, mesh, device_decode: bool) -> dict:
    vcf_for = json.loads(str(inp["vcf_for"]))
    hostio_vcf.FRAME_COUNTS.clear()
    ct = convert_sharded(vcf_for, list(inp["donors"]), list(inp["chroms"]), mesh,
                         threads=1, host_workers=1, device_decode=device_decode)
    out = {f"cohort/{k}": getattr(ct, k) for k in COHORT_FIELDS}
    out["frame_counts"] = np.array(json.dumps(dict(hostio_vcf.FRAME_COUNTS)))
    return out


def mesh2(rank: int, inp, out_dir: str) -> dict:
    mesh = make_mesh(MeshConfig(2, 1), device="cpu")
    out = convert_case(inp, mesh, device_decode=True)
    _check(distributed.process_info() == (rank, 2), "process_info")
    out["tasks"] = np.array(distributed.host_local_tasks(list(range(7))))
    tree = {"a": np.full((3,), rank, np.int32), "b": [torch.full((2, 2), float(rank))]}
    got = distributed.broadcast_from_host0(tree)
    _check(isinstance(got["a"], np.ndarray) and isinstance(got["b"][0], torch.Tensor),
           "broadcast leaf types")
    out["bcast_a"], out["bcast_b"] = got["a"], got["b"][0].numpy()
    distributed.barrier()
    return out


CASES = {"mesh4": mesh4, "mesh2": mesh2}


def main() -> None:
    case, rank, world, store, inputs, out_dir = sys.argv[1:7]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    ok = distributed.initialize(init_method=f"file://{store}", world_size=world, rank=rank,
                                device="cpu")
    _check(ok and dist.get_backend() == "gloo", "gloo group")
    with np.load(inputs) as inp:
        out = CASES[case](rank, inp, out_dir)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
