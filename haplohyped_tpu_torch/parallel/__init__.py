"""The parallel layer on ``torch.distributed``: a ``('data', 'model')``
process mesh and its parameter rules, collectives, a position-sharded
genome, the sharded converter and multi-process set-up."""
from haplohyped_tpu_torch.parallel.mesh import (
    PARAM_RULES,
    make_mesh,
    param_shardings,
    shard_batch_spec,
)
from haplohyped_tpu_torch.parallel.collectives import (
    sharded_decode_frames,
    all_gather_cohort,
)

__all__ = [
    "PARAM_RULES",
    "make_mesh",
    "param_shardings",
    "shard_batch_spec",
    "sharded_decode_frames",
    "all_gather_cohort",
]
