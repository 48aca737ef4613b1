"""A small CPU sampler and model size for the port's training tests.

It imports nothing of JAX or the JAX package, so a test module that takes
its sampler from here (and imports no JAX itself) can be collected on the
card's machine, which has no JAX; run it there with ``--noconftest``, since
``tests/conftest.py`` imports JAX.
"""

import numpy as np

from haplohyped_tpu_torch import SamplerConfig
from haplohyped_tpu_torch.core.constants import INT32_MAX
from haplohyped_tpu_torch.data.cohort import CohortTensors
from haplohyped_tpu_torch.data.genome import GenomeTensors
from haplohyped_tpu_torch.data.sampler import DeviceHaplotypeSampler
from haplohyped_tpu_torch.models.haploformer import HaploFormerConfig

#: the sampler's default batch
B = 4


def cpu_sampler(L=128, batch_size=B, seed=0) -> DeviceHaplotypeSampler:
    """A sampler on the CPU over one 20 kb chromosome and three donors."""
    rng = np.random.default_rng(seed)
    G, D, V = 20_000, 3, 256
    codes = rng.integers(0, 4, G).astype(np.int8)
    genome = GenomeTensors.from_code_arrays({"chr1": codes})
    pos = np.full((D, 1, V), INT32_MAX, np.int32)
    n = 200
    for d in range(D):
        pos[d, 0, :n] = np.sort(rng.choice(G, n, replace=False))
    ref = np.where(pos < G, codes[np.minimum(pos, G - 1)], 0).astype(np.int8)
    alt = ((ref + 1) % 4).astype(np.int8)
    p1, p2 = (rng.integers(0, 2, (D, 1, V)).astype(np.int8) for _ in range(2))
    cohort = CohortTensors(["d0", "d1", "d2"], ["chr1"], pos, ref, alt, p1, p2,
                           np.full((D, 1), n, np.int32))
    starts = rng.integers(0, G - 2000, 32)
    spans = np.stack([starts, starts + 1500], axis=1)
    cfg = SamplerConfig(seq_length=L, batch_size=batch_size, seed=seed, max_variants_per_window=32)
    return DeviceHaplotypeSampler(genome, cohort, spans, cfg, device="cpu")


SMALL = HaploFormerConfig(d_model=16, num_heads=2, num_layers=1)
