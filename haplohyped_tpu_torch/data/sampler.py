"""On-device haplotype batch sampler.

Draws (region, donor, chromosome) triples, crops each region to a window of
``seq_length`` around its midpoint, clamps the window into the drawn
chromosome, and encodes the variant-aware haplotype windows, all on the
device: each call returns a ready batch with no host round-trip.

Sampling has two steps.  :meth:`DeviceHaplotypeSampler.draw_indices` makes a
step's draws from a ``torch.Generator`` seeded from ``(config.seed, step)``
alone, so ``sample_many(n)`` equals ``n`` successive ``sample()`` calls.
:meth:`DeviceHaplotypeSampler.windows_from_draws` turns draws into windows;
it takes any draws, so a test can feed it the JAX package's own.  The region
only supplies a span; region, donor and chromosome are drawn independently.

Default output is ``(B, L)`` int8 base codes, with ``hap1`` and
``hap1_codes`` the same tensor.  ``emit_onehot=True`` adds materialised
``(B, L, C)`` one-hot ``hap1``/``hap2``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from haplohyped_tpu_torch.core.config import SamplerConfig, resolve_device
from haplohyped_tpu_torch.data.cohort import CohortTensors
from haplohyped_tpu_torch.data.genome import GenomeTensors
from haplohyped_tpu_torch.data.regions import load_bed_regions
from haplohyped_tpu_torch.ops.haplotype_window import (
    encode_haplotype_windows,
    windows_to_onehot,
)
from haplohyped_tpu_torch.ops.window_kernel import (
    WindowIndex,
    build_window_index,
    encode_windows_kernel,
)

_MASK64 = (1 << 64) - 1


def _step_seed(seed: int, step: int) -> int:
    """Generator seed of one sampling step: a splitmix64 mix of ``(seed,
    step)``.  Both halves of the 64 bits depend on both inputs, since the CPU
    generator keeps only the low 32."""
    x = (seed * 0x9E3779B97F4A7C15 + step) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


class HaplotypeBatch(NamedTuple):
    """One sampled batch.  In codes mode (``emit_onehot=False``) ``hap1`` IS
    ``hap1_codes`` (and ``hap2`` is ``hap2_codes``)."""

    hap1: torch.Tensor  # (B, L, C) one-hot, or (B, L) int8 codes (codes mode)
    hap2: torch.Tensor  # same form as hap1
    hap1_codes: torch.Tensor  # (B, L) int8
    hap2_codes: torch.Tensor  # (B, L) int8
    n_variants: torch.Tensor  # (B,) int32
    overflow: torch.Tensor  # (B,) int32


class DeviceHaplotypeSampler:
    """Holds the genome, cohort and regions on the device and samples
    haplotype window batches from them."""

    def __init__(
        self,
        genome: GenomeTensors,
        cohort: CohortTensors,
        region_spans: np.ndarray,  # (R, 2)
        config: SamplerConfig = SamplerConfig(),
        num_channels: int = 5,
        onehot_dtype: torch.dtype = torch.float32,
        emit_onehot: bool = False,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        cohort_dev = cohort.device_arrays(self.device)
        if genome.chrom_names != cohort.chrom_names:
            # re-order/subset the cohort chrom axis into the genome's index
            # space (chrom_idx is drawn in genome space; a mismatched layout
            # would silently apply the wrong chromosome's variants)
            missing = [c for c in genome.chrom_names if c not in cohort.chrom_names]
            if missing:
                raise ValueError(f"cohort lacks chromosomes present in genome: {missing}")
            order = torch.tensor(
                [cohort.chrom_names.index(c) for c in genome.chrom_names],
                device=self.device,
            )
            cohort_dev = tuple(a.index_select(1, order) for a in cohort_dev)
            cohort = CohortTensors(cohort.donors, list(genome.chrom_names), *cohort_dev)
        self.genome = genome
        self.cohort = cohort
        self.config = config
        self.num_channels = num_channels
        self.onehot_dtype = onehot_dtype
        self.emit_onehot = emit_onehot
        self.kernel = config.resolved_kernel(self.device)

        flat, offsets, self._lengths = genome.device_arrays(self.device)
        #: operands of the plain version: genome, offsets, then the cohort's
        self._plain_args = (flat, offsets, *cohort_dev)
        self._regions = torch.as_tensor(
            np.asarray(region_spans).astype(np.int32), device=self.device
        )
        self.generator = torch.Generator(device=self.device)
        self._step = 0
        if self.kernel == "kernel":
            self.index  # build it now, not in the first sample() call

    @functools.cached_property
    def index(self) -> WindowIndex:
        """The kernel's index (built once per sampler)."""
        return build_window_index(*self._plain_args)

    @classmethod
    def from_files(
        cls,
        bed_file: str,
        cohort_h5: str,
        reference_h5: str,
        samples_file: str | None = None,
        config: SamplerConfig = SamplerConfig(),
        **kwargs,
    ) -> "DeviceHaplotypeSampler":
        resolve_device(kwargs.get("device", "cuda"))  # fail before loading
        donors = None
        if samples_file:
            with open(samples_file) as f:
                donors = [line.strip() for line in f if line.strip()]
        genome = GenomeTensors.from_h5(reference_h5)
        cohort = CohortTensors.from_h5(cohort_h5, donors=donors, chrom_names=genome.chrom_names)
        _, spans, _ = load_bed_regions(bed_file)
        return cls(genome, cohort, spans, config, **kwargs)

    def draw_indices(self, step: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(region_idx, donor_idx, chrom_idx)``, each ``(B,)`` int32, of
        sampling step ``step``: a function of ``(config.seed, step)`` only."""
        g = self.generator
        g.manual_seed(_step_seed(self.config.seed, step))
        B = self.config.batch_size
        sizes = (
            self._regions.shape[0],
            self.cohort.num_donors,
            len(self.genome.chrom_names),
        )
        return tuple(
            torch.randint(0, n, (B,), generator=g, device=self.device, dtype=torch.int32)
            for n in sizes
        )

    def window_starts(self, region_idx: torch.Tensor, chrom_idx: torch.Tensor) -> torch.Tensor:
        """(B,) int32 window starts: each region's midpoint crop, clamped so
        the window stays inside the drawn chromosome."""
        L = self.config.seq_length
        span = self._regions[region_idx.long()]  # (B, 2)
        mid = (span[:, 0] + span[:, 1]) // 2
        new_start = (mid - L // 2).clamp(min=0)
        limit = (self._lengths[chrom_idx.long()] - L).clamp(min=0)
        return torch.minimum(new_start, limit).to(torch.int32)

    def windows_from_draws(
        self,
        region_idx: torch.Tensor,
        donor_idx: torch.Tensor,
        chrom_idx: torch.Tensor,
        kernel: str | None = None,
    ) -> HaplotypeBatch:
        """Crop (:meth:`window_starts`), encode and, with ``emit_onehot``,
        one-hot the windows of the given draws.  ``kernel`` overrides the sampler's
        ``"kernel"``/``"baseline"`` choice."""
        L = self.config.seq_length
        K = self.config.max_variants_per_window
        start = self.window_starts(region_idx, chrom_idx)
        kernel = kernel or self.kernel
        if kernel == "kernel":
            win = encode_windows_kernel(self.index, donor_idx, chrom_idx, start, L=L, K=K)
        elif kernel == "baseline":
            win = encode_haplotype_windows(
                *self._plain_args, donor_idx, chrom_idx, start, L=L, K=K
            )
        else:
            raise ValueError(f"unknown window kernel: {kernel!r}")
        if self.emit_onehot:
            hap1 = windows_to_onehot(win.hap1, self.num_channels, self.onehot_dtype)
            hap2 = windows_to_onehot(win.hap2, self.num_channels, self.onehot_dtype)
        else:
            hap1, hap2 = win.hap1, win.hap2  # the same tensors: no extra writes
        return HaplotypeBatch(hap1, hap2, win.hap1, win.hap2, win.n_variants, win.overflow)

    def sample(self) -> HaplotypeBatch:
        """Draw one batch and advance the step counter."""
        step = self._step
        self._step += 1
        return self.windows_from_draws(*self.draw_indices(step))

    def sample_many(self, n_batches: int) -> HaplotypeBatch:
        """``n_batches`` batches, leaves stacked ``(n_batches, B, ...)``:
        equal to ``n_batches`` successive :meth:`sample` calls, encoded in
        one pass (one kernel launch) over all their windows."""
        if n_batches < 1:
            raise ValueError(f"n_batches must be >= 1, got {n_batches}")
        steps = range(self._step, self._step + n_batches)
        self._step += n_batches
        region_idx, donor_idx, chrom_idx = (
            torch.cat(t) for t in zip(*(self.draw_indices(s) for s in steps))
        )
        b = self.windows_from_draws(region_idx, donor_idx, chrom_idx)

        def stack(t):
            return t.view(n_batches, -1, *t.shape[1:])

        codes1, codes2 = stack(b.hap1_codes), stack(b.hap2_codes)
        if self.emit_onehot:
            hap1, hap2 = stack(b.hap1), stack(b.hap2)
        else:
            hap1, hap2 = codes1, codes2
        return HaplotypeBatch(hap1, hap2, codes1, codes2, stack(b.n_variants), stack(b.overflow))

    def __iter__(self):
        while True:
            yield self.sample()
