"""On-device haplotype batch sampler.

Draws (region, donor, chromosome) triples, crops each region to a window of
``seq_length`` around its midpoint, clamps the window into the drawn
chromosome, and encodes the variant-aware haplotype windows, all on the
device: each call returns a ready batch with no host round-trip.

Sampling has two steps.  :meth:`DeviceHaplotypeSampler.draw_indices` makes a
step's draws from a ``torch.Generator`` seeded from ``(config.seed, step)``
alone (``(key, step)`` under ``key=``), so ``sample_many(n)`` equals ``n``
successive ``sample()`` calls.  :meth:`DeviceHaplotypeSampler.windows_from_draws`
turns draws into windows; it takes any draws, so a test can feed it the JAX
package's own.  The region only supplies a span; region, donor and chromosome
are drawn independently.

:meth:`DeviceHaplotypeSampler.sample_chain` runs ``n_chain`` dependent
``sample_many``-sized links, each link's seed mixed from the one before and
that link's :func:`chain_digest`, and returns the digests' sum: the one fetch
that proves every link ran.  Its draws are counter-based (:func:`counter_draws`,
int64 torch ops on a seed that stays on the device), so on the card the whole
chain is one CUDA graph, replayed with no host round-trip.

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
_MASK32 = (1 << 32) - 1


def _as_int64(x: int) -> int:
    """An unsigned 64-bit value as the int64 with the same bits."""
    return x - (1 << 64) if x >> 63 else x


#: splitmix64's increment and finalizer multipliers, and the odd multiplier
#: that spreads a digest over the 64 seed bits, as int64
_GOLDEN, _MIX1, _MIX2, _DIGEST_MUL = map(
    _as_int64, (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9, 0x94D049BB133111EB, 0xD1B54A32D192ED03)
)


def _step_seed(seed: int, step: int) -> int:
    """Generator seed of one sampling step: a splitmix64 mix of ``(seed,
    step)``.  Both halves of the 64 bits depend on both inputs, since the CPU
    generator keeps only the low 32."""
    x = (seed * 0x9E3779B97F4A7C15 + step) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _lsr(z: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 ``z`` (torch's ``>>`` is arithmetic)."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def _mix64(z: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer, a bijection of the 64 bits, in int64 ops
    (products wrap on the CPU and on the card alike)."""
    z = (z ^ _lsr(z, 30)) * _MIX1
    z = (z ^ _lsr(z, 27)) * _MIX2
    return z ^ _lsr(z, 31)


def counter_draws(seed: torch.Tensor, n: int, sizes: tuple[int, ...]) -> tuple[torch.Tensor, ...]:
    """``len(sizes)`` draws of ``n`` lanes, each ``(n,)`` int32 in ``[0,
    sizes[f])``, a function of the ``(1,)`` int64 ``seed`` alone.

    Draw ``f`` of lane ``i`` is output ``i * len(sizes) + f`` of the
    splitmix64 stream from ``seed``, ``mix64(seed + (i * F + f + 1) *
    golden)``, reduced from its high 32 bits ``h`` as ``(h * size) >> 32``.
    Only device ops on the seed's device, so a CUDA graph can capture it."""
    F = len(sizes)
    lane = torch.arange(n, dtype=torch.int64, device=seed.device)
    field = torch.arange(1, F + 1, dtype=torch.int64, device=seed.device)
    ctr = lane * F + field[:, None]  # (F, n)
    hi = _lsr(_mix64(seed + ctr * _GOLDEN), 32)
    return tuple(((hi[f] * size) >> 32).to(torch.int32) for f, size in enumerate(sizes))


def _parity(codes: torch.Tensor) -> torch.Tensor:
    """() int64: the parity of the sum of int8 ``codes``."""
    return codes.sum(dtype=torch.int8).long() & 1


def chain_digest(batch: "HaplotypeBatch") -> torch.Tensor:
    """() int64 in ``[0, 2^32)``: the JAX package's chain digest of a batch,
    ``parity(Σ hap1_codes & 1) ^ parity(Σ hap2_codes & 1) << 1 ^ Σ n_variants``
    (mod 2^32), and, where ``hap1``/``hap2`` are one-hot, their parities
    ``<< 2`` and ``<< 3``.  Every window byte feeds it."""
    # Σ (x & 1) and Σ x have one parity, and a sum kept in int8 (mod 2^8)
    # keeps it too, so the codes are reduced as they lie: a wider dtype would
    # first write a widened copy of every window
    digest = (_parity(batch.hap1_codes) ^ (_parity(batch.hap2_codes) << 1)
              ^ (batch.n_variants.sum(dtype=torch.int64) & _MASK32))
    if batch.hap1.dim() > batch.hap1_codes.dim():  # the one-hot leaves
        # 0/1 leaves: their sum is their count of non-zeros, read in place
        digest = digest ^ ((torch.count_nonzero(batch.hap1) & 1) << 2) ^ (
            (torch.count_nonzero(batch.hap2) & 1) << 3
        )
    return digest


class HaplotypeBatch(NamedTuple):
    """One sampled batch.  In codes mode (``emit_onehot=False``) ``hap1`` IS
    ``hap1_codes`` (and ``hap2`` is ``hap2_codes``)."""

    hap1: torch.Tensor  # (B, L, C) one-hot, or (B, L) int8 codes (codes mode)
    hap2: torch.Tensor  # same form as hap1
    hap1_codes: torch.Tensor  # (B, L) int8
    hap2_codes: torch.Tensor  # (B, L) int8
    n_variants: torch.Tensor  # (B,) int32
    overflow: torch.Tensor  # (B,) int32


class ChainRun(NamedTuple):
    """One :meth:`DeviceHaplotypeSampler.sample_chain` run."""

    digest: torch.Tensor  # () int64: the links' digests summed mod 2^32
    seeds: torch.Tensor  # (n_chain,) int64: each link's seed
    last: HaplotypeBatch  # the last link's batches, leaves (n_batches, B, ...)


def _stacked(b: HaplotypeBatch, n_batches: int) -> HaplotypeBatch:
    """A batch of ``n_batches * B`` windows as ``n_batches`` stacked batches."""

    def stack(t):
        return t.view(n_batches, -1, *t.shape[1:])

    codes1, codes2 = stack(b.hap1_codes), stack(b.hap2_codes)
    hap1, hap2 = (codes1, codes2) if b.hap1 is b.hap1_codes else (stack(b.hap1), stack(b.hap2))
    return HaplotypeBatch(hap1, hap2, codes1, codes2, stack(b.n_variants), stack(b.overflow))


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
        self._chain_graph_cache = None  # ((n_chain, n_batches, emit_onehot), replay)
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

    @property
    def _draw_sizes(self) -> tuple[int, int, int]:
        """The ranges of the region, donor and chromosome draws."""
        return (self._regions.shape[0], self.cohort.num_donors, len(self.genome.chrom_names))

    def draw_indices(
        self, step: int, seed: int | None = None
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(region_idx, donor_idx, chrom_idx)``, each ``(B,)`` int32, of
        sampling step ``step``: a function of ``(seed, step)`` only, ``seed``
        ``config.seed`` unless given."""
        g = self.generator
        g.manual_seed(_step_seed(self.config.seed if seed is None else seed, step))
        B = self.config.batch_size
        return tuple(
            torch.randint(0, n, (B,), generator=g, device=self.device, dtype=torch.int32)
            for n in self._draw_sizes
        )

    def chain_draws(self, seed: torch.Tensor, n_batches: int) -> tuple[torch.Tensor, ...]:
        """The draws of one :meth:`sample_chain` link of ``n_batches``
        batches from its ``(1,)`` int64 seed: :func:`counter_draws` of
        ``n_batches * B`` lanes, batch ``i`` in lanes ``[i * B, (i + 1) * B)``."""
        return counter_draws(seed, n_batches * self.config.batch_size, self._draw_sizes)

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

    def _first_step(self, n_steps: int, key: int | None) -> tuple[int, int]:
        """``(seed, step)`` of a call of ``n_steps`` steps: ``(key, 0)`` with
        a key, else ``(config.seed, step counter)``, advancing the counter."""
        if key is not None:
            return key, 0
        step = self._step
        self._step += n_steps
        return self.config.seed, step

    def sample(self, key: int | None = None) -> HaplotypeBatch:
        """Draw one batch.  Without ``key``, step ``_step`` of
        ``config.seed``, advancing the step counter; with it, step 0 of
        ``key``, leaving the counter alone (JAX's ``sample(key=)``)."""
        seed, step = self._first_step(1, key)
        return self.windows_from_draws(*self.draw_indices(step, seed))

    def sample_many(self, n_batches: int, key: int | None = None) -> HaplotypeBatch:
        """``n_batches`` batches, leaves stacked ``(n_batches, B, ...)``:
        equal to ``n_batches`` successive :meth:`sample` calls (steps ``0 ..
        n_batches - 1`` of ``key`` with a key), encoded in one pass (one
        kernel launch) over all their windows."""
        if n_batches < 1:
            raise ValueError(f"n_batches must be >= 1, got {n_batches}")
        seed, step0 = self._first_step(n_batches, key)
        region_idx, donor_idx, chrom_idx = (
            torch.cat(t)
            for t in zip(*(self.draw_indices(s, seed) for s in range(step0, step0 + n_batches)))
        )
        return _stacked(self.windows_from_draws(region_idx, donor_idx, chrom_idx), n_batches)

    def _chain_links(self, seed: torch.Tensor, n_chain: int, n_batches: int,
                     kernel: str) -> ChainRun:
        """The chain from its ``(1,)`` int64 first seed, in device ops only:
        each link encodes :meth:`chain_draws` of its seed in one pass, and
        the next seed is ``mix64(seed ^ digest * m)``, ``m`` odd, so every
        digest bit changes it."""
        seeds, digests = [], []
        for _ in range(n_chain):
            seeds.append(seed)
            batch = _stacked(
                self.windows_from_draws(*self.chain_draws(seed, n_batches), kernel=kernel),
                n_batches,
            )
            digests.append(chain_digest(batch))
            seed = _mix64(seed ^ (digests[-1] * _DIGEST_MUL))
        return ChainRun(torch.stack(digests).sum() & _MASK32, torch.cat(seeds), batch)

    def _chain_graph(self, n_chain: int, n_batches: int):
        """``run(seed) -> ChainRun``: the chain captured once in one CUDA
        graph.  Each graph holds its own memory pool (the links' windows), so
        the sampler keeps only the last ``(n_chain, n_batches, emit_onehot)``
        graph: a call of another shape frees it and captures anew.  ``run``
        writes the seed into the graph's input, replays it and returns the
        graph's outputs, which the next replay overwrites.  A capture records
        launches without running them, so the window kernel's count is set
        back after it and advanced on every replay instead."""
        shape = (n_chain, n_batches, self.emit_onehot)
        if self._chain_graph_cache is not None:
            if self._chain_graph_cache[0] == shape:
                return self._chain_graph_cache[1]
            self._chain_graph_cache = None  # free the old pool before the capture
        dev = self.device
        seed_in = torch.zeros(1, dtype=torch.int64, device=dev)
        # warm up on a side stream: builds and loads the kernel before the capture
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._chain_links(seed_in, n_chain, n_batches, "kernel")
        torch.cuda.current_stream(dev).wait_stream(side)
        before = encode_windows_kernel.launches
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self._chain_links(seed_in, n_chain, n_batches, "kernel")
        per_replay = encode_windows_kernel.launches - before
        encode_windows_kernel.launches = before

        def run(seed: int) -> ChainRun:
            seed_in.fill_(seed)  # a fill kernel: no host round-trip
            graph.replay()
            encode_windows_kernel.launches += per_replay
            return out

        self._chain_graph_cache = (shape, run)
        return run

    def _chain(self, n_chain: int, n_batches: int, key: int | None,
               kernel: str | None) -> ChainRun:
        """The chain's run.  On the graph path its tensors are the graph's
        outputs, which the next replay of that shape overwrites."""
        if n_chain < 1 or n_batches < 1:
            raise ValueError(f"n_chain and n_batches must be >= 1, got {n_chain}, {n_batches}")
        seed, step = self._first_step(n_chain * n_batches, key)
        first = _as_int64(_step_seed(seed, step))
        kernel = kernel or self.kernel
        if self.device.type == "cuda" and kernel == "kernel":
            return self._chain_graph(n_chain, n_batches)(first)
        seed_t = torch.tensor([first], dtype=torch.int64, device=self.device)
        return self._chain_links(seed_t, n_chain, n_batches, kernel)

    def chain_run(self, n_chain: int, n_batches: int, key: int | None = None,
                  kernel: str | None = None) -> ChainRun:
        """:meth:`sample_chain`'s whole run, in tensors of its own: the
        digest, each link's seed and the last link's batch.  ``kernel``
        overrides the sampler's choice: ``"kernel"`` on the card replays the
        chain's CUDA graph (a failed capture raises); ``"baseline"``, and any
        CPU sampler, run the same links eagerly."""
        run = self._chain(n_chain, n_batches, key, kernel)
        last = run.last
        c1, c2 = last.hap1_codes.clone(), last.hap2_codes.clone()
        h1, h2 = (c1, c2) if last.hap1 is last.hap1_codes else (last.hap1.clone(), last.hap2.clone())
        return ChainRun(run.digest.clone(), run.seeds.clone(), HaplotypeBatch(
            h1, h2, c1, c2, last.n_variants.clone(), last.overflow.clone()))

    def sample_chain(self, n_chain: int, n_batches: int, key: int | None = None) -> torch.Tensor:
        """() int64: the sum, mod 2^32, of the :func:`chain_digest` of
        ``n_chain`` dependent links of ``n_batches`` batches each (one
        encode of ``n_batches * B`` windows a link, as :meth:`sample_many`).
        Link ``k + 1``'s seed mixes in link ``k``'s digest, so no link can be
        skipped or reordered, and fetching the result proves the chain ran.
        The first seed comes from ``(key, 0)``, or from ``(config.seed,
        step counter)``, which then advances by ``n_chain * n_batches``.  On
        the card, one replay of a CUDA graph (:meth:`chain_run`)."""
        return self._chain(n_chain, n_batches, key, None).digest.clone()

    def __iter__(self):
        while True:
            yield self.sample()
