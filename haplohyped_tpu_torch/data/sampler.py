"""On-device haplotype batch sampler.

Draws (region, donor, chromosome) triples, crops each region to a window of
``seq_length`` around its midpoint, clamps the window into the drawn
chromosome, and encodes the variant-aware haplotype windows, all on the
device: each call returns a ready batch with no host round-trip.

The draws are the JAX package's own ``jax.random`` stream, bit for bit: step
``s`` of key ``k`` draws under ``fold_in(k, s)``, split in three, one
``randint`` a field; the sampler's key is ``PRNGKey(config.seed)``.  So for
one seed and state both packages give the same windows.  Every call draws
through one path, :func:`~haplohyped_tpu_torch.ops.draw_kernel.draw_windows`
(one launch of the draw kernel on the card for all of a call's steps, torch
ops on the CPU), which also computes each window's start.
:meth:`DeviceHaplotypeSampler.batch_at` is step ``s``'s batch, which
``sample``, ``sample_many`` and the fused train step all build this way.
:meth:`DeviceHaplotypeSampler.draw_indices` returns one step's draws, and
:meth:`DeviceHaplotypeSampler.windows_from_draws` encodes any draws, so a test
can feed it the JAX package's own.  The region only supplies a span; region,
donor and chromosome are drawn independently.

:meth:`DeviceHaplotypeSampler.sample_chain` runs ``n_chain`` dependent
``sample_many``-sized links, as the JAX package's chain does: link ``k + 1``
draws under ``fold_in(key_k, digest_k)`` of link ``k``'s key and
:func:`chain_digest`, and the call returns the digests' sum, the one fetch
that proves every link ran.  The link update runs inside the next link's
draw launch, so the chain's key never leaves the card, and the whole chain is
one CUDA graph, replayed with no host round-trip.

Default output is ``(B, L)`` int8 base codes, with ``hap1`` and
``hap1_codes`` the same tensor.  ``emit_onehot=True`` adds materialised
``(B, L, C)`` one-hot ``hap1``/``hap2``.
"""

from __future__ import annotations

import functools
import numbers
from typing import NamedTuple, Union

import numpy as np
import torch

from haplohyped_tpu_torch.core.config import SamplerConfig, resolve_device
from haplohyped_tpu_torch.core.profiling import annotate
from haplohyped_tpu_torch.data.cohort import CohortTensors
from haplohyped_tpu_torch.data.genome import GenomeTensors
from haplohyped_tpu_torch.data.regions import load_bed_regions
from haplohyped_tpu_torch.ops.draw_kernel import (
    Draws,
    Key,
    draw_windows,
    draws_plain,
    window_starts,
)
from haplohyped_tpu_torch.ops.haplotype_window import (
    encode_haplotype_windows,
    windows_to_onehot,
)
from haplohyped_tpu_torch.ops.threefry import MASK32, fold_in_words, prng_key
from haplohyped_tpu_torch.ops.window_kernel import (
    WindowIndex,
    build_window_index,
    encode_windows_kernel,
)

#: a key: :data:`~haplohyped_tpu_torch.ops.draw_kernel.Key` or an int seed, or
#: the two words of a JAX key as a sequence or array
KeyLike = Union[int, Key, np.ndarray]


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
              ^ (batch.n_variants.sum(dtype=torch.int64) & MASK32))
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
    keys: torch.Tensor  # (n_chain, 2) int64: each link's key, two uint32 words
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
        with annotate("hh.sampler.init"):
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
            #: ``PRNGKey(config.seed)``'s two words: the key of every key-less draw
            self._base_key = prng_key(config.seed)
            self._step = 0
            self._chain_graph_cache = None  # ((n_chain, n_batches, emit_onehot), replay)
            if self.kernel == "kernel":
                self.index  # build it now, not in the first sample() call

    @functools.cached_property
    def index(self) -> WindowIndex:
        """The kernel's index (built once per sampler; span ``hh.sampler.index``)."""
        with annotate("hh.sampler.index"):
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

    def _key(self, key: KeyLike) -> Key:
        """A caller's key as the draws take it: an int seed becomes
        ``PRNGKey(seed)``'s words; a (2,) tensor on the sampler's device stays
        there (its words as int64, read by the draws with no host trip); the
        two words of any other (2,) sequence, array or tensor come to the
        host."""
        if isinstance(key, numbers.Integral):
            return prng_key(key)
        if isinstance(key, torch.Tensor):
            if key.shape != (2,) or key.dtype.is_floating_point:
                raise ValueError(f"a key is two integer words, got {tuple(key.shape)} {key.dtype}")
            if key.device == self.device:
                return key.to(torch.int64) & MASK32
            if key.device.type != "cpu":
                raise ValueError(f"a key on {key.device} for a sampler on {self.device}")
        words = np.asarray(key)
        if words.shape != (2,) or words.dtype.kind not in "iu":
            raise ValueError(f"a key is an int or two integer words, got {key!r}")
        return tuple(int(w) & MASK32 for w in words)

    def _draws(self, key: Key, step0: int, n_batches: int, kernel: str | None = None,
               digest: torch.Tensor | None = None) -> Draws:
        """Steps ``step0 .. step0 + n_batches - 1`` of ``key``: the draw
        kernel (``"kernel"``) or the plain version (``"baseline"``)."""
        draw = draw_windows if (kernel or self.kernel) == "kernel" else draws_plain
        return draw(key, step0, n_batches, self.config.batch_size, self._regions,
                    self._lengths, self.cohort.num_donors, self.config.seq_length, digest)

    def draw_indices(
        self, step: int, key: KeyLike | None = None
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(region_idx, donor_idx, chrom_idx)``, each ``(B,)`` int32, of
        sampling step ``step`` of ``key`` (``PRNGKey(config.seed)`` unless
        given): the JAX sampler's draws of that step, a function of the key
        and the step only."""
        d = self._draws(self._base_key if key is None else self._key(key), step, 1)
        return d.region_idx, d.donor_idx, d.chrom_idx

    def window_starts(self, region_idx: torch.Tensor, chrom_idx: torch.Tensor) -> torch.Tensor:
        """(B,) int32 window starts: each region's midpoint crop, clamped so
        the window stays inside the drawn chromosome."""
        return window_starts(self._regions, self._lengths, region_idx, chrom_idx,
                             self.config.seq_length)

    def _encode(self, donor_idx, chrom_idx, start, kernel: str | None) -> HaplotypeBatch:
        L = self.config.seq_length
        K = self.config.max_variants_per_window
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
        return self._encode(donor_idx, chrom_idx, self.window_starts(region_idx, chrom_idx),
                            kernel)

    def _first(self, n_steps: int, key: KeyLike | None) -> tuple[Key, int]:
        """``(key, step)`` of a call of ``n_steps`` steps: ``(key, 0)`` with
        a key, else ``(PRNGKey(config.seed), step counter)``, advancing the
        counter."""
        if key is not None:
            return self._key(key), 0
        step = self._step
        self._step += n_steps
        return self._base_key, step

    def _batches(self, key: Key, step0: int, n_batches: int,
                 kernel: str | None = None) -> HaplotypeBatch:
        """Steps ``step0 .. step0 + n_batches - 1`` of ``key`` as one batch
        of ``n_batches * B`` windows: one draw pass (which crops each window
        too) and one encode pass, under the span ``hh.sampler.batch``."""
        with annotate("hh.sampler.batch"):
            d = self._draws(key, step0, n_batches, kernel)
            return self._encode(d.donor_idx, d.chrom_idx, d.start, kernel)

    def batch_at(self, step: int, key: KeyLike | None = None,
                 kernel: str | None = None) -> HaplotypeBatch:
        """Sampling step ``step``'s batch of ``key`` (``PRNGKey(config.seed)``
        unless given), leaving the step counter alone: what :meth:`sample`
        gives at that step.  ``kernel`` overrides the sampler's
        ``"kernel"``/``"baseline"`` choice."""
        return self._batches(self._base_key if key is None else self._key(key), step, 1,
                             kernel)

    def sample(self, key: KeyLike | None = None) -> HaplotypeBatch:
        """Draw one batch.  Without ``key``, step ``_step`` of
        ``PRNGKey(config.seed)``, advancing the step counter; with it, step 0
        of ``key``, leaving the counter alone (JAX's ``sample(key=)``).
        ``key`` is an int seed or a JAX key's two words."""
        return self._batches(*self._first(1, key), 1)

    def sample_many(self, n_batches: int, key: KeyLike | None = None) -> HaplotypeBatch:
        """``n_batches`` batches, leaves stacked ``(n_batches, B, ...)``:
        equal to ``n_batches`` successive :meth:`sample` calls (steps ``0 ..
        n_batches - 1`` of ``key`` with a key), drawn in one pass and encoded
        in one pass (one launch each on the card) over all their windows."""
        if n_batches < 1:
            raise ValueError(f"n_batches must be >= 1, got {n_batches}")
        return _stacked(self._batches(*self._first(n_batches, key), n_batches), n_batches)

    def _chain_links(self, key: Key, n_chain: int, n_batches: int, kernel: str) -> ChainRun:
        """The chain from its first key, in device ops only: link ``k``
        encodes steps ``0 .. n_batches - 1`` of its key in one pass, and link
        ``k + 1``'s key is ``fold_in(key_k, digest_k)``, made inside its draws."""
        keys, digests = [], []
        for _ in range(n_chain):
            d = self._draws(key, 0, n_batches, kernel, digests[-1] if digests else None)
            keys.append(d.key)
            batch = _stacked(self._encode(d.donor_idx, d.chrom_idx, d.start, kernel), n_batches)
            digests.append(chain_digest(batch))
            key = d.key
        return ChainRun(torch.stack(digests).sum() & MASK32, torch.stack(keys), batch)

    def _chain_graph(self, n_chain: int, n_batches: int):
        """``run(key) -> ChainRun``: the chain captured once in one CUDA
        graph.  Each graph holds its own memory pool (the links' windows), so
        the sampler keeps only the last ``(n_chain, n_batches, emit_onehot)``
        graph: a call of another shape frees it and captures anew.  ``run``
        writes the key into the graph's input, replays it and returns the
        graph's outputs, which the next replay overwrites.  A capture records
        launches without running them, so the kernels' counts are set back
        after it and advanced on every replay instead.  The warm-up and the
        capture are the span ``hh.sampler.chain_capture``, which opens and
        closes outside the captured region."""
        shape = (n_chain, n_batches, self.emit_onehot)
        if self._chain_graph_cache is not None:
            if self._chain_graph_cache[0] == shape:
                return self._chain_graph_cache[1]
            self._chain_graph_cache = None  # free the old pool before the capture
        dev = self.device
        counted = (encode_windows_kernel, draw_windows)
        with annotate("hh.sampler.chain_capture"):
            key_in = torch.zeros(2, dtype=torch.int64, device=dev)
            # warm up on a side stream: builds and loads the kernels before the capture
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._chain_links(key_in, n_chain, n_batches, "kernel")
            torch.cuda.current_stream(dev).wait_stream(side)
            before = [k.launches for k in counted]
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = self._chain_links(key_in, n_chain, n_batches, "kernel")
        per_replay = [k.launches - b for k, b in zip(counted, before)]
        for k, b in zip(counted, before):
            k.launches = b

        def run(key: Key) -> ChainRun:
            if isinstance(key, torch.Tensor):
                key_in.copy_(key)
            else:  # two fill kernels: no host round-trip
                key_in[0].fill_(key[0])
                key_in[1].fill_(key[1])
            graph.replay()
            for k, n in zip(counted, per_replay):
                k.launches += n
            return out

        self._chain_graph_cache = (shape, run)
        return run

    def _chain(self, n_chain: int, n_batches: int, key: KeyLike | None,
               kernel: str | None) -> ChainRun:
        """The chain's run, under the span ``hh.sampler.chain`` (the key, and
        the replay or the eager links).  On the graph path its tensors are
        the graph's outputs, which the next replay of that shape overwrites."""
        if n_chain < 1 or n_batches < 1:
            raise ValueError(f"n_chain and n_batches must be >= 1, got {n_chain}, {n_batches}")
        with annotate("hh.sampler.chain"):
            if key is None:
                # JAX's key-less chain starts from fold_in(base key, step counter),
                # hashed in Python ints: nothing reaches the card
                first = fold_in_words(self._base_key, self._step)
                self._step += n_chain * n_batches
            else:
                first = self._key(key)
            kernel = kernel or self.kernel
            if self.device.type == "cuda" and kernel == "kernel":
                return self._chain_graph(n_chain, n_batches)(first)
            return self._chain_links(first, n_chain, n_batches, kernel)

    def chain_run(self, n_chain: int, n_batches: int, key: KeyLike | None = None,
                  kernel: str | None = None) -> ChainRun:
        """:meth:`sample_chain`'s whole run, in tensors of its own: the
        digest, each link's key and the last link's batch.  ``kernel``
        overrides the sampler's choice: ``"kernel"`` on the card replays the
        chain's CUDA graph (a failed capture raises); ``"baseline"``, and any
        CPU sampler, run the same links eagerly (``"baseline"`` through the
        plain versions of the draws and the encode)."""
        run = self._chain(n_chain, n_batches, key, kernel)
        last = run.last
        c1, c2 = last.hap1_codes.clone(), last.hap2_codes.clone()
        h1, h2 = (c1, c2) if last.hap1 is last.hap1_codes else (last.hap1.clone(), last.hap2.clone())
        return ChainRun(run.digest.clone(), run.keys.clone(), HaplotypeBatch(
            h1, h2, c1, c2, last.n_variants.clone(), last.overflow.clone()))

    def sample_chain(self, n_chain: int, n_batches: int, key: KeyLike | None = None) -> torch.Tensor:
        """() int64: the sum, mod 2^32, of the :func:`chain_digest` of
        ``n_chain`` dependent links of ``n_batches`` batches each (one draw
        and one encode of ``n_batches * B`` windows a link, as
        :meth:`sample_many`), equal to the JAX package's ``sample_chain``.
        Link 0 is ``sample_many(n_batches, key=key)``; link ``k + 1`` draws
        under ``fold_in(key_k, digest_k)``, so no link can be skipped or
        reordered, and fetching the result proves the chain ran.  Without a
        key the first is ``fold_in(PRNGKey(config.seed), step counter)``,
        and the counter advances by ``n_chain * n_batches``.  On the card,
        one replay of a CUDA graph (:meth:`chain_run`)."""
        return self._chain(n_chain, n_batches, key, None).digest.clone()

    def __iter__(self):
        while True:
            yield self.sample()
