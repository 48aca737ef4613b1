#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--seed N] [--phase NAME]

This is the card's correctness check: every kernel bit-equal to its plain
version at full size, and the paths around them.  Speed is measured by the
benchmark, ``portbench/run.py``.  Phases, numbered as the tests and documents
cite them (there is no phase 6; any failure exits non-zero; nothing is caught):

1. Build every CUDA kernel of ``haplohyped_tpu_torch/csrc`` (one ``nvcc``
   each) and the native VCF framer from ``cpp/`` (one ``g++``), all started
   together, and print the card's name and power limit.
2. Make a deployment-sized state on the device from ``--seed``: the GRCh38
   autosomes chr1-chr12 at their true lengths (random codes), 128 donors with
   SNVs at ~1.2 per kb per chromosome, and 100,000 BED regions of 200-2,000 bp.
3. The main path: ``DeviceHaplotypeSampler`` with ``SamplerConfig(seq_length=
   1000, batch_size=64)``, a few ``sample()`` calls and ``sample_many(16)``,
   with the kernels' launch counts set to 0 just before and read just after
   (one draw launch a call), and CUDA's sync debug mode raising on any host
   round-trip while sampling.  Every batch is then held bit-equal against the
   plain PyTorch versions of the draws (``ops/threefry.py``) and the encode.
   The draw kernel is held bit-equal to its plain version at the main path's
   64, 1,024 and 16,384 lanes for several keys and steps, with a key held on
   the card and with a chain link's digest; at odd batch sizes B in {1, 3,
   65, 100, 257}, whose lanes cross and do not fill the kernel's 64-lane
   blocks; and at sizes R in {1, 65,536, 65,537} (both sides of where
   randint's multiplier wraps to 0) over synthetic regions, with a key on
   the card and a digest; and the sampler's draws of one step, and one
   ``fold_in`` of a digest, to ``JAX_DRAWS``, which the JAX package computed
   (the card's machine has no JAX).
4. Edge fixtures, kernel against plain, bit-equal: empty rows, a row that
   overflows K, duplicate positions, windows crossing coarse-grid buckets, a
   window clamped at the genome's end, starts and ends on the bucket
   table's boundaries, a slice longer than the block with duplicate runs cut
   by K, starts past a row's last position, past the table and at the int32
   extremes, and every B in {1, 61, 64, 4096} x L in {256, 333, 1000, 2049,
   4080} x K in {8, 64, 128} on the deployment state; then the main path's
   two launch shapes, B=64 (``sample()``) and B=1,024 (``sample_many(16)``)
   at L=1000, K=128, on four batches each of the sampler's draws of later
   steps, with ``window_bounds``' count equal to the kernel's ``n_variants``.
5. ``DeviceHaplotypeSampler.from_files`` on small gzip HDF5 files in the
   reference layout, one batch against the plain version (where h5py is
   installed).
7. Converter input from ``--seed``, under the git-ignored build directory: a
   BGZF chr1 cohort VCF of 6,468,094 records (1000 Genomes Phase 3 chr1)
   over GRCh38 chr1's length, 8 samples, with SNVs, indels, multi-allelic
   and non-ACGT ALTs, missing and unphased genotypes; and a small VCF with
   300 contigs.
8. The converter's main path: ``VCFtoHDF5Converter(single_pass=False,
   device="cuda").parse_snps`` for every donor of the chr1 file (12-byte
   frames, decode12 kernel) and, without a region, for one donor of the
   300-contig file (64-byte frames, decode64 kernel), with both kernels'
   launch counts set to 0 just before and read just after.  Each SNP struct
   must be byte-equal to the same task with ``device_decode=False`` (numpy
   decode of 64-byte frames); each kernel output, on the same frames, to
   the plain version.  Where h5py is installed, ``run()`` both ways and the
   files compared.
9. Edge fixtures, decode kernels against plain, bit-equal: N in {1, 1023,
   1025, 4097} and the full chr1 frame, the hand-made records of
   ``DECODE_EDGE_VCF``, and 1 M frames of random bytes, each layout, with
   and without a sample.
10. Times on the card: each decode kernel and its plain version per chr1
   frame (back to back behind a sleep kernel, CUDA events; the profiler's
   reading beside), their bounds, the per-donor task split into framing,
   h2d, kernel, d2h, unpack and struct assembly, and records/s.
11. The window-kernel lab's kernel against its plain versions, bit-equal:
   ``full``, ``dma_only`` (grid stride 512 and 1024) and ``compute_only``,
   each at 1, 2, 4, 8, 16 and 32 windows a block, on the edge fixtures and
   on the deployment state at B in {1, 61, 64, 2048} x K in {128, 64}
   (L=1000) and L in {256, 4080} (B=64); every w bit-equal to w=1.  Phase 1
   prints each lab instance's registers, shared memory and spills.
12. The lab's path: ``window_kernel_lab.main`` on the JAX lab's fixture at
   its shape (B=2048, L=1000, K=64, 16 chained links in one CUDA graph),
   then the same rows on the deployment state's chr1 at B=2048 and B=64,
   with the lab kernel's launch count set to 0 just before and read just
   after; each row's device ms a launch (CUDA events) and bound, the
   plain version's time at the lab shape, and ``full_w1 / prod`` for each
   state, which must not exceed 1.25 (the lab's ``full`` at one window a
   block is the production kernel's code).
13. The training path, at the full width of ``HaploFormerConfig()`` (d_model
   256, 8 heads, 4 layers, bf16 compute on float32 params) on the phase-3
   sampler (B=64, L=1000, K=128): 20 fused sample-into-train steps (CUDA's
   sync debug mode raising on any host round-trip after the first three)
   and ``train_on_sampler`` for 5 steps, with the window kernel's launch
   count set to 0 just before and read just after (one launch a batch
   drawn, and one draw launch a batch); every loss finite; the first fused
   batch bit-equal to the plain
   version.  The model on the card against the CPU from one seed's params:
   d_model 64 x 2 layers in float32 with TF32 off (largest relative error
   within ``F32_TOL``) and the default configuration in bf16 against
   float32 (``BF16_TOL``).  A checkpoint round trip.
14. The single-pass converter (``VCFtoHDF5Converter`` on its default flags,
   ``device="cuda"``), which runs torch ops on the card and no Hopper kernel
   (the launch counts, set to 0 before it, stay 0): ``convert_chromosome(1,
   writer=...)`` on phase 7's chr1 file, every donor's struct byte-equal to
   phase 8's per-donor struct and to a ``device_decode=False`` single pass;
   ``decode_frames_v2`` on the card bit-equal to ``decode_frames_v2_numpy``
   on the chr1 frame and on a frame of 200 contigs where most records escape;
   the 300-contig file refused by ``frame_v2`` (``ValueError``).  Then at
   cohort width, a chr22 file of 1,103,547 records (1000 Genomes Phase 3's
   chr22 count) over GRCh38 chr22's length and 128 donors:
   ``convert_chromosome(22)``, and 8 of its donors through the per-donor
   ``parse_snps``, byte-equal.  Times on both files: the task (host clock),
   records/s and donor-records/s, the per-donor task on the same donors, the
   decode's peak device memory, the task split into framing, h2d, device
   decode, d2h and struct assembly (each ended by a synchronize), and the
   decode's device ms (CUDA events) beside its byte bound.
15. The reference path.  A FASTA written from ``--seed`` under the build
   directory: chr1 and chr22 at GRCh38's lengths, 60 bases a line, soft-masked
   runs over about half the bases, ~7% N, a sprinkle of IUPAC codes (305 MB).
   ``build_fai`` on it (records equal to the writer's); chr1 fetched through
   ``FaidxFasta`` and ``NativeFasta``, byte-equal; ``encode_onehot_and_codes(
   device="cuda")`` on chr1's 248,956,422 bases bit-equal to ``encode_host``,
   timed end to end and split into h2d, device ops (CUDA events, beside a
   byte bound of 7 bytes a base) and d2h, with its peak device memory;
   ``GenomeTensors.from_fasta`` equal to the card's codes; a
   ``DeviceHaplotypeSampler`` on that genome (16 donors, SNVs at ~1.2 per kb,
   100,000 regions) drawing 4 batches at B=64, L=1000, with the window and
   draw kernels' launch counts set to 0 just before and read just after, each batch
   bit-equal to the plain version; ``pack_2bit_device`` on chr1's codes equal
   to numpy ``pack_2bit`` and round-tripped, ``gather_window_2bit`` at 518
   windows equal to the codes' slices; ``doctor.run_checks()`` printed, every
   check passing but the two that need h5py and libblosc (neither is on the
   card's machine).

16. The tokenizer route and the host I/O surface, on phase 7's chr1 file, phase
   14's chr22 file (W 128 and 1024) and the 300-contig file; no Hopper kernel
   lies on it.  ``tokenize_vcf_device`` on the card for chr1's 8 donors, each
   struct byte-equal to phase 8's frame12 struct, and for 4 chr22 donors
   against phase 14's; 200,000 lines of each file tokenized on the CPU,
   every column bit-equal to the card's; ``tokenize_vcf_streaming`` in at
   least 8 chunks on both files, and on chr22's 20-30 Mb through a ``.tbi``
   that ``build_index`` writes, every column bit-equal to the whole file's
   rows; ``parse_snps(use_tokenizer=True)`` on the 300-contig file for two
   donors byte-equal to the 64-byte route, with no kernel launched (the
   counts set to 0 just before, read just after); chr22's first 100,000
   records for 4 donors through ``VcfWriter`` (``z``) and ``BcfWriter``
   (``b``), read back through ``parse_snps`` and ``bcf_decoded_columns``
   byte-equal to the source; ``VariantTable.from_vcf`` on chr22, its SNP
   mask and start equal to the tokenizer's.  Times: the tokenizer's task on
   chr1 for one donor beside frame12's (in turns), records/s, its split into
   ``vcf_text``, h2d, device ops (CUDA events, beside a byte bound of
   N x (2W + 39) bytes), d2h and struct assembly on both files, the
   streaming reads' wall time beside their host and device time, the peak
   device memory at each W, and ``VariantTable.from_vcf`` seconds.

17. The parallel path at world size 1, in a process of its own (``--parallel
   DIR`` runs it alone on the files of phases 7 and 14 under DIR): NCCL with
   one rank through ``make_mesh(MeshConfig(1, 1))`` on the deployment state of
   ``--seed``.  ``make_train_step(mesh)`` at ``HaploFormerConfig()``, B=64,
   L=1000 on sampler batches, its losses, parameters and AdamW slots
   bit-equal to ``make_train_step()``'s from the same seed after each of 5
   steps, both timed in turns (CUDA events) and traced (``torch.profiler``),
   and bit-equal again after;
   ``train_on_sampler(mesh=...)`` for 3 steps with the window and draw
   kernels' launches counted (one each a batch); ``sharded_decode_frames`` on one donor's
   chr1 64-byte frames (one decode64 launch, counted) bit-equal to the
   unsharded kernel call and to the plain version;
   ``ShardedGenome.from_codes`` of the deployment genome from the host (halo
   1000) and ``sharded_window_gather`` of a (64, 1000) batch, each window
   equal to the codes' slice and one start past the last shard giving zeros;
   ``all_gather_cohort`` and ``psum_counts`` on the cohort's counts;
   ``convert_sharded(device_decode=True)`` on phase 14's chr22 x 128 file,
   one file pass, every column byte-equal to ``CohortTensors.from_structs``
   of the single pass's structs.

18. ``DeviceHaplotypeSampler.sample_chain`` on the phase-3 sampler, one CUDA
   graph of links of a draw launch and a window-kernel launch:
   ``chain_run(3, 4, key=k)`` on the graph equal to the same chain run
   eagerly through the plain versions (the digest, each link's key, the last
   link's windows bit-equal), link 0's key ``PRNGKey(k)``; five calls with
   both kernels' launch counts set to 0 just before and read just after (3
   launches each a call, counted a replay) under CUDA's sync debug mode
   raising on any host round-trip; two key-less calls give two digests and
   advance the step, two calls of one key one digest; a link's draws from
   the card's last key and digest equal to the CPU's; ``emit_onehot`` at (2,
   2) on a sampler of its own, graph against eager.  At the JAX bench's
   chain (16, 256): the graph's ``chain_run(16, 256, key=k)`` equal to the
   eager plain chain (digest, keys, the last link's 16,384 windows), and two
   window-kernel launches at a link's B = 16,384 bit-equal to the plain
   version.
19. The window kernel at long windows and past 128 variants, bit-equal to
   the plain version, its launch count set to 0 just before each call and
   read just after (one launch a call): Enformer's window pairs, B=2 at
   L=196,608, at K in {512, 300, 129} (a thread holds up to four applied
   variants, a window is cut into parts of 8,192 bytes) and at K in {128,
   64}; B in {1, 61} x L in {8,192, 8,193, 40,000} x K in {512, 128}; and
   ``sample()`` on a sampler at Enformer's ``SamplerConfig(seq_length=
   196608, batch_size=2, max_variants_per_window=512)``, draws and encode
   against their plain versions, with no window past K; then two more
   batches at B=2, L=196,608, K=512.
20. Enformer's conv-block kernels (``ops/batchnorm_gelu.py``), batch norm
   and GELU.  First the main path: one bf16 training-mode forward and
   backward of ``Enformer(EnformerConfig())`` on 2 window pairs, the
   counters reset to 0 just before it: one forward and one backward call
   each of the 14 conv blocks, 84 launches (the kernels line's count), no
   ``batch_norm`` op dispatched and one ``sigmoid`` (the head's GELU).  Then
   the wrapper in training mode against the plain version at the 14 block
   input shapes of ``EnformerConfig()`` at N=4 sequences in bf16 and at 3 of
   them in float32, on inputs, parameters and moving statistics from
   ``--seed``: a bf16 output equal to the plain version's or one bf16 step
   apart (a step at least ``2^-12`` of ``|a x| + |b| + |scale|``, float32's
   floor near ``u = a x + b = 0``), at most 1% of elements
   apart, a float32 one within 1e-5 of the
   float64 plain version's norm; ``dx`` (against the float64 plain
   version's rounded to the input's dtype), the scale's and bias's
   gradients and both moving averages within 1e-3 of the float64 plain
   version's norm; two runs on the same inputs bit-equal; and an eval-mode
   forward and backward at the smallest shape.  At ``(4, 768, 196,608)`` in
   bf16, the forward's and the backward's device ms (CUDA events) beside
   their byte bounds (3 and 5 passes of 2 bytes an element), the plain
   version's, and ``F.batch_norm`` with the three GELU ops in bf16 as the
   library yardstick.

21. The chunked state-space scan's kernels (``ops/ssd_scan.py``).  First
   the main path, one step that phase 22 reads too
   (``tools/granite_step_check.py``): one bf16 forward and backward of
   ``GraniteHybrid(GraniteHybridConfig())`` on one window pair of 8,192 bp
   (the benchmark cell's step), the scan's and the norms' counters reset to
   0 just before it: one forward and one backward scan call each of the 9
   Mamba-2 mixers, 72 launches (the kernels line's count), a finite loss,
   and no tensor as large as the step's logits.  Then, forward and backward, against the plain version in
   float32 on the same bf16 inputs (``tools/ssd_scan_check.py``): at the
   cell's ``(2, 8192)`` with 64 heads of 64 and a state of 128, and at ``(3,
   768)`` with 5 heads of 24 and a state of 40; the output and every
   gradient within 2% of the plain version's norm, two runs bit-equal where
   no atomics sum; 3 launches a forward and 5 a backward.  At the cell's
   shape, the forward's and the backward's device ms (CUDA events, 10 calls;
   the plain version 1), the kernels with their ``torch.bmm`` products; the
   bound is the benchmark's (``ssd_fwd_roofline.granite``).
22. The Granite hybrid's norms (``ops/rms_norm.py``), plain and gated.
   First phase 21's main-path step (run here where the phase runs alone):
   one forward and one backward call each of the 30 norms (the 9 mixers'
   gated), 90 launches (the kernels line's count), and no ``pow`` or
   ``rsqrt`` op dispatched.  Then the
   wrapper against the float64 plain version (``tools/rms_norm_check.py``)
   at the cell's two norms, ``(16384, 2048)`` plain and ``(16384, 4096)``
   with the gate a strided view of a ``(16384, 8512)`` tensor (``in_proj``'s
   output), each in bf16 and float32: a bf16 output equal to the rounded
   plain version or one bf16 step apart, at most 1% of elements apart, a
   float32 one within 1e-5 of its norm; each gradient within its tolerance
   of the plain version's norm; two runs bit-equal.  At both shapes in bf16,
   the forward's and the backward's device ms (CUDA events, 10 calls) beside
   their byte bounds (each input read and each output written once), the
   plain version's, and ``F.rms_norm`` in bf16 as the library yardstick.

23. The Nemotron-H hybrid (``tools/nemotron_step_check.py``).  First the
   main path: one bf16 forward and backward of ``NemotronH(
   NemotronHConfig())`` on the benchmark cell's 2 window pairs of 8,192 bp,
   the scan's, the norms' and the MoE layers' counters reset to 0 just
   before it: 6 and 6 scan calls (48 launches), 20 and 20 norm calls (the 6
   mixers' gated, 60 launches), 5 MoE calls routing every token's 6 slots,
   some of them held here, a finite loss, and the step's memory peak.  Then
   the scan's kernels in 8 groups of ``B`` and ``C`` at chunks of 128 against
   the plain version at the cell's ``(4, 8192)`` (64 heads of 64, a state of
   128) and at a small odd shape, as phase 21 compares; the norms' kernels
   at the cell's plain rows of 2,688 and its mixers' gated rows of 4,096 in
   groups of 512, the gate a view of a 10,304-wide tensor, in bf16 and
   float32, as phase 22 compares; one MoE layer (16 of 128 experts held,
   32,768 tokens) against its float32 plain form, one held expert at a
   time: the output, the input's and every leaf's gradient within 2% of
   its norm.  And the held experts' grouped products (``torch._grouped_mm``)
   and ReLU² of one forward: device ms (CUDA events, 10 calls) beside their
   bound, the larger of their FLOPs over 989 TFLOP/s and their least bytes
   over 3.35 TB/s.

``--phase NAME`` runs one phase alone, with the set-up it needs, and prints
its JSON line: ``single_pass`` (phases 7, 8 and 14), ``tokenizer`` (7, 8, 14
and 16), ``reference`` (15), ``parallel`` (the converter files of phases 7
and 14, then 17), ``long_windows`` (2 and 19), ``batchnorm_gelu`` (20),
``ssd_scan`` (21), ``rms_norm`` (22) or ``nemotron`` (23).  ``--parallel DIR`` is
phase 17's child process.

The lines before the last are a JSON object ``{"train": {...}}`` of phase
13's checks, one ``{"single_pass": {...}}`` of phase 14's, one
``{"reference": {...}}`` of phase 15's, one ``{"tokenizer": {...}}`` of
phase 16's, one ``{"parallel": {...}}`` of phase 17's, one ``{"chain":
{...}}`` of phase 18's, one ``{"long_windows": {...}}`` of phase 19's, one
``{"batchnorm_gelu": {...}}`` of phase 20's, one ``{"ssd_scan": {...}}`` of
phase 21's, one ``{"rms_norm": {...}}`` of phase 22's, one ``{"nemotron":
{...}}`` of phase 23's, one with one entry per kernel (its launches, and its times where phases 10 and
12 take them), then the comparisons made; the last line is ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import math
import os
import re
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from haplohyped_tpu_torch import DeviceHaplotypeSampler, GenomeTensors, MeshConfig, SamplerConfig
from haplohyped_tpu_torch.core.constants import (
    INT32_MAX,
    N_CODE,
    SNP_STRUCT_DTYPE,
    cohort_group_path,
)
from haplohyped_tpu_torch.core.timing import HBM_BYTES_PER_S, card_line, device_ms
from haplohyped_tpu_torch.data.cohort import CohortTensors
from haplohyped_tpu_torch.data.sampler import HaplotypeBatch, chain_digest
from haplohyped_tpu_torch.hostio import native
from haplohyped_tpu_torch.hostio import vcf as hostio_vcf
from haplohyped_tpu_torch.hostio.bcf import bcf_decoded_columns, is_bcf
from haplohyped_tpu_torch.hostio.fai import FaidxFasta, build_fai
from haplohyped_tpu_torch.hostio.fasta import FastaReader
from haplohyped_tpu_torch.hostio.frame_format import REC12_SIZE, REC_SIZE
from haplohyped_tpu_torch.hostio.native import NativeFasta
from haplohyped_tpu_torch.hostio.tabix import build_index
from haplohyped_tpu_torch.hostio.variants import VariantTable
from haplohyped_tpu_torch.hostio.vcf import VCFSource
from haplohyped_tpu_torch.hostio.writer import BcfWriter, VcfHeader, VcfWriter
from haplohyped_tpu_torch.models.enformer import ConvBlock, Enformer, EnformerConfig
from haplohyped_tpu_torch.models.haploformer import HaploFormer, HaploFormerConfig
from haplohyped_tpu_torch.models.train import (
    create_train_state,
    loss_fn,
    make_fused_train_step,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
    train_on_sampler,
)
from haplohyped_tpu_torch.ops import _build
from haplohyped_tpu_torch.ops.batchnorm_gelu import batchnorm_gelu, batchnorm_gelu_plain, gelu
from haplohyped_tpu_torch.ops.rms_norm import rms_norm, rms_norm_plain
from haplohyped_tpu_torch.ops.ssd_scan import ssd_scan, ssd_scan_plain
from haplohyped_tpu_torch.ops.decode_kernel import (
    decode_frames12_kernel,
    decode_frames_kernel,
)
from haplohyped_tpu_torch.ops.draw_kernel import draw_windows, draws_plain
from haplohyped_tpu_torch.ops.haplotype_window import (
    HaplotypeWindows,
    encode_haplotype_windows,
)
from haplohyped_tpu_torch.ops.onehot import ascii_to_codes, codes_to_onehot
from haplohyped_tpu_torch.ops.pack import (
    gather_window_2bit,
    pack_2bit_device,
    unpack_2bit_device,
)
from haplohyped_tpu_torch.ops.threefry import MASK32, prng_key
from haplohyped_tpu_torch.ops.vcf_decode import (
    decode_frames,
    decode_frames12_packed,
    decode_frames_packed,
    decode_frames_v2,
    decode_frames_v2_numpy,
    decode_v2_genotypes,
    decode_v2_records,
    decoded_to_numpy,
    unpack12_columns,
    unpack64_decoded,
)
from haplohyped_tpu_torch.ops.vcf_stream import tokenize_vcf_streaming
from haplohyped_tpu_torch.ops.vcf_tokenize import (
    choose_window,
    decoded_to_host,
    default_chunk_lines,
    line_fields,
    line_windows,
    sample_column,
    tab_columns,
    tab_counts,
    tabs_needed,
    tokenize_lines,
    tokenize_vcf_device,
    upload_text,
)
from haplohyped_tpu_torch.ops.window_kernel import (
    BK,
    build_window_index,
    encode_windows_kernel,
    window_bounds,
)
from haplohyped_tpu_torch.ops.window_lab import (
    SP,
    VARIANTS,
    WINDOWS_PER_BLOCK,
    encode_windows_lab,
    lab_plain,
    lab_smem_bytes,
)
from haplohyped_tpu_torch.parallel import all_gather_cohort, make_mesh, sharded_decode_frames
from haplohyped_tpu_torch.parallel.collectives import psum_counts
from haplohyped_tpu_torch.parallel.genome_shard import ShardedGenome, sharded_window_gather
from haplohyped_tpu_torch.parallel.sharded_convert import (
    _structs_to_task_tensors,
    convert_sharded,
)
from haplohyped_tpu_torch.pipeline.doctor import run_checks
from haplohyped_tpu_torch.pipeline.fasta_encoder import encode_host, encode_onehot_and_codes
from haplohyped_tpu_torch.pipeline.records import (
    snp_struct_from_decoded,
    snp_struct_from_frames12,
    snp_structs_from_v2,
)
from haplohyped_tpu_torch.pipeline.vcf_to_h5 import (
    V2_GENOTYPE_COLUMNS,
    V2_RECORD_COLUMNS,
    VCFtoHDF5Converter,
    upload_v2,
)
from haplohyped_tpu_torch.tools import window_kernel_lab as lab
from haplohyped_tpu_torch.tools.batchnorm_gelu_check import BN_EPS, BN_MOMENTUM, bn_compare
from haplohyped_tpu_torch.tools.granite_step_check import (
    GRANITE_L,
    check_granite_step,
    granite_step,
)
from haplohyped_tpu_torch.tools.nemotron_step_check import (
    check_nemotron_step,
    experts_times,
    moe_compare,
    nemotron_step,
)
from haplohyped_tpu_torch.tools.rms_norm_check import (
    EPS as RMS_EPS,
    HIDDEN,
    IN_PROJ,
    MIXER,
    NEMOTRON_GROUP,
    NEMOTRON_HIDDEN,
    NEMOTRON_IN_PROJ,
    NEMOTRON_ROWS,
    ROWS,
    rms_compare,
    rms_inputs,
)
from haplohyped_tpu_torch.tools.ssd_scan_check import (
    CELL_SHAPE,
    NEMOTRON_CHUNK,
    NEMOTRON_SHAPE,
    ssd_compare,
    ssd_inputs,
)
from haplohyped_tpu_torch.tools.deployment import N_REGIONS, make_cohort, make_regions, make_state
from haplohyped_tpu_torch.utils.bitpack import pack_2bit

SEQ_LENGTH, BATCH, K_MAX = 1000, 64, 128

#: one sampling step's draws as the JAX package makes them, at the deployment
#: state's sizes (R, D, C): step ``step`` of ``PRNGKey(seed)``, B lanes, and
#: the chain link key ``fold_in(PRNGKey(seed), digest)``.  Computed with
#: jax.random on a CPU; tests/test_torch_draw_kernel.py holds them against JAX
JAX_DRAWS = dict(
    seed=2024, step=123_456, sizes=(100_000, 128, 12), B=16,
    region=[79046, 72660, 44791, 64234, 92262, 71448, 20971, 91173,
            52743, 35512, 81313, 49360, 79810, 26754, 32073, 67374],
    donor=[28, 49, 115, 90, 17, 81, 106, 69, 71, 80, 5, 95, 20, 107, 63, 63],
    chrom=[1, 7, 3, 9, 9, 2, 11, 9, 5, 5, 11, 10, 8, 6, 2, 4],
    digest=0x9E3779B9, link_key=[4206435521, 3066003257],
)

#: hand-made records for the decode kernels' edge cases: POS 1 and 0 (start
#: wraps to 0xFFFFFFFF), genotypes missing in either allele or both, haploid
#: and triploid genotypes, an 11-digit
#: POS, 10-digit POS past uint32, lowercase, '*', symbolic and multi-allelic
#: ALTs, indels, non-digit alleles (the 0xB GT nibble), a non-digit POS, GT
#: as a later FORMAT subfield, no GT, and lines of 8 and 6 fields
DECODE_EDGE_VCF = "\n".join("\t".join(r.split()) for r in """\
##fileformat=VCFv4.2
##contig=<ID=chr1,length=248956422>
##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">
##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Depth">
#CHROM POS ID REF ALT QUAL FILTER INFO FORMAT s1 s2
chr1 1 . A G . PASS . GT 0|1 1|1
chr1 0 . A G . PASS . GT 1|0 0|1
chr1 200 . C T . PASS . GT ./. .|1
chr1 250 . C T . PASS . GT 1|. 0/.
chr1 300 . G A . PASS . GT 1 0
chr1 12345678901 . A C . PASS . GT 0|1 1|0
chr1 4294967296 . A C . PASS . GT 1|1 0|0
chr1 9999999999 . T G . PASS . GT 0/1 1/0
chr1 500 . a g . PASS . GT 0|1 1|1
chr1 600 . A * . PASS . GT 0|1 1|1
chr1 700 . A <DEL> . PASS . GT 1|1 0|1
chr1 800 . C T . PASS . GT A|1 1/x
chr1 900 . G C . PASS . GT 0|1|1 2/3
chr1 1000 . T A,C . PASS . GT 1|2 0/0
chr1 1100 . GT G . PASS . GT 0|1 1|0
chr1 1200 . A AT . PASS . GT 0|1 0/1
chr1 12a4 . A C . PASS . GT 0|1 0|1
chr1 1300 . A C . PASS . GT:DP 0|1:3 1|1:4
chr1 1400 . A C . PASS . DP:GT 3:0|1 4:.|.
chr1 1500 . A C . PASS . DP 3 4
chr1 1600 . A C . PASS .
chr1 1700 . A C . PASS
chr1 1800 . N A . PASS . GT 0|1 1|0
chr1 1900 . A c . PASS . GT 0|1 1|0
""".splitlines()) + "\n"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# kernel-against-plain comparison
# ---------------------------------------------------------------------------

class Comparisons:
    """Runs the kernel and the plain version on the same inputs, requires
    every output bit-equal, and keeps the largest absolute difference."""

    def __init__(self):
        self.max_abs_err = 0
        self.count = 0

    def windows(self, got, want, what: str) -> None:
        """Every field of ``got`` (windows, or the lab's with its sink)."""
        torch.cuda.synchronize()  # a fault in the kernel surfaces here
        for name in got._fields:
            g, w = getattr(got, name), getattr(want, name)
            check(g.shape == w.shape and g.dtype == w.dtype, f"{what}: {name} shape/dtype")
            err = int((g.long() - w.long()).abs().max()) if g.numel() else 0
            self.max_abs_err = max(self.max_abs_err, err)
            check(err == 0, f"{what}: {name} differs from the plain version (max |d| {err})")
        self.count += 1

    def encode(self, index, donor, chrom, start, L, K, what):
        got = encode_windows_kernel(index, donor, chrom, start, L=L, K=K)
        want = encode_haplotype_windows(*index.plain_args, donor, chrom, start, L=L, K=K)
        self.windows(got, want, what)
        return got


# ---------------------------------------------------------------------------
# phase 4: edge fixtures (numpy, so the tests can hold them against JAX)
# ---------------------------------------------------------------------------

def _empty_cohort(D, C, V):
    pos = np.full((D, C, V), INT32_MAX, np.int32)
    ref, alt, p1, p2 = (np.zeros((D, C, V), np.int8) for _ in range(4))
    return pos, ref, alt, p1, p2, np.zeros((D, C), np.int32)


def edge_fixtures():
    """``{name: (state, draws, L, K)}``; ``state`` is the plain version's
    eight operands and ``draws`` its (donor, chrom, start), all numpy."""
    fx = {}

    # donor 0 empty; donor 1 a variant at every position (overflows K)
    rng = np.random.default_rng(9)
    genome = rng.integers(0, 5, size=4096, dtype=np.int8)
    pos, ref, alt, p1, p2, counts = _empty_cohort(2, 1, 1280)
    n = 1024
    pos[1, 0, :n] = np.arange(n)
    ref[1, 0, :n] = genome[:n]
    alt[1, 0, :n] = (genome[:n] + 1) % 5
    p1[1, 0, :n] = 1
    counts[1, 0] = n
    draws = (np.array([0, 1, 0, 1] * 4, np.int32), np.zeros(16, np.int32),
             np.tile(np.array([0, 100, 900, 3968], np.int32), 4))
    fx["empty_rows_and_overflow"] = (
        (genome, np.zeros(1, np.int32), pos, ref, alt, p1, p2, counts), draws, 128, 8)

    # three variants at one position: the last in file order wins
    pos, ref, alt, p1, p2, counts = _empty_cohort(1, 1, 1280)
    pos[0, 0, :3] = 10
    alt[0, 0, :3] = [1, 2, 3]
    p1[0, 0, :3] = 1
    counts[0, 0] = 3
    z = np.zeros(8, np.int32)
    fx["duplicate_positions"] = (
        (np.zeros(1024, np.int8), np.zeros(1, np.int32), pos, ref, alt, p1, p2, counts),
        (z, z, z), 64, 8)

    # a variant at every other base: windows straddle the coarse-grid bucket
    # boundaries (index 512 * j sits at position 1024 * j)
    rng = np.random.default_rng(11)
    genome = rng.integers(0, 5, size=8192, dtype=np.int8)
    pos, ref, alt, p1, p2, counts = _empty_cohort(1, 1, 4096)
    p = np.arange(4096, dtype=np.int32) * 2
    pos[0, 0] = p
    ref[0, 0] = genome[p]
    alt[0, 0] = (genome[p] + 1) % 5
    p1[0, 0] = rng.integers(0, 2, 4096)
    p2[0, 0] = rng.integers(0, 2, 4096)
    counts[0, 0] = 4096
    L = 512
    st = np.array([1024 * j - L // 2 for j in range(1, 8)]
                  + [1024 - 1, 0, 100, 3000, 7000, 4095, 7680], np.int32)
    z = np.zeros(st.size, np.int32)
    fx["bucket_crossing"] = (
        (genome, np.zeros(1, np.int32), pos, ref, alt, p1, p2, counts), (z, z, st), L, 64)

    # a chromosome shorter than L at the genome's end: the slice clamps to
    # G - L while variants stay at pos - start
    rng = np.random.default_rng(21)
    genome = rng.integers(0, 5, size=700, dtype=np.int8)
    pos, ref, alt, p1, p2, counts = _empty_cohort(1, 2, 128)
    pos[0, 1, :3] = [5, 30, 59]
    alt[0, 1, :3] = [1, 2, 3]
    p1[0, 1, :3] = 1
    p2[0, 1, :3] = [0, 1, 1]
    counts[0, 1] = 3
    fx["genome_end_clamp"] = (
        (genome, np.array([0, 640], np.int32), pos, ref, alt, p1, p2, counts),
        (np.zeros(3, np.int32), np.ones(3, np.int32), np.zeros(3, np.int32)), 256, 8)

    # the bucket table's edges (buckets of 2^BK = 4,096 bp): a variant every
    # 97 bp plus variants on both sides of each boundary and five at 4,096
    # itself (K=4 cuts that run); starts on boundaries, ends on boundaries
    # (s + L = j * 4,096), windows inside one bucket and across two; L odd
    rng = np.random.default_rng(31)
    genome = rng.integers(0, 5, size=20_000, dtype=np.int8)
    pos, ref, alt, p1, p2, counts = _empty_cohort(2, 1, 512)
    p = np.sort(np.concatenate([np.arange(0, 16_000, 97), [4095, 8191, 8192, 12287, 12288],
                                [4096] * 5]))
    n = p.size
    pos[0, 0, :n] = p
    ref[0, 0, :n] = genome[p]
    alt[0, 0, :n] = np.arange(n) % 5
    p1[0, 0, :n] = rng.integers(0, 2, n)
    p2[0, 0, :n] = rng.integers(0, 2, n)
    counts[0, 0] = n
    L = 333
    st = np.array([0, 4096, 8192, 12288, 4096 - L, 8192 - L, 12288 - L, 4095, 8191,
                   5000, 4000, 8000, 1, 4097 - L, 15_999, 0, 4096], np.int32)
    dn = (np.arange(st.size) >= st.size - 2).astype(np.int32)  # the last two: donor 1
    fx["bucket_edges"] = (
        (genome, np.zeros(1, np.int32), pos, ref, alt, p1, p2, counts),
        (dn, np.zeros(st.size, np.int32), st), L, 4)

    # a slice longer than the block: every position of 100-599 three times
    # and of 1,000-1,499 twice, all in bucket 0, so a window holds over a
    # thousand variants; at K=128 a run of three straddles the cut (128 =
    # 42 * 3 + 2) and a run of two ends on it (128 = 64 * 2)
    rng = np.random.default_rng(41)
    genome = rng.integers(0, 5, size=8192, dtype=np.int8)
    p = np.concatenate([np.repeat(np.arange(100, 600), 3), np.repeat(np.arange(1000, 1500), 2)])
    n = p.size
    pos, ref, alt, p1, p2, counts = _empty_cohort(1, 1, n + 7)
    pos[0, 0, :n] = p
    ref[0, 0, :n] = genome[p]
    alt[0, 0, :n] = np.arange(n) % 5
    p1[0, 0, :n] = rng.integers(0, 2, n)
    p2[0, 0, :n] = rng.integers(0, 2, n)
    counts[0, 0] = n
    st = np.array([100, 1000, 101, 1001, 0, 550, 599, 900, 1450, 2000, 7000], np.int32)
    z = np.zeros(st.size, np.int32)
    fx["dense_slice"] = (
        (genome, np.zeros(1, np.int32), pos, ref, alt, p1, p2, counts), (z, z, st), 777, 128)

    # starts past the row's last position, past the table's last bucket
    # (positions end below 12,288 = 3 buckets), the int32 extremes, and
    # before the row; donor 1 has no variants
    rng = np.random.default_rng(51)
    genome = rng.integers(0, 5, size=30_000, dtype=np.int8)
    pos, ref, alt, p1, p2, counts = _empty_cohort(2, 2, 256)
    for c, top in ((0, 9000), (1, 9990)):
        p = np.sort(rng.choice(top, size=200, replace=False)).astype(np.int32)
        p[-1] = top
        pos[0, c, :200] = p
        ref[0, c, :200] = genome[p]
        alt[0, c, :200] = (genome[p] + 1) % 5
        p1[0, c, :200] = rng.integers(0, 2, 200)
        p2[0, c, :200] = rng.integers(0, 2, 200)
        counts[0, c] = 200
    # (donor, chrom, start); the int32 extremes on chrom 0, whose offset is
    # 0, so that offset + start stays in int32 as it does in the JAX package
    dr = np.array([(0, 0, 9001), (0, 1, 9991), (0, 0, 9500), (0, 1, 12000), (0, 0, 12287),
                   (0, 1, 12288), (0, 0, 15_000), (0, 0, 25_000), (0, 0, 2**31 - 1),
                   (0, 0, 2**31 - 600), (0, 1, -50), (0, 0, -2**31), (0, 0, 8800),
                   (1, 1, 9000), (1, 0, 20_000)], np.int64).T.astype(np.int32)
    fx["far_starts"] = (
        (genome, np.array([0, 20_000], np.int32), pos, ref, alt, p1, p2, counts),
        tuple(np.ascontiguousarray(x) for x in dr), 600, 8)
    return fx


def random_draws(sampler, B, L, gen):
    """(donor, chrom, start) of B windows anywhere in the state, start 0 and
    the clamp limit included."""
    dev = sampler.device
    D, C = sampler.cohort.num_donors, len(sampler.genome.chrom_names)
    d = torch.randint(0, D, (B,), dtype=torch.int32, device=dev, generator=gen)
    c = torch.randint(0, C, (B,), dtype=torch.int32, device=dev, generator=gen)
    lim = (torch.as_tensor(sampler.genome.lengths, device=dev)[c.long()] - L).clamp(min=0)
    s = (torch.rand(B, device=dev, generator=gen) * (lim + 1).double()).long().clamp(max=lim)
    s[0] = 0
    s[-1] = lim[-1]
    return d, c, s.to(torch.int32)


# ---------------------------------------------------------------------------
# phase 3: the draw kernel
# ---------------------------------------------------------------------------

#: the main path's draw launches, in batches of B=64: sample(), sample_many(16)
#: and a link of sample_chain(16, 256)
DRAW_BATCHES = (1, 16, 256)
#: odd batch sizes of phase 3's checks (n_batches, B): lanes that cross and
#: do not fill the kernel's 64-lane blocks, a block over many batches (B=1)
#: and a batch over many blocks
DRAW_ODD_BATCHES = ((150, 1), (11, 3), (3, 65), (5, 100), (2, 257))
#: region counts of phase 3's checks: one, and both sides of 2^16, where
#: randint's multiplier wraps to 0
DRAW_SPANS = (1, 65_536, 65_537)


def draw_args(sampler) -> tuple:
    """The draws' operands after the batch size: regions, lengths, D, L."""
    return sampler._regions, sampler._lengths, sampler.cohort.num_donors, SEQ_LENGTH


def draw_sizes(sampler) -> tuple[int, int, int]:
    """The draws' sizes (R, D, C)."""
    regions, lengths, D, _ = draw_args(sampler)
    return regions.shape[0], D, lengths.shape[0]


def draw_checks(sampler, seed: int, cmp: Comparisons) -> int:
    """Phase 3's draw checks: the kernel bit-equal to ``draws_plain`` at
    every ``DRAW_BATCHES`` shape for several keys and steps, with a key the
    card holds and with a chain link's digest; at each ``DRAW_ODD_BATCHES``
    shape and each ``DRAW_SPANS`` region count the same way; the sampler's
    draws of ``JAX_DRAWS``' step equal to the JAX package's.  Returns the
    lanes compared."""
    dev, args = sampler.device, draw_args(sampler)
    keys = [(0, 0), prng_key(seed), (MASK32, 0x12345678), ((seed * 2654435761) & MASK32, 7)]
    steps = (0, 1, 123_457, 2**31 - 300, -5)
    digest = torch.tensor(0xDEADBEEF, dtype=torch.int64, device=dev)
    lanes = 0
    for n in DRAW_BATCHES:
        for key in keys:
            for step in steps:
                got = draw_windows(key, step, n, BATCH, *args)
                cmp.windows(got, draws_plain(key, step, n, BATCH, *args),
                            f"draw kernel key {key} step {step} x{n}")
                lanes += n * BATCH
        on_card = got.key  # a key the card holds, with and without a digest
        for d in (None, digest):
            cmp.windows(draw_windows(on_card, 0, n, BATCH, *args, digest=d),
                        draws_plain(on_card, 0, n, BATCH, *args, digest=d),
                        f"draw kernel, a key on the card, digest {d is not None}, x{n}")
            lanes += 2 * n * BATCH
    regions, lengths, D, L = args
    spans = torch.arange(max(DRAW_SPANS), dtype=torch.int32, device=dev) * 7919
    synthetic = torch.stack([spans - 2**28, spans + 1000], dim=1)  # a quarter of midpoints < 0
    shapes = [(n, B, regions) for n, B in DRAW_ODD_BATCHES]
    shapes += [(16, BATCH, synthetic[:R]) for R in DRAW_SPANS]
    for n, B, reg in shapes:
        shape, what = (n, B, reg, lengths, D, L), f"x{n} B={B} R={reg.shape[0]}"
        for key, step in ((prng_key(seed), 3), ((MASK32, 0x12345678), 2**31 - 2)):
            got = draw_windows(key, step, *shape)
            cmp.windows(got, draws_plain(key, step, *shape), f"draw kernel key {key} {what}")
            for d in (None, digest):  # a key the card holds
                cmp.windows(draw_windows(got.key, step, *shape, digest=d),
                            draws_plain(got.key, step, *shape, digest=d),
                            f"draw kernel, a key on the card, digest {d is not None}, {what}")
            lanes += 3 * n * B
    c = JAX_DRAWS
    sizes = draw_sizes(sampler)
    check(sizes == c["sizes"], f"the state's draw sizes {sizes} are not JAX_DRAWS' {c['sizes']}")
    r, d, ch = (t[:c["B"]].tolist() for t in sampler.draw_indices(c["step"], key=c["seed"]))
    check([r, d, ch] == [c["region"], c["donor"], c["chrom"]],
          f"the draws of step {c['step']} of PRNGKey({c['seed']}) differ from the JAX package's")
    link = draw_windows(prng_key(c["seed"]), 0, 1, BATCH, *args,
                        digest=torch.tensor(c["digest"], dtype=torch.int64, device=dev))
    check(link.key.tolist() == c["link_key"], "fold_in(key, digest) on the card differs from JAX's")
    return lanes


# ---------------------------------------------------------------------------
# phase 5: small files in the reference layout
# ---------------------------------------------------------------------------

def write_small_files(dirname: str, seed: int):
    import h5py

    rng = np.random.default_rng(seed)
    chroms = {"chr21": 46_000, "chr22": 51_000}
    donors = ["d0", "d1", "d2"]
    seqs = {c: rng.integers(0, 4, n).astype(np.int8) for c, n in chroms.items()}
    ref_h5 = os.path.join(dirname, "reference_genome.h5")
    with h5py.File(ref_h5, "w") as f:
        for i, (c, codes) in enumerate(seqs.items()):
            f.create_dataset(f"{c}/sequence", data=np.eye(5, dtype=np.int8)[codes],
                             compression="gzip")
            if i:  # one chromosome also carries the int8 codes dataset
                f.create_dataset(f"{c}/codes", data=codes, compression="gzip")
    cohort_h5 = os.path.join(dirname, "cohort.h5")
    bases = np.frombuffer(b"ACGT", np.uint8)
    with h5py.File(cohort_h5, "w") as f:
        for d in donors:
            for c, n in chroms.items():
                k = n // 100
                t = np.zeros(k, dtype=SNP_STRUCT_DTYPE)
                t["chrom"] = c.encode()
                t["start"] = np.sort(rng.choice(n, size=k, replace=False))
                t["stop"] = t["start"] + 1
                r = seqs[c][t["start"]]
                t["ref"] = bases[r].view("S1")
                t["alt"] = bases[(r + rng.integers(1, 4, k)) % 4].view("S1")
                t["phase1"] = rng.integers(0, 2, k)
                t["phase2"] = rng.integers(0, 2, k)
                f.create_dataset(cohort_group_path(d, c.removeprefix("chr")) + "/snp_data",
                                 data=t, compression="gzip")
    bed = os.path.join(dirname, "regions.bed")
    with open(bed, "w") as f:
        for _ in range(500):
            c = rng.choice(list(chroms))
            s = int(rng.integers(0, chroms[c] - 2000))
            f.write(f"{c}\t{s}\t{s + int(rng.integers(200, 2001))}\n")
    samples = os.path.join(dirname, "samples.txt")
    with open(samples, "w") as f:
        f.write("\n".join(donors) + "\n")
    return bed, cohort_h5, ref_h5, samples, seqs


def check_from_files(tmp: str, seed: int, cfg: SamplerConfig, cmp: Comparisons) -> None:
    bed, cohort_h5, ref_h5, samples, seqs = write_small_files(tmp, seed)
    before = encode_windows_kernel.launches
    fs = DeviceHaplotypeSampler.from_files(bed, cohort_h5, ref_h5, samples, config=cfg)
    b = fs.sample()
    check(encode_windows_kernel.launches == before + 1, "from_files sampler launched once")
    cmp.windows(b, fs.windows_from_draws(*fs.draw_indices(0), kernel="baseline"), "from_files")
    check(fs.genome.chrom_names == list(seqs), "from_files chromosomes")
    for c, off, n in zip(seqs, fs.genome.offsets, fs.genome.lengths):
        check(np.array_equal(fs.genome.codes_flat[off:off + n], seqs[c]), f"{c} codes")
    check(int(b.n_variants.sum()) > 0, "from_files windows hold variants")
    log("from_files: gzip cohort + reference HDF5 loaded; batch bit-equal to the plain version")


# ---------------------------------------------------------------------------
# device times of phases 10 and 17
# ---------------------------------------------------------------------------

def profiler_device_ms(fn, args_list) -> float | None:
    """Device busy time per call of ``fn`` over ``args_list``: the sum of the
    durations of every device op ``torch.profiler`` (CUPTI) records, over the
    number of calls; ``None`` where it recorded fewer device ops than calls."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for args in args_list:
            fn(*args)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if len(dev) < len(args_list):
        return None
    return sum(e.time_range.elapsed_us() for e in dev) / len(args_list) / 1e3


def step_times(fn, n_warm: int, n: int) -> tuple[float, float]:
    """``(device ms, host ms)`` a call of ``fn(i)`` over ``n`` calls after
    ``n_warm``: CUDA events around the calls, and the host clock to a
    synchronize."""
    for i in range(n_warm):
        fn(i)
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    a.record()
    for i in range(n_warm, n_warm + n):
        fn(i)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n, (time.perf_counter() - t0) * 1e3 / n


def trace_calls(fn, n_calls: int, what: str, top: int = 6) -> tuple[str, dict]:
    """Device busy time, idle share and device ops a call of ``fn()``, and
    its ``top`` heaviest device ops, under ``torch.profiler`` after one call
    to warm up (the profiler's own host cost inflates the wall time, so this
    idle share is an upper bound).  User annotations on the device's
    timeline (``Optimizer.step``) span other ops and are left out.  Returns
    the text and ``{"wall_ms", "busy_ms", "ops"}`` a call (``busy_ms`` and
    ``ops`` ``None`` where the profiler recorded no device op)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    stats = {"wall_ms": wall_us / n_calls / 1e3, "busy_ms": None, "ops": None}
    if not dev:
        return f"trace {what}: the profiler recorded no device events", stats
    by_name: dict[str, list[float]] = {}
    for e in dev:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    busy = sum(sum(v) for v in by_name.values())
    stats |= {"busy_ms": busy / n_calls / 1e3, "ops": len(dev) / n_calls}
    heavy = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:top]
    rows = "; ".join(
        f"{name[:60]} x{len(v)} {sum(v) / n_calls:.1f} us/call" for name, v in heavy
    )
    return (f"trace {what} x{n_calls}: wall {wall_us / n_calls:.1f} us/call, "
            f"device busy {busy / n_calls:.1f} us/call, idle share "
            f"{1 - busy / wall_us:.3f}; {len(dev) / n_calls:.0f} device ops/call; top: {rows}",
            stats)


# ---------------------------------------------------------------------------
# phase 19: the window kernel at long windows and past 128 variants
# ---------------------------------------------------------------------------

#: Enformer's sampler: window pairs a step, window length, variants applied
ENFORMER_B, ENFORMER_L, ENFORMER_K = 2, 196_608, 512
#: (B, L, K) of phase 19's comparisons: Enformer's batch and window past and
#: up to 128 variants, and windows of one part, just past one part and of
#: several parts at K=512 and K=128
LONG_SHAPES = ([(ENFORMER_B, ENFORMER_L, K) for K in (ENFORMER_K, 300, 129, 128, 64)]
               + [(B, L, K) for B in (1, 61) for L in (8192, 8193, 40_000)
                  for K in (ENFORMER_K, 128)])


def long_windows_phase(seed: int, genome, cohort, regions, sampler, cmp: Comparisons) -> dict:
    """Phase 19 (``sampler``: phase 3's, whose index the comparisons use).
    Returns its comparisons, launches and windows past K."""
    index, dev = sampler.index, sampler.device
    gen = torch.Generator(device=dev).manual_seed(seed + 19)
    launches = n_cmp = over_k = 0
    for B, L, K in LONG_SHAPES:
        for _ in range(2):
            d, c, s = random_draws(sampler, B, L, gen)
            encode_windows_kernel.launches = 0
            got = cmp.encode(index, d, c, s, L, K, f"long windows B={B} L={L} K={K}")
            check(encode_windows_kernel.launches == 1,
                  f"B={B} L={L} K={K}: {encode_windows_kernel.launches} window kernel launches")
            launches += 1
            n_cmp += 1
            if K == ENFORMER_K:
                over_k += int((got.overflow > 0).sum())

    # Enformer's sampler: draws and encode at its config, against the plain ones
    lcfg = SamplerConfig(seq_length=ENFORMER_L, batch_size=ENFORMER_B,
                         max_variants_per_window=ENFORMER_K)
    long_sampler = DeviceHaplotypeSampler(genome, cohort, regions, lcfg)
    encode_windows_kernel.launches = draw_windows.launches = 0
    batches = [long_sampler.sample() for _ in range(4)]
    torch.cuda.synchronize()
    check(encode_windows_kernel.launches == 4 and draw_windows.launches == 4,
          f"4 sample() calls at L={ENFORMER_L}: {encode_windows_kernel.launches} window and "
          f"{draw_windows.launches} draw kernel launches, not one each a call")
    launches += 4
    base = prng_key(lcfg.seed)
    args = (long_sampler._regions, long_sampler._lengths, long_sampler.cohort.num_donors,
            ENFORMER_L)
    for step, b in enumerate(batches):
        d = draws_plain(base, step, 1, ENFORMER_B, *args)
        want = long_sampler.windows_from_draws(*d[1:4], kernel="baseline")
        cmp.windows(b, want, f"sample() at L={ENFORMER_L} K={ENFORMER_K}, step {step}")
        over_k += int((b.overflow > 0).sum())
        n_cmp += 1
    check(over_k == 0, f"{over_k} windows at K={ENFORMER_K} held more than K variants")
    del long_sampler, batches

    L, K, B = ENFORMER_L, ENFORMER_K, ENFORMER_B
    for _ in range(2):
        cmp.encode(index, *random_draws(sampler, B, L, gen), L, K, f"batch B={B} L={L} K={K}")
    n_cmp += 2
    log(f"long windows: {n_cmp} kernel/plain comparisons bit-equal at (B, L, K) in "
        f"{LONG_SHAPES} (two draws each), 4 sample() batches at L={L} K={K} and 2 more at "
        f"B={B}; {launches} window kernel launches, one a call; {over_k} windows past K={K}")
    return {"comparisons": n_cmp, "launches": launches, "windows_past_k": over_k}


# ---------------------------------------------------------------------------
# phase 7: converter input, made from --seed
# ---------------------------------------------------------------------------

#: GRCh38 chr1 length, and the record count of chr1 in the 1000 Genomes
#: Phase 3 release (ALL.chr1.phase3_shapeit2_mvncall_integrated_v5a)
CHR1_LENGTH = 248_956_422
CHR1_RECORDS = 6_468_094
N_VCF_SAMPLES = 8
#: record kinds of the cohort VCF and their shares
RECORD_SHARES = {"biallelic SNV": 0.88, "indel": 0.07, "multi-allelic SNV": 0.03,
                 "non-ACGT ALT (*, N, <DEL>)": 0.02}
#: genotypes of the cohort VCF and their shares, per sample and record
GT_SHARES = {"0|0": 0.55, "0|1": 0.15, "1|0": 0.15, "1|1": 0.08, "0/1": 0.03,
             "1/1": 0.01, "./.": 0.02, "1|2": 0.01}
#: the small VCF whose framing without a region takes the 64-byte route
N_CONTIGS, RECORDS_PER_CONTIG = 300, 1000

BGZF_PAYLOAD = 0xFF00
BGZF_EOF = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00BC\x02\x00\x1b\x00"
            b"\x03\x00\x00\x00\x00\x00\x00\x00\x00\x00")


def _bgzf_block(chunk) -> bytes:
    co = zlib.compressobj(1, zlib.DEFLATED, -15)
    comp = co.compress(chunk) + co.flush()
    check(len(comp) + 26 <= 0x10000, "BGZF block too large")
    header = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00BC\x02\x00"
              + struct.pack("<H", len(comp) + 25))
    return header + comp + struct.pack("<II", zlib.crc32(chunk), len(chunk))


def write_bgzf(path: str, header: bytes, body: np.ndarray) -> None:
    """``header`` + ``body`` as BGZF blocks, compressed on every core."""
    view = memoryview(body)
    chunks = [header] + [view[i:i + BGZF_PAYLOAD] for i in range(0, len(view), BGZF_PAYLOAD)]
    with ThreadPoolExecutor(os.cpu_count()) as ex, open(path, "wb") as f:
        for block in ex.map(_bgzf_block, chunks):
            f.write(block)
        f.write(BGZF_EOF)


def _scatter(buf, at, mat, lens) -> None:
    """``buf[at[i] + j] = mat[i, j]`` for ``j < lens[i]``."""
    for j in range(mat.shape[1]):
        m = lens > j
        buf[at[m] + j] = mat[m, j]


def vcf_body(chrom_id, chroms, pos, ref, ref_len, alt, alt_len, gt_idx) -> np.ndarray:
    """The data lines of a VCF as one uint8 array, assembled with vector ops:
    ``CHROM POS . REF ALT . PASS . GT g1 .. gS``."""
    n, S = gt_idx.shape
    cw = max(map(len, chroms))
    cmat = np.array([np.frombuffer(c.ljust(cw, b"\0"), np.uint8) for c in chroms])
    clen = np.array([len(c) for c in chroms])[chrom_id]
    nd = 1 + sum((pos >= 10**k).astype(np.int64) for k in range(1, 10))
    fixed = np.frombuffer(b"\t.\tPASS\t.\tGT", np.uint8)
    length = clen + 1 + nd + 3 + ref_len + 1 + alt_len + fixed.size + 4 * S + 1
    at = np.cumsum(length) - length
    buf = np.empty(int(length.sum()), np.uint8)
    _scatter(buf, at, cmat[chrom_id], clen)
    at += clen
    buf[at] = ord("\t")
    at += 1
    exp = np.maximum(nd[:, None] - 1 - np.arange(10), 0)
    _scatter(buf, at, (pos[:, None] // 10**exp % 10 + ord("0")).astype(np.uint8), nd)
    at += nd
    for c in b"\t.\t":
        buf[at] = c
        at += 1
    _scatter(buf, at, ref, ref_len)
    at += ref_len
    buf[at] = ord("\t")
    at += 1
    _scatter(buf, at, alt, alt_len)
    at += alt_len
    for c in fixed:
        buf[at] = c
        at += 1
    gts = np.frombuffer("".join(GT_SHARES).encode(), np.uint8).reshape(-1, 3)
    for s in range(S):
        buf[at] = ord("\t")
        for j in range(3):
            buf[at + 1 + j] = gts[gt_idx[:, s], j]
        at += 4
    buf[at] = ord("\n")
    return buf


def write_cohort_vcf(path: str, contigs: dict, n: int, samples: list, seed: int) -> dict:
    """A BGZF cohort VCF of ``n`` records spread over ``contigs`` ({name:
    length}) in proportion to length, sorted, with the record kinds of
    ``RECORD_SHARES`` and the genotypes of ``GT_SHARES``.  Returns the
    count of each record kind."""
    rng = np.random.default_rng(seed)
    names = list(contigs)
    lengths = np.array(list(contigs.values()), np.int64)
    chrom_id = rng.choice(len(names), n, p=lengths / lengths.sum())
    pos = (rng.random(n) * lengths[chrom_id]).astype(np.int64) + 1
    order = np.lexsort((pos, chrom_id))
    chrom_id, pos = chrom_id[order], pos[order]

    kind = rng.choice(len(RECORD_SHARES), n, p=list(RECORD_SHARES.values()))
    base, shift = rng.integers(0, 4, n), rng.integers(1, 4, n)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    ref, alt = np.zeros((n, 3), np.uint8), np.zeros((n, 5), np.uint8)
    ref_len, alt_len = np.ones(n, np.int64), np.ones(n, np.int64)
    ref[:, 0], alt[:, 0] = acgt[base], acgt[(base + shift) % 4]
    # indels: a deletion (REF of 2-3 bases) or an insertion (ALT of 2-3 bases)
    extra, deletion = rng.integers(1, 3, n), rng.random(n) < 0.5
    for rows, mat, lens in (((kind == 1) & deletion, ref, ref_len),
                            ((kind == 1) & ~deletion, alt, alt_len)):
        alt[rows, 0] = ref[rows, 0]
        mat[rows, 1] = acgt[(base[rows] + 1) % 4]
        mat[rows, 2] = acgt[(base[rows] + 2) % 4]
        lens[rows] = 1 + extra[rows]
    # multi-allelic SNVs: ALT "X,Y" with X, Y and REF distinct
    m = kind == 2
    alt[m, 1] = ord(",")
    alt[m, 2] = acgt[(base[m] + shift[m] % 3 + 1) % 4]
    alt_len[m] = 3
    # non-ACGT ALTs
    which = rng.integers(0, 3, n)
    alt[(kind == 3) & (which == 0), 0] = ord("*")
    alt[(kind == 3) & (which == 1), 0] = ord("N")
    dl = (kind == 3) & (which == 2)
    alt[dl] = np.frombuffer(b"<DEL>", np.uint8)
    alt_len[dl] = 5

    gt_idx = rng.choice(len(GT_SHARES), (n, len(samples)), p=list(GT_SHARES.values()))
    header = "".join(
        ["##fileformat=VCFv4.2\n"]
        + [f"##contig=<ID={c},length={ln}>\n" for c, ln in contigs.items()]
        + ['##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n',
           "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t" + "\t".join(samples) + "\n"]
    ).encode()
    body = vcf_body(chrom_id, [c.encode() for c in names], pos, ref, ref_len, alt, alt_len,
                    gt_idx)
    write_bgzf(path, header, body)
    return {k: int((kind == i).sum()) for i, k in enumerate(RECORD_SHARES)}


def make_converter_input(dirname: str, seed: int, n_records: int = CHR1_RECORDS):
    """The chr1 cohort VCF (``chr1.filtered.vcf.gz``), its sample list, and
    the 300-contig VCF.  Returns ``(samples, samples_path, ctg_path)``."""
    samples = [f"donor{d}" for d in range(N_VCF_SAMPLES)]
    samples_path = os.path.join(dirname, "samples.txt")
    with open(samples_path, "w") as f:
        f.write("\n".join(samples) + "\n")
    t0 = time.perf_counter()
    kinds = write_cohort_vcf(os.path.join(dirname, "chr1.filtered.vcf.gz"),
                             {"chr1": CHR1_LENGTH}, n_records, samples, seed)
    ctg_path = os.path.join(dirname, "ctg300.vcf.gz")
    write_cohort_vcf(ctg_path, {f"ctg{i:03d}": 1_000_000 for i in range(N_CONTIGS)},
                     N_CONTIGS * RECORDS_PER_CONTIG, samples, seed + 1)
    size = os.path.getsize(os.path.join(dirname, "chr1.filtered.vcf.gz"))
    log(f"converter input: chr1 cohort VCF, {n_records:,} records over {CHR1_LENGTH:,} bp, "
        f"{len(samples)} samples, {size / 1e6:.1f} MB BGZF; records by kind {kinds}; "
        f"genotype shares {GT_SHARES}; and {N_CONTIGS} contigs x {RECORDS_PER_CONTIG:,} "
        f"records; written in {time.perf_counter() - t0:.1f} s")
    return samples, samples_path, ctg_path


# ---------------------------------------------------------------------------
# phases 8-10: the converter's main path, decode edge fixtures, times
# ---------------------------------------------------------------------------

class DecodeComparisons:
    """Runs a decode kernel and its plain version on the same frames and
    requires every int32 column bit-equal."""

    def __init__(self):
        self.max_abs_err = {"vcf_decode12": 0, "vcf_decode64": 0}
        self.count = 0

    def _check(self, name, got, want, what):
        torch.cuda.synchronize()  # a fault in the kernel surfaces here
        check(len(got) == len(want), f"{what}: column count")
        for i, (g, w) in enumerate(zip(got, want)):
            check(g.shape == w.shape and g.dtype == w.dtype == torch.int32,
                  f"{what}: column {i} shape/dtype")
            err = int((g.long() - w.long()).abs().max()) if g.numel() else 0
            self.max_abs_err[name] = max(self.max_abs_err[name], err)
            check(err == 0, f"{what}: column {i} differs from the plain version (max |d| {err})")
        self.count += 1

    def decode12(self, frames, with_sample, what):
        self._check("vcf_decode12", decode_frames12_kernel(frames, with_sample),
                    decode_frames12_packed(frames, with_sample), f"decode12 {what}")

    def decode64(self, frames, with_sample, what):
        self._check("vcf_decode64", decode_frames_kernel(frames, with_sample),
                    decode_frames_packed(frames, with_sample), f"decode64 {what}")


def _compare_files(a: str, b: str) -> int:
    import h5py

    with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
        names = []
        fa.visititems(lambda n, o: names.append(n) if isinstance(o, h5py.Dataset) else None)
        other = []
        fb.visititems(lambda n, o: other.append(n) if isinstance(o, h5py.Dataset) else None)
        check(sorted(names) == sorted(other) and names, "run(): dataset names")
        for n in names:
            check(fa[n][()].tobytes() == fb[n][()].tobytes(), f"run(): {n} differs")
    return len(names)


def converter_main_path(tmp: str, seed: int, dev, dec: DecodeComparisons,
                        n_records: int = CHR1_RECORDS) -> dict:
    """Phases 7 and 8.  Returns what the later phases use: the launch counts,
    the per-donor task seconds, the record count and paths."""
    samples, samples_path, ctg_path = make_converter_input(tmp, seed, n_records)
    threads = os.cpu_count()
    kw = dict(cores=1, cxx_threads=threads, chromosomes=[1], single_pass=False, device=dev)
    conv = VCFtoHDF5Converter("smoke", tmp, os.path.join(tmp, "out_kernel"), samples_path, **kw)
    host = VCFtoHDF5Converter("smoke", tmp, os.path.join(tmp, "out_host"), samples_path,
                              device_decode=False, **kw)
    chr1 = conv.config.vcf_path(1)

    decode_frames12_kernel.launches = 0
    decode_frames_kernel.launches = 0
    got, task_s = {}, {}
    for donor in samples:
        t0 = time.perf_counter()
        got[donor] = conv.parse_snps(chr1, donor, "chr1")
        task_s[donor] = time.perf_counter() - t0
    t0 = time.perf_counter()
    got_ctg = conv.parse_snps(ctg_path, samples[0], None)
    ctg_s = time.perf_counter() - t0
    launches = {"vcf_decode12": decode_frames12_kernel.launches,
                "vcf_decode64": decode_frames_kernel.launches}
    log(f"converter main path: parse_snps for {len(samples)} donors of chr1 "
        f"({sum(task_s.values()):.2f} s) and one donor of the {N_CONTIGS}-contig file without "
        f"a region ({ctg_s:.2f} s); kernel launches {launches}")
    for name, n in launches.items():
        check(n > 0, f"the converter's main path never launched {name}")

    # the same tasks with device_decode=False: 64-byte frames, numpy decode
    for donor in samples:
        want = host.parse_snps(chr1, donor, "chr1")
        (s, n), (ws, wn) = got[donor], want
        check(n == wn == n_records, f"{donor}: records seen {n} {wn}")
        check(s.dtype == ws.dtype == SNP_STRUCT_DTYPE and s.tobytes() == ws.tobytes(),
              f"{donor}: SNP struct differs from the device_decode=False task")
        check(0.8 * n_records < len(s) < n_records, f"{donor}: {len(s)} SNPs")
        check(bool((s["chrom"] == b"chr1").all()) and bool((np.diff(s["start"]) >= 0).all()),
              f"{donor}: chrom and sorted starts")
    want = host.parse_snps(ctg_path, samples[0], None)
    check(got_ctg[0].tobytes() == want[0].tobytes() and got_ctg[1] == want[1],
          f"{N_CONTIGS}-contig SNP struct differs from the device_decode=False task")
    log(f"converter checks: {len(samples)} chr1 SNP structs ({len(got[samples[0]][0]):,} SNPs "
        f"for {samples[0]}) and the {N_CONTIGS}-contig struct ({len(got_ctg[0]):,} SNPs) "
        "byte-equal to the device_decode=False tasks")

    # each kernel against its plain version on the frames the main path decoded
    for donor in samples:
        f12 = VCFSource(chr1, threads).frame12(donor, "chr1")[0]
        dec.decode12(torch.from_numpy(f12).to(dev), True, f"chr1 {donor}")
    f64 = VCFSource(ctg_path, threads).frame(samples[0]).records
    dec.decode64(torch.from_numpy(f64).to(dev), True, f"{N_CONTIGS} contigs")

    if importlib.util.find_spec("h5py") is None:
        log("converter run(): not run: h5py is not installed "
            "(tests/test_torch_convert.py holds run() against the JAX package)")
    else:
        conv.run()
        host.run()
        n = _compare_files(conv.config.final_h5_path, host.config.final_h5_path)
        log(f"converter run(): {n} datasets byte-equal to the device_decode=False run")
    return {"launches": launches, "task_s": task_s, "chr1": chr1, "samples": samples,
            "threads": threads, "n_records": n_records, "samples_path": samples_path,
            "ctg_path": ctg_path, "structs": {d: got[d][0] for d in samples}}


def decode_edge_fixtures(tmp: str, seed: int, dev, dec: DecodeComparisons, f12, f64) -> None:
    """Phase 9 (``f12``/``f64``: one donor's chr1 frames on the device)."""
    path = os.path.join(tmp, "decode_edge.vcf")
    with open(path, "w") as f:
        f.write(DECODE_EDGE_VCF)
    src = VCFSource(path)
    edge = [(s, src.frame12(s)[0], src.frame(s).records) for s in ("s1", "s2")]
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    r12, r64 = (torch.randint(0, 256, (1 << 20, w), dtype=torch.uint8, device=dev, generator=g)
                for w in (REC12_SIZE, REC_SIZE))
    for ws in (True, False):
        for n in (1, 1023, 1025, 4097):
            dec.decode12(f12[:n], ws, f"N={n} with_sample={ws}")
            dec.decode64(f64[:n], ws, f"N={n} with_sample={ws}")
        dec.decode12(f12, ws, f"full chr1 frame with_sample={ws}")
        dec.decode64(f64, ws, f"full chr1 frame with_sample={ws}")
        for s, e12, e64 in edge:
            dec.decode12(torch.from_numpy(e12).to(dev), ws, f"DECODE_EDGE_VCF {s}")
            dec.decode64(torch.from_numpy(e64).to(dev), ws, f"DECODE_EDGE_VCF {s}")
        dec.decode12(r12, ws, f"1 M random frames with_sample={ws}")
        dec.decode64(r64, ws, f"1 M random frames with_sample={ws}")
    log(f"decode edge fixtures: {dec.count} kernel/plain comparisons bit-equal so far")


def task_split(chr1: str, donor: str, dev, threads: int) -> list[float]:
    """The per-donor task's stages in seconds, each ended by a synchronise:
    framing, h2d, kernel, d2h, unpack, struct assembly."""
    t = [time.perf_counter()]
    rec, table, _ = VCFSource(chr1, threads).frame12(donor, "chr1")
    t.append(time.perf_counter())
    x = torch.from_numpy(rec).to(dev)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    out = decode_frames12_kernel(x)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    cols = [c.cpu().numpy() for c in out]
    t.append(time.perf_counter())
    decoded = unpack12_columns(*cols)
    t.append(time.perf_counter())
    snp_struct_from_frames12(decoded, table)
    t.append(time.perf_counter())
    return list(np.diff(t))


def decode_times(card: str, ctx: dict, f12, f64) -> dict:
    """Phase 10.  Returns ``{kernel: (ms, plain_ms, bound_ms)}``: the device
    time per call of the kernel and of its plain version on one donor's chr1
    frame, back to back behind a sleep kernel (CUDA events: a profiler
    session this late in the script has recorded no device ops on the card,
    so its reading is only printed beside), and the bound: each input byte
    read once and each int32 output written once, over 3.35 TB/s."""
    n = ctx["n_records"]
    out = {
        "vcf_decode12": (device_ms(decode_frames12_kernel, [(f12,)] * 20)[0],
                         device_ms(decode_frames12_packed, [(f12,)] * 3)[0],
                         n * (REC12_SIZE + 3 * 4) / HBM_BYTES_PER_S * 1e3),
        "vcf_decode64": (device_ms(decode_frames_kernel, [(f64,)] * 10)[0],
                         device_ms(decode_frames_packed, [(f64,)] * 2)[0],
                         n * (REC_SIZE + 7 * 4) / HBM_BYTES_PER_S * 1e3),
    }
    for (name, (ms, plain, bound)), fn, x in zip(
            out.items(), (decode_frames12_kernel, decode_frames_kernel), (f12, f64)):
        prof = profiler_device_ms(fn, [(x,)] * 10)
        prof = "no device ops recorded" if prof is None else f"{prof:.5f} ms"
        log(f"[{card}] {name} on one donor's chr1 frame ({n:,} records): {ms:.5f} ms a call "
            f"back to back (CUDA events; profiler: {prof}), plain version {plain:.5f} ms, "
            f"bound {bound:.5f} ms (bytes, 3.35 TB/s)")
    stages = ("framing", "h2d", "kernel", "d2h", "unpack", "struct")
    for donor in ctx["samples"][:3]:
        split = task_split(ctx["chr1"], donor, f12.device, ctx["threads"])
        log(f"[{card}] per-donor task split {donor} (s): "
            + ", ".join(f"{k} {v:.4f}" for k, v in zip(stages, split)))
    rates = [n / s for s in ctx["task_s"].values()]
    log(f"[{card}] parse_snps (frame + decode + struct) records/s over "
        f"{len(rates)} donors (host clock): median {np.median(rates):,.0f}, "
        f"min {min(rates):,.0f}, max {max(rates):,.0f}")
    return out


# ---------------------------------------------------------------------------
# phases 11-12: the window-kernel lab
# ---------------------------------------------------------------------------

#: the lab variants phase 11 checks, each with dma_only's grid stride
LAB_CONFIGS = (("full", SP), ("dma_only", SP), ("dma_only", 1024), ("compute_only", SP))


def lab_ptxas(text: str) -> dict:
    """``{"<variant>_w<w>": (registers and shared memory, spills)}`` of each
    lab kernel instance, from ``ptxas -v``'s output for
    ``csrc/window_kernel_lab.cu``."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"lab_kernelILi(\d)ELi(\d+)EE", line)
        if "Compiling entry" in line and m:
            cur = f"{VARIANTS[int(m[1])]}_w{m[2]}"
            out[cur] = ["", ""]
        elif cur and "spill" in line:
            out[cur][1] = line.strip()
        elif cur and "registers" in line:
            out[cur][0] = line.split(":", 1)[1].strip()
    return out


def lab_compare(index, draws, L, K, cmp: Comparisons, what: str) -> None:
    """Every lab variant at every w of ``WINDOWS_PER_BLOCK`` bit-equal to its
    plain version on ``draws``, and every w bit-equal to w = 1."""
    for variant, sp in LAB_CONFIGS:
        want = lab_plain(index, *draws, L=L, K=K, variant=variant, sp=sp)
        at_w1 = None
        for w in WINDOWS_PER_BLOCK:
            got = encode_windows_lab(index, *draws, L=L, K=K, variant=variant, w=w, sp=sp)
            cmp.windows(got, want, f"lab {variant} sp={sp} w={w} {what}")
            at_w1 = at_w1 or got
            check(all(torch.equal(a, b) for a, b in zip(got, at_w1)),
                  f"lab {variant} sp={sp} {what}: w={w} differs from w=1")


def lab_checks(sampler, seed: int, cmp: Comparisons) -> None:
    """Phase 11: the lab kernel against its plain versions on the edge
    fixtures and on the deployment state."""
    dev = sampler.device
    for name, (state, dr, L, K) in edge_fixtures().items():
        idx = build_window_index(*(torch.from_numpy(a).to(dev) for a in state))
        lab_compare(idx, [torch.from_numpy(a).to(dev) for a in dr], L, K, cmp, name)
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    shapes = ([(B, SEQ_LENGTH, K) for B in (1, 61, 64, 2048) for K in (K_MAX, 64)]
              + [(BATCH, L, K_MAX) for L in (256, 4080)])
    for B, L, K in shapes:
        lab_compare(sampler.index, random_draws(sampler, B, L, gen), L, K, cmp,
                    f"B={B} L={L} K={K}")
    log(f"lab checks: {cmp.count} lab kernel/plain comparisons bit-equal ({VARIANTS} x w in "
        f"{WINDOWS_PER_BLOCK}, dma_only at sp 512 and 1024; edge fixtures and B in "
        f"{{1, 61, 64, 2048}} x K in {{128, 64}} at L=1000, L in {{256, 4080}} at B=64); every w "
        f"equal to w=1")


def lab_path(card: str, seed: int, sampler, cmp: Comparisons) -> dict:
    """Phase 12: the lab's measurement on the lab fixture through the tool's
    entry point at the JAX lab's shape, then on the deployment state's chr1
    at the same shape and at the main path's B, with the lab kernel's launch
    count set to 0 just before and read just after.  Returns the numbers of
    the ``kernels`` line: launches, and ``full_w1``'s device ms, plain ms and
    bound at the lab shape.  Fails where ``full_w1`` takes more than 1.25
    times ``prod`` on any of the three states."""
    dev = sampler.device
    encode_windows_lab.launches = 0
    t0 = time.perf_counter()
    res = lab.main(["--state", "lab", "--seed", str(seed)])
    Lc = int(sampler.genome.lengths[0])
    D = sampler.cohort.num_donors
    runs = {f"lab fixture B={lab.LAB_B}": res["results"]}
    for B in (lab.LAB_B, BATCH):
        runs[f"deployment chr1 B={B}"] = lab.lab_rows(sampler.index, Lc, D, B=B, seed=seed)
    launches = encode_windows_lab.launches
    log(f"lab path: {len(runs)} runs of {len(res['results'])} rows in "
        f"{time.perf_counter() - t0:.1f} s; lab kernel launches {launches}")
    check(launches > 0, "the lab's path never launched the lab kernel")
    for title, rows in runs.items():
        for r in rows:
            log(f"[{card}] lab {title} L={lab.LAB_L} K={lab.LAB_K} n_chain={lab.LAB_N_CHAIN} "
                f"{r['name']}: {r['device_ms_per_launch']:.6f} ms a launch (CUDA events, back "
                f"to back), {r['device_windows_per_sec']:,.0f} windows/s on the device, bound "
                f"{r['bound_ms']:.6f} ms (bytes, 3.35 TB/s); chained {r['median_s']:.6f} s a "
                f"call, {r['windows_per_sec']:,.0f} windows/s (host clock)")
    for title, rows in runs.items():
        ms = {r["name"]: r["device_ms_per_launch"] for r in rows}
        ratio = ms["full_w1"] / ms["prod"]
        log(f"[{card}] lab {title}: full_w1 / prod = {ms['full_w1']:.6f} / {ms['prod']:.6f} "
            f"= {ratio:.4f}; dma_only_w1 {ms['dma_only_w1'] / ms['full_w1']:.4f} and "
            f"compute_only_w1 {ms['compute_only_w1'] / ms['full_w1']:.4f} of full_w1")
        check(ratio <= 1.25, f"lab {title}: full_w1 takes {ratio:.3f} x prod (limit 1.25)")

    # full_w1 against its plain version at the lab shape, and the plain time
    index, Lc, D = lab.build_fixture(device=dev)
    draws = lab.draws(np.random.default_rng(seed + 4), Lc, D, lab.LAB_B, lab.LAB_L, dev)
    kw = dict(L=lab.LAB_L, K=lab.LAB_K, variant="full")
    plain = functools.partial(lab_plain, index, **kw)
    plain_ms = device_ms(plain, [draws])[0]
    cmp.windows(encode_windows_lab(index, *draws, **kw), plain(*draws), "lab fixture full_w1")
    full = next(r for r in res["results"] if r["name"] == "full_w1")
    log(f"[{card}] lab fixture full plain version, B={lab.LAB_B}: {plain_ms:.5f} ms a call "
        "(CUDA events behind a sleep kernel)")
    return {"launches": launches, "ms": full["device_ms_per_launch"], "plain_ms": plain_ms,
            "bound_ms": full["bound_ms"]}


# ---------------------------------------------------------------------------
# phase 13: the training path
# ---------------------------------------------------------------------------

#: fused steps, then ``train_on_sampler``'s steps, of the training path
N_FUSED, N_TRAIN_ON = 20, 5
#: sampling steps of the fused steps: past every step the earlier phases drew
FUSED_STEP0 = 1_000_000
#: card against the CPU: the largest relative error allowed over the forward
#: outputs and every gradient, each relative to its tensor's largest value
#: (gradients floored at 1e-3 of the largest gradient: the attention key
#: biases' gradient is zero up to round-off).  float32 with TF32 off differs
#: from the CPU only in the order of sums; bf16 on the card against float32
#: on the CPU also rounds each op's result to 8 significant bits
F32_TOL, BF16_TOL = 1e-4, 5e-2


def outputs_and_grads(model, h1, h2, nv) -> dict:
    """The forward outputs and every parameter's gradient of ``loss_fn``,
    as float32 CPU tensors."""
    loss, _ = loss_fn(model, h1, h2, nv)
    loss.backward()
    with torch.no_grad():
        out = model(h1, h2)
    return ({k: v.float().cpu() for k, v in out.items()}
            | {f"grad {n}": p.grad.float().cpu() for n, p in model.named_parameters()})


def max_rel_err(got: dict, want: dict) -> tuple[float, str]:
    """The largest relative error over the tensors of ``want`` (see
    ``F32_TOL``), and the tensor's name."""
    floor = 1e-3 * max(float(v.abs().max()) for k, v in want.items() if k.startswith("grad "))
    errs = {k: float((got[k] - w).abs().max()) / max(float(w.abs().max()), floor)
            for k, w in want.items()}
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def card_against_cpu(batch, seed: int) -> dict:
    """The model on the card against the CPU, from one seed's params, on
    ``batch`` (hap1, hap2, n_variants on the card): d_model 64, 2 layers in
    float32 with TF32 off, then the default configuration in bf16 against
    float32 on the CPU."""
    cpu = [t.cpu() for t in batch]
    L = batch[0].shape[1]
    small = HaploFormerConfig(d_model=64, num_layers=2, dtype="float32")
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        f32 = max_rel_err(outputs_and_grads(HaploFormer(small, L, seed, "cuda"), *batch),
                          outputs_and_grads(HaploFormer(small, L, seed, "cpu"), *cpu))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    bf16 = max_rel_err(
        outputs_and_grads(HaploFormer(HaploFormerConfig(), L, seed, "cuda"), *batch),
        outputs_and_grads(HaploFormer(HaploFormerConfig(dtype="float32"), L, seed, "cpu"), *cpu))
    log(f"model card against CPU, B={batch[0].shape[0]} L={L}: d_model 64 x 2 layers "
        f"float32 (TF32 off) largest relative error {f32[0]:.3g} ({f32[1]}), limit {F32_TOL}; "
        f"HaploFormerConfig() bf16 against float32 {bf16[0]:.3g} ({bf16[1]}), limit {BF16_TOL}")
    check(f32[0] <= F32_TOL, f"float32 card against CPU: {f32}")
    check(bf16[0] <= BF16_TOL, f"bf16 card against float32 CPU: {bf16}")
    return {"f32_max_rel_err": f32[0], "bf16_max_rel_err": bf16[0]}


def train_path(seed: int, sampler, cmp: Comparisons) -> dict:
    """Phase 13 on the main process: ``HaploFormerConfig()`` trained on the
    phase-3 sampler by ``N_FUSED`` fused steps (CUDA's sync debug mode
    raising on any host round-trip after the first three) and
    ``train_on_sampler``, with the window kernel's launch count set to 0 just
    before and read just after; the first fused batch against the plain
    version; the model on the card against the CPU; a checkpoint round trip."""
    first = sampler.batch_at(FUSED_STEP0)
    state = create_train_state(HaploFormerConfig(), (first.hap1, first.hap2), seed=seed)
    fused = make_fused_train_step(sampler)
    encode_windows_kernel.launches = draw_windows.launches = 0
    t0 = time.perf_counter()
    metrics = []
    for i in range(N_FUSED):
        torch.cuda.set_sync_debug_mode("error" if i >= 3 else 0)
        state, m = fused(state, FUSED_STEP0 + i)
        metrics.append(m)
    torch.cuda.set_sync_debug_mode(0)
    _, losses = train_on_sampler(sampler, steps=N_TRAIN_ON, log_every=1, seed=seed)
    torch.cuda.synchronize()
    launches, draws = encode_windows_kernel.launches, draw_windows.launches
    n_batches = N_FUSED + 1 + N_TRAIN_ON
    fused_losses = torch.stack([m["loss"] for m in metrics]).tolist()
    log(f"training path: {N_FUSED} fused steps and train_on_sampler({N_TRAIN_ON} steps) in "
        f"{time.perf_counter() - t0:.2f} s; window kernel launches {launches} and draw kernel "
        f"launches {draws} for {n_batches} "
        f"batches; fused losses {[round(x, 4) for x in fused_losses]}; train_on_sampler "
        f"losses {[round(x, 4) for x in losses]}")
    check(launches == n_batches, f"{launches} window kernel launches for {n_batches} batches")
    check(draws == n_batches, f"{draws} draw kernel launches for {n_batches} batches")
    check(all(map(math.isfinite, fused_losses + losses)), "a loss is not finite")
    want = sampler.batch_at(FUSED_STEP0, kernel="baseline")
    cmp.windows(first, want, "first fused step's batch")

    errs = card_against_cpu((first.hap1[:8], first.hap2[:8], first.n_variants[:8]), seed)

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        path = save_checkpoint(state, tmp)
        other = create_train_state(HaploFormerConfig(), (first.hap1, first.hap2), seed=seed + 1)
        back = restore_checkpoint(path, other)
    check(back.step == state.step == N_FUSED, "restored step")
    for a, b in ((state.model.state_dict(), back.model.state_dict()),
                 (state.optimizer.state_dict()["state"], back.optimizer.state_dict()["state"])):
        check(a.keys() == b.keys(), "restored keys")
        for k in a:
            x, y = a[k], b[k]
            same = (all(torch.equal(x[j], y[j]) for j in x) if isinstance(x, dict)
                    else torch.equal(x, y))
            check(same, f"restored {k} differs")
    with torch.no_grad():
        la = loss_fn(state.model, first.hap1, first.hap2, first.n_variants)[0]
        lb = loss_fn(back.model, first.hap1, first.hap2, first.n_variants)[0]
    check(torch.equal(la, lb), "the restored model's loss differs")
    log(f"checkpoint round trip on the card: step {back.step}, model and AdamW state "
        "bit-equal, the next batch's loss bit-equal")
    return {"window_launches": launches, "draw_launches": draws, "batches": n_batches, **errs,
            "fused_losses": [fused_losses[0], fused_losses[-1]], "train_on_sampler_losses": losses}


# ---------------------------------------------------------------------------
# phase 14: the single-pass converter
# ---------------------------------------------------------------------------

#: 1000 Genomes Phase 3 chr22 (ALL.chr22.phase3_shapeit2_mvncall_integrated_v5a):
#: its record count, over GRCh38 chr22's length; donors cut from its 2,504 to
#: 128 (writing the file for 256 took 64.1 s on an H100 host, past the 45 s
#: this phase allows it)
CHR22_LENGTH = 50_818_468
CHR22_RECORDS = 1_103_547
N_COHORT_DONORS = 128
COHORT_CUT = "cut from 2,504, and from 256, whose file took 64.1 s to write, past 45 s"
#: donors of the cohort file also converted one at a time
N_PER_DONOR = 8
#: the file whose framing without a region escapes most records: contigs of
#: 100 Mb with 1,000 records each (gaps past 65,535, a new chrom every 1,000)
N_ESCAPE_CONTIGS, ESCAPE_CONTIG_LENGTH = 200, 100_000_000
SPLIT_STAGES = ("framing", "h2d", "device_decode", "d2h", "struct_assembly")


def _kernel_launches() -> dict:
    return {"vcf_decode12": decode_frames12_kernel.launches,
            "vcf_decode64": decode_frames_kernel.launches,
            "window_kernel": encode_windows_kernel.launches}


def collect_structs(conv, chromosome: int) -> tuple[dict, float, int]:
    """``convert_chromosome`` with a writer that keeps every struct (no
    h5py), every donor succeeding.  Returns the structs, the task's seconds
    (host clock) and its peak device memory above what was allocated."""
    got = {}
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = conv.convert_chromosome(chromosome, writer=lambda d, c, s: got.__setitem__(d, s))
    secs = time.perf_counter() - t0
    bad = [(r.donor_id, r.error) for r in res if r.error is not None]
    check(not bad and len(got) == len(res), f"convert_chromosome({chromosome}): {bad[:3]}")
    return got, secs, torch.cuda.max_memory_allocated() - mem0


def v2_device_decode(fixed, gt, exc_idx, exc_pos, run_counts, run_ids):
    """The converter's device work on an uploaded frame: the per-record
    columns, and the genotype columns of every sample as one transposed
    block (``decode_v2_to_host`` takes one block up to 1 GiB of genotypes)."""
    rec = decode_v2_records(fixed, exc_idx, exc_pos, run_counts, run_ids)
    return rec, decode_v2_genotypes(gt.t().contiguous(), rec["well_formed"][None, :])


def check_v2_decode(frame, dev, what: str) -> None:
    """``decode_frames_v2`` on the card against ``decode_frames_v2_numpy`` on
    the same frame: every column bit-equal, in the JAX package's dtypes."""
    got = decoded_to_numpy(decode_frames_v2(*upload_v2(frame, dev)))
    want = decode_frames_v2_numpy(frame.fixed, frame.gt, frame.exc_idx, frame.exc_pos,
                                  frame.run_counts, frame.run_ids)
    check(list(got) == list(want), f"{what}: columns")
    for k, w in want.items():
        g = got[k]
        check(g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w),
              f"{what}: decode_frames_v2 {k} differs from decode_frames_v2_numpy")


def single_pass_split(path: str, chrom: str, samples: list, dev, threads: int):
    """The single-pass task run stage by stage, each ended by a synchronize
    (host clock, s): framing, h2d, device decode, d2h, struct assembly.
    Returns the stage times, the structs and the frame."""
    t = [time.perf_counter()]
    frame = VCFSource(path, threads).frame_v2(samples, chrom)
    t.append(time.perf_counter())
    tensors = upload_v2(frame, dev)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    rec, gen = v2_device_decode(*tensors)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    host = {k: rec[k].cpu().numpy() for k in V2_RECORD_COLUMNS}
    host["start"], host["stop"] = host["start"].astype(np.uint32), host["stop"].astype(np.uint32)
    host |= {k: gen[k].cpu().numpy().T for k in V2_GENOTYPE_COLUMNS}
    t.append(time.perf_counter())
    structs = snp_structs_from_v2(host, frame.chroms, frame.samples, chrom_filter=chrom)
    t.append(time.perf_counter())
    return dict(zip(SPLIT_STAGES, np.diff(t).tolist())), structs, frame


def v2_decode_times(frame, dev) -> tuple[float, float]:
    """The device decode's ms a call (CUDA events, back to back behind a
    sleep kernel) and its bound: the frame's 5N + NS bytes and side arrays
    read once, the JAX package's output columns written once (17 bytes a
    record, 5 a record and sample), over 3.35 TB/s."""
    tensors = upload_v2(frame, dev)
    ms = device_ms(v2_device_decode, [tensors] * 5)[0]
    n, s = frame.n, frame.n_samples
    read = 5 * n + n * s + 12 * frame.exc_idx.shape[0] + 9 * frame.run_counts.shape[0]
    return ms, (read + 17 * n + 5 * n * s) / HBM_BYTES_PER_S * 1e3


def _timed_file(card: str, what: str, path: str, chrom: str, samples: list, dev, threads: int,
                structs: dict, task_s: float, peak: int, per_donor_s: dict) -> dict:
    """The times of one file: the task, its split and the device decode
    (the split's structs must equal the task's)."""
    split, split_structs, frame = single_pass_split(path, chrom, samples, dev, threads)
    for d in samples[::max(1, len(samples) // N_PER_DONOR)]:
        check(split_structs[d].tobytes() == structs[d].tobytes(), f"{what} split {d}")
    ms, bound = v2_decode_times(frame, dev)
    n, s = frame.n, frame.n_samples
    pd = list(per_donor_s.values())
    out = {"records": n, "donors": s, "task_s": task_s, "records_per_s": n / task_s,
           "donor_records_per_s": n * s / task_s, "peak_decode_mem_gib": peak / 2**30,
           "split_s": split, "decode_device_ms": ms, "decode_bound_ms": bound,
           "per_donor_task_s": {"donors": len(pd), "mean": float(np.mean(pd)),
                                "sum": float(np.sum(pd))}}
    log(f"[{card}] single pass {what}: {n:,} records x {s} donors in {task_s:.3f} s "
        f"(convert_chromosome, host clock): {n / task_s:,.0f} records/s, "
        f"{n * s / task_s:,.0f} donor-records/s; peak device memory of the decode "
        f"{peak / 2**30:.3f} GiB; per-donor task (parse_snps) on {len(pd)} of its donors "
        f"{np.mean(pd):.3f} s each, {np.sum(pd):.3f} s together")
    log(f"[{card}] single pass {what} split (s, each stage to a synchronize): "
        + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    log(f"[{card}] single pass {what}: device decode {ms:.5f} ms a call (CUDA events), bound "
        f"{bound:.5f} ms (bytes, 3.35 TB/s), {bound / ms:.3f} of it")
    return out


def cohort_input(tmp: str, seed: int) -> tuple[str, str, list, str, float]:
    """The chr22 cohort-width file (phases 14, 16 and 17) under ``tmp/cohort``:
    ``(its directory, path, donors, sample-list path, seconds to write)``."""
    cdir = os.path.join(tmp, "cohort")
    os.makedirs(cdir)
    donors = [f"HG{d:05d}" for d in range(N_COHORT_DONORS)]
    donors_path = os.path.join(cdir, "samples.txt")
    with open(donors_path, "w") as f:
        f.write("\n".join(donors) + "\n")
    path22 = os.path.join(cdir, "chr22.filtered.vcf.gz")
    t0 = time.perf_counter()
    kinds = write_cohort_vcf(path22, {"chr22": CHR22_LENGTH}, CHR22_RECORDS, donors, seed + 6)
    write_s = time.perf_counter() - t0
    log(f"cohort-width input: chr22 VCF, {CHR22_RECORDS:,} records over {CHR22_LENGTH:,} bp, "
        f"{N_COHORT_DONORS} donors ({COHORT_CUT}), {os.path.getsize(path22) / 1e6:.1f} MB BGZF; "
        f"records by kind {kinds}; written in {write_s:.1f} s")
    return cdir, path22, donors, donors_path, write_s


def single_pass_phase(card: str, tmp: str, seed: int, dev, ctx: dict) -> dict:
    """Phase 14 (``ctx``: phase 8's files, donors and per-donor structs; the
    cohort file's path and some of its donors' structs are added to it)."""
    threads, samples, chr1 = ctx["threads"], ctx["samples"], ctx["chr1"]
    t_phase = time.perf_counter()
    kw = dict(cores=1, cxx_threads=threads, device=dev)
    conv = VCFtoHDF5Converter("smoke_sp", tmp, os.path.join(tmp, "out_sp"), ctx["samples_path"],
                              chromosomes=[1], **kw)
    host = VCFtoHDF5Converter("smoke_sp", tmp, os.path.join(tmp, "out_sp_host"),
                              ctx["samples_path"], chromosomes=[1], device_decode=False, **kw)
    check(conv.config.single_pass and conv.config.direct_write, "default flags")

    # -- chr1: the single pass against phase 8's per-donor structs
    for fn in (decode_frames12_kernel, decode_frames_kernel, encode_windows_kernel):
        fn.launches = 0
    sp, sp_s, peak = collect_structs(conv, 1)
    launches = _kernel_launches()
    log(f"single pass chr1: convert_chromosome(1) for {len(sp)} donors in {sp_s:.2f} s; "
        f"Hopper kernel launches {launches} (torch ops, no kernel, on this path)")
    check(not any(launches.values()), "the single pass launched a Hopper kernel")
    check(peak > 0, "the single pass decoded nothing on the card")
    hs, host_s, _ = collect_structs(host, 1)
    for d in samples:
        want = ctx["structs"][d]
        check(sp[d].dtype == want.dtype and sp[d].tobytes() == want.tobytes(),
              f"single pass {d}: struct differs from the per-donor parse_snps")
        check(hs[d].tobytes() == want.tobytes(), f"device_decode=False single pass {d}")
    check_v2_decode(VCFSource(chr1, threads).frame_v2(samples, "chr1"), dev, "chr1 frame")
    esc_path = os.path.join(tmp, "escapes.vcf.gz")
    write_cohort_vcf(esc_path, {f"ctg{i:03d}": ESCAPE_CONTIG_LENGTH for i in range(N_ESCAPE_CONTIGS)},
                     N_ESCAPE_CONTIGS * RECORDS_PER_CONTIG, samples, seed + 5)
    esc = VCFSource(esc_path, threads).frame_v2("*")
    check(len(esc.chroms) == N_ESCAPE_CONTIGS and esc.exc_idx.shape[0] > esc.n // 2,
          "escape frame")
    check_v2_decode(esc, dev, f"{N_ESCAPE_CONTIGS}-contig escapes")
    try:
        VCFSource(ctx["ctg_path"], threads).frame_v2(samples)
    except ValueError as exc:
        refused = str(exc)
    else:
        refused = ""
    check("255" in refused, f"frame_v2 of the {N_CONTIGS}-contig file was not refused")
    log(f"single pass checks: {len(samples)} chr1 structs byte-equal to phase 8's per-donor "
        f"structs and to a device_decode=False single pass ({host_s:.2f} s); decode_frames_v2 "
        f"on the card bit-equal to decode_frames_v2_numpy on the chr1 frame and on "
        f"{N_ESCAPE_CONTIGS} contigs ({esc.exc_idx.shape[0]:,} of {esc.n:,} records escaped); "
        f"the {N_CONTIGS}-contig file refused: {refused}")
    out = {"card": card, "chr1": _timed_file(card, "chr1", chr1, "chr1", samples, dev, threads,
                                             sp, sp_s, peak, ctx["task_s"])}

    # -- cohort width: chr22's record count, 128 donors
    cdir, path22, donors, donors_path, write_s = cohort_input(tmp, seed)
    conv22 = VCFtoHDF5Converter("smoke22", cdir, os.path.join(cdir, "out"), donors_path,
                                chromosomes=[22], **kw)
    per22 = VCFtoHDF5Converter("smoke22", cdir, os.path.join(cdir, "out_pd"), donors_path,
                               chromosomes=[22], single_pass=False, **kw)
    sp22, sp22_s, peak22 = collect_structs(conv22, 22)
    pd_s = {}
    for d in donors[::N_COHORT_DONORS // N_PER_DONOR]:
        t0 = time.perf_counter()
        want, n = per22.parse_snps(path22, d, "chr22")
        pd_s[d] = time.perf_counter() - t0
        check(n == CHR22_RECORDS and sp22[d].tobytes() == want.tobytes(),
              f"cohort {d}: single-pass struct differs from the per-donor parse_snps")
        check(0.8 * CHR22_RECORDS < len(want) < CHR22_RECORDS, f"cohort {d}: {len(want)} SNPs")
    log(f"single pass cohort checks: {N_PER_DONOR} of {N_COHORT_DONORS} donors byte-equal to the "
        f"per-donor parse_snps ({len(sp22[donors[0]]):,} SNPs for {donors[0]})")
    out["cohort"] = _timed_file(card, f"chr22 x {N_COHORT_DONORS}", path22, "chr22", donors, dev,
                                threads, sp22, sp22_s, peak22, pd_s)
    out["cohort"]["write_s"] = write_s
    # phase 16 reads the cohort file again, with these donors' structs
    ctx["chr22"] = path22
    ctx["structs22"] = {d: sp22[d] for d in donors[::N_COHORT_DONORS // N_WRITER_DONORS]}
    log(f"single pass phase: {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 15: the reference path
# ---------------------------------------------------------------------------

#: GRCh38 primary-assembly lengths of the FASTA's two records
GRCH38_REF = {"chr1": 248_956_422, "chr22": 50_818_468}
FASTA_LINE = 60
#: about 7% of each record in N runs (a leading 10,000-bp run and one run of
#: several Mb), soft-masked runs of ~300 bp over about half the bases, and
#: one IUPAC code (R, Y, K, M, S, W) in ~50,000 bases, as in UCSC's hg38.fa
N_SHARE, N_LEAD, SOFT_RUN, IUPAC_EVERY = 0.07, 10_000, 300, 50_000
REF_DONORS, REF_BATCHES, PACK_STARTS = 16, 4, 256
#: one ASCII byte read, one code and five one-hot bytes written a base
ENCODE_BYTES_PER_BASE = 7


def reference_bases(n: int, rng) -> np.ndarray:
    """``n`` ASCII bases of one record: random A/C/G/T, soft-masked
    (lowercase) runs, N runs and a sprinkle of IUPAC codes."""
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n, dtype=np.uint8)]
    runs = rng.geometric(1 / SOFT_RUN, size=2 * n // SOFT_RUN + 64)
    seq[np.repeat(np.arange(runs.size) % 2 == 1, runs)[:n]] |= 0x20
    iupac = rng.integers(0, n, n // IUPAC_EVERY)
    seq[iupac] = np.frombuffer(b"RYKMSW", np.uint8)[rng.integers(0, 6, iupac.size)]
    seq[:N_LEAD] = ord("N")
    run = int(n * N_SHARE) - N_LEAD
    at = int(rng.integers(N_LEAD, n - run))
    seq[at:at + run] = ord("N")
    return seq


def write_reference_fasta(path: str, seed: int) -> dict:
    """A FASTA of ``GRCH38_REF``'s records at 60 bases a line.  Returns, by
    record, the bases written and the ``.fai`` fields (length, offset,
    linebases, linewidth) the writer knows."""
    rng = np.random.default_rng(seed)
    out, pos = {}, 0
    with open(path, "wb") as f:
        for name, n in GRCH38_REF.items():
            seq = reference_bases(n, rng)
            header = f">{name}  AC:synthetic  LN:{n}  rl:Chromosome\n".encode()
            full = n // FASTA_LINE
            lines = np.empty((full, FASTA_LINE + 1), np.uint8)
            lines[:, :FASTA_LINE] = seq[: full * FASTA_LINE].reshape(full, FASTA_LINE)
            lines[:, FASTA_LINE] = ord("\n")
            tail = seq[full * FASTA_LINE:].tobytes() + b"\n" if n % FASTA_LINE else b""
            f.write(header)
            f.write(lines.data)
            f.write(tail)
            out[name] = {"seq": seq, "fai": (n, pos + len(header), FASTA_LINE, FASTA_LINE + 1)}
            pos += len(header) + lines.nbytes + len(tail)
    return out


def encode_split(raw: bytes, dev) -> tuple[dict, torch.Tensor]:
    """``encode_onehot_and_codes``'s three steps, each ended by a
    synchronize: h2d and d2h (host clock, s) and the device ops (CUDA
    events, ms; the best of three).  Returns the times and the device
    codes."""
    src = torch.from_numpy(np.frombuffer(raw, np.uint8).copy())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d = src.to(dev)
    torch.cuda.synchronize()
    h2d = time.perf_counter() - t0
    runs = []
    for _ in range(3):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        codes = ascii_to_codes(d)
        onehot = codes_to_onehot(codes)
        b.record()
        b.synchronize()
        runs.append(a.elapsed_time(b))
    t0 = time.perf_counter()
    onehot.cpu(), codes.cpu()
    d2h = time.perf_counter() - t0
    return {"h2d_s": h2d, "device_ms": min(runs), "device_ms_runs": runs, "d2h_s": d2h}, codes


def reference_phase(card: str, tmp: str, seed: int, dev, cmp: Comparisons) -> tuple[dict, int]:
    """Phase 15.  Returns its numbers and the window kernel's launches on it."""
    t_phase = time.perf_counter()
    path = os.path.join(tmp, "GRCh38_chr1_chr22.fa")
    t0 = time.perf_counter()
    truth = write_reference_fasta(path, seed + 7)
    write_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    n1 = GRCH38_REF["chr1"]
    seq1 = truth["chr1"]["seq"]
    log(f"reference input: FASTA of chr1 and chr22 at GRCh38's lengths "
        f"({sum(GRCH38_REF.values()):,} bp), {size / 1e6:.1f} MB, 60 bases a line; chr1 N "
        f"{float(np.mean(seq1 == ord('N'))):.4f}, lowercase {float(np.mean(seq1 >= ord('a'))):.4f}"
        f"; written in {write_s:.1f} s")
    check(write_s < 45, f"the FASTA took {write_s:.1f} s to write, past 45 s")

    # -- index and fetch
    t0 = time.perf_counter()
    recs = build_fai(path)
    fai_s = time.perf_counter() - t0
    for name, t in truth.items():
        r = recs[name]
        got = (r.length, r.offset, r.linebases, r.linewidth)
        check(got == t["fai"], f"build_fai {name}: {got} != the writer's {t['fai']}")
    n_lines = sum(-(-n // FASTA_LINE) + 1 for n in GRCH38_REF.values())
    t0 = time.perf_counter()
    with FastaReader(path) as fa:
        check(isinstance(fa._impl, FaidxFasta), "FastaReader did not take the fresh .fai")
        raw = fa.fetch("chr1")
    fetch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with NativeFasta(path) as nf:
        native_raw = nf.fetch("chr1", 0, n1)
    native_s = time.perf_counter() - t0
    check(raw == native_raw, "FaidxFasta and NativeFasta fetched different chr1 bytes")
    check(raw == seq1.tobytes(), "the fetched chr1 differs from the bases written")
    del native_raw, truth, seq1
    log(f"[{card}] reference index and fetch: build_fai {fai_s:.2f} s for {n_lines:,} lines "
        f"(records equal the writer's); chr1 fetch by FaidxFasta {fetch_s:.3f} s, by "
        f"NativeFasta (whole-file read + fetch) {native_s:.3f} s (host clock), byte-equal")

    # -- encode chr1 on the card against encode_host
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    onehot, codes = encode_onehot_and_codes(raw, device=dev)
    e2e_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - mem0
    t0 = time.perf_counter()
    want_oh, want_codes = encode_host(np.frombuffer(raw, np.uint8))
    host_s = time.perf_counter() - t0
    check(onehot.shape == (n1, 5) and onehot.dtype == np.uint8, "one-hot shape/dtype")
    check(codes.shape == (n1,) and codes.dtype == np.int8, "codes shape/dtype")
    check(np.array_equal(codes, want_codes), "the card's codes differ from encode_host's")
    check(np.array_equal(onehot, want_oh), "the card's one-hot differs from encode_host's")
    del onehot, want_oh, want_codes
    split, codes_dev = encode_split(raw, dev)
    check(np.array_equal(codes_dev.cpu().numpy(), codes), "the split's codes")
    bound_ms = ENCODE_BYTES_PER_BASE * n1 / HBM_BYTES_PER_S * 1e3
    log(f"[{card}] reference encode, chr1 {n1:,} bases: encode_onehot_and_codes "
        f"{e2e_s:.3f} s end to end, encode_host (numpy) {host_s:.3f} s (host clock), "
        f"bit-equal; split: h2d {split['h2d_s']:.4f} s, device ops {split['device_ms']:.4f} ms "
        f"(CUDA events, best of {', '.join(f'{m:.4f}' for m in split['device_ms_runs'])}) "
        f"against a bound of {bound_ms:.4f} ms (7 bytes a base at 3.35 TB/s), d2h "
        f"{split['d2h_s']:.4f} s; peak device memory {peak / 2**30:.3f} GiB")

    # -- genome to sampler
    t0 = time.perf_counter()
    genome = GenomeTensors.from_fasta(path)
    from_fasta_s = time.perf_counter() - t0
    check(genome.chrom_names == list(GRCH38_REF), "from_fasta records")
    check(np.array_equal(genome.codes_flat[:n1], codes), "from_fasta's chr1 codes != the card's")
    flat = torch.from_numpy(genome.codes_flat).to(dev)
    lengths = genome.lengths.astype(np.int64)
    cohort = make_cohort(flat, genome.offsets.astype(np.int64), lengths, genome.chrom_names,
                         REF_DONORS, torch.Generator(device=dev).manual_seed(seed + 8))
    regions = make_regions(lengths, N_REGIONS, seed + 8)
    genome = GenomeTensors(genome.chrom_names, flat, genome.offsets, genome.lengths)
    sampler = DeviceHaplotypeSampler(genome, cohort, regions,
                                     SamplerConfig(seq_length=SEQ_LENGTH, batch_size=BATCH),
                                     device=dev)
    encode_windows_kernel.launches = draw_windows.launches = 0
    batches = [sampler.sample() for _ in range(REF_BATCHES)]
    torch.cuda.synchronize()
    launches, draws = encode_windows_kernel.launches, draw_windows.launches
    check(launches == REF_BATCHES, f"window kernel launches {launches} != {REF_BATCHES}")
    check(draws == REF_BATCHES, f"draw kernel launches {draws} != {REF_BATCHES}")
    n_var = 0
    for step, b in enumerate(batches):
        want = sampler.batch_at(step, kernel="baseline")
        cmp.windows(b, want, f"reference sampler step {step}")
        n_var += int(b.n_variants.sum())
    check(n_var > 0, "the reference sampler's windows hold no variants")
    log(f"reference sampler: GenomeTensors.from_fasta {from_fasta_s:.2f} s (chr1 codes equal "
        f"the card's); {REF_DONORS} donors, {int(cohort.counts.sum()):,} SNVs, {N_REGIONS:,} "
        f"regions; {REF_BATCHES} sample() batches at B={BATCH}, L={SEQ_LENGTH}: {launches} "
        f"window-kernel launches, each batch bit-equal to the plain version ({n_var:,} "
        f"in-window SNVs)")
    del sampler, batches, cohort, flat, genome

    # -- codecs
    pack_runs = []
    for _ in range(3):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        packed, mask = pack_2bit_device(codes_dev)
        b.record()
        b.synchronize()
        pack_runs.append(a.elapsed_time(b))
    np_packed, np_mask, _ = pack_2bit(codes)
    check(np.array_equal(packed.cpu().numpy(), np_packed)
          and np.array_equal(mask.cpu().numpy(), np_mask), "pack_2bit_device != pack_2bit")
    check(torch.equal(unpack_2bit_device(packed, mask)[:n1], codes_dev), "2-bit round trip")
    gen = torch.Generator(device=dev).manual_seed(seed + 9)
    n_windows = 0
    for L in (1000, 1002):
        s = torch.randint(0, n1 - L + 1, (PACK_STARTS,), generator=gen, device=dev)
        s = torch.cat([s, torch.tensor([0, 3, n1 - L], device=dev)])
        got = gather_window_2bit(packed, mask, s, L=L)
        check(torch.equal(got, codes_dev.unfold(0, L, 1)[s]), f"gather_window_2bit L={L}")
        n_windows += s.numel()
    log(f"[{card}] reference codecs: pack_2bit_device on chr1 "
        f"{', '.join(f'{m:.4f}' for m in pack_runs)} ms (CUDA events, three calls), "
        f"{packed.numel() + mask.numel():,} bytes, equal to numpy pack_2bit, round "
        f"trip bit-equal; gather_window_2bit at {n_windows} windows (L 1000 and 1002, starts 0, "
        f"3 and G - L among them) equal to the codes' slices")
    del packed, mask, codes_dev

    # -- doctor and dataset
    checks = run_checks()
    for name, ok, detail in checks:
        log(f"  doctor {'✓' if ok else '✗'} {name:16s} {detail}")
    # the HDF5 checks pass only where h5py and libblosc.so.1 are installed
    hdf5 = ("h5py/HDF5", "blosc filter")
    bad = [name for name, ok, _ in checks if not ok and name not in hdf5]
    check(not bad, f"doctor checks failed: {bad}")
    if importlib.util.find_spec("h5py") is None:
        log("RandomHaplotypeDataset: not run: it reads HDF5 files and h5py is not installed "
            "on this machine (tests/test_torch_dataset.py holds it against the JAX package)")
    phase_s = time.perf_counter() - t_phase
    log(f"reference phase: {phase_s:.1f} s")
    return {"card": card, "fasta_mb": size / 1e6, "write_s": write_s, "build_fai_s": fai_s,
            "fai_lines": n_lines, "bases": n1, "fetch_s": fetch_s, "native_fetch_s": native_s,
            "encode_s": e2e_s, "encode_host_s": host_s, **split, "bound_ms": bound_ms,
            "peak_mem_gib": peak / 2**30, "from_fasta_s": from_fasta_s,
            "window_launches": launches, "draw_launches": draws, "pack_ms_runs": pack_runs,
            "phase_s": phase_s}, launches


# ---------------------------------------------------------------------------
# phase 16: the tokenizer route and the host I/O surface
# ---------------------------------------------------------------------------

#: lines of each file tokenized on the CPU against the card
CPU_LINES = 200_000
#: the cohort file's region read through its .tbi (0-based, half-open)
REGION22 = ("chr22", 20_000_000, 30_000_000)
#: chunks a streaming read is cut into, at least
MIN_CHUNKS = 8
#: the cohort file's first records, and its donors, written back through the writers
WRITER_RECORDS, N_WRITER_DONORS = 100_000, 4
#: bytes a line of the tokenizer's output columns (15 columns), and of its line index
TOKEN_OUT_BYTES, TOKEN_IN_BYTES = 31, 8
TOKEN_STAGES = ("vcf_text", "h2d", "device_ops", "d2h", "struct_assembly")


def check_columns(got: dict, want: dict, what: str) -> None:
    """Every tokenizer column of ``got`` bit-equal to ``want``'s."""
    check(sorted(got) == sorted(want), f"{what}: columns")
    for k, w in want.items():
        g = got[k]
        check(g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w),
              f"{what}: {k} differs")


def token_bound_ms(n: int, W: int) -> float:
    """The tokenizer's byte bound: each line's 2W window bytes and its line
    index read once, its 31 bytes of columns written once, at 3.35 TB/s."""
    return n * (2 * W + TOKEN_IN_BYTES + TOKEN_OUT_BYTES) / HBM_BYTES_PER_S * 1e3


def token_on_cpu(vt, card: dict, donor: str, what: str) -> int:
    """``CPU_LINES`` lines from the middle of ``vt`` tokenized on the CPU from
    a slice of the text that starts on a row of W and runs to the last
    line's second row, so every window holds the bytes the card's did; each
    column bit-equal to the card's whole-file rows."""
    n, W = vt.n_lines, choose_window(int(vt.line_lengths.max()))
    i0 = n // 3
    i1 = min(n, i0 + CPU_LINES)
    offs = vt.line_offsets[i0:i1]
    base = int(offs[0]) // W * W
    stop = min(vt.text.shape[0], (int(offs[-1]) // W + 2) * W)
    sub = np.zeros((-(-(stop - base) // W) + 1) * W, np.uint8)
    sub[: stop - base] = vt.text[base:stop]
    cols = tokenize_lines(torch.from_numpy(sub), torch.from_numpy((offs - base).astype(np.int32)),
                          torch.from_numpy(vt.line_lengths[i0:i1].copy()), W=W,
                          sample_col=sample_column(vt.samples, donor), with_sample=True)
    check_columns({k: v.numpy() for k, v in cols.items()},
                  {k: v[i0:i1] for k, v in card.items()}, f"{what}: the card against the CPU")
    return i1 - i0


#: the stages of ``tokenize_lines``, each a few torch ops
TOKEN_DEVICE_STAGES = ("line_windows", "tab_counts", "tab_columns", "line_fields")


def token_stage_ms(text, offs, lens, W: int, col: int, step: int) -> dict:
    """The device ms of each stage of ``tokenize_lines`` over every chunk of
    ``step`` lines (CUDA events between the stages; a stage's time includes
    any gap while the host issues its ops)."""
    ms = dict.fromkeys(TOKEN_DEVICE_STAGES, 0.0)
    tabs = tabs_needed(col)
    for lo in range(0, offs.shape[0], step):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        win, shift, end = line_windows(text, offs[lo:lo + step], lens[lo:lo + step], W)
        ev[1].record()
        counts = tab_counts(win, shift, end)
        ev[2].record()
        tab = tab_columns(counts, tabs)
        ev[3].record()
        line_fields(win, shift, end, tab, col)
        ev[4].record()
        ev[4].synchronize()
        for k, a, b in zip(TOKEN_DEVICE_STAGES, ev, ev[1:]):
            ms[k] += a.elapsed_time(b)
    return ms


def token_split(path: str, chrom: str, donor: str, dev, threads: int) -> tuple[dict, dict]:
    """``tokenize_vcf_device``'s task stage by stage, each ended by a
    synchronize (host clock, s), then the device ops alone three more times
    (CUDA events, ms).  Returns the times and the struct."""
    t = [time.perf_counter()]
    with native.vcf_text(path, threads) as vt:
        t.append(time.perf_counter())
        n, W = vt.n_lines, choose_window(int(vt.line_lengths.max()))
        text = upload_text(vt.text, W, dev)
        offs = torch.from_numpy(vt.line_offsets.astype(np.int32)).to(dev)
        lens = torch.from_numpy(vt.line_lengths.copy()).to(dev)
        col = sample_column(vt.samples, donor)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    step = default_chunk_lines(W)

    def run():
        return [tokenize_lines(text, offs[lo:lo + step], lens[lo:lo + step], W=W,
                               sample_col=col, with_sample=True) for lo in range(0, n, step)]

    chunks = run()
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    dec = decoded_to_host(chunks)
    t.append(time.perf_counter())
    struct = snp_struct_from_decoded(dec, dec["chrom"], chrom_filter=chrom)
    t.append(time.perf_counter())
    runs = []
    for _ in range(3):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        run()
        b.record()
        b.synchronize()
        runs.append(a.elapsed_time(b))
    bound = token_bound_ms(n, W)
    return {"records": n, "W": W, "split_s": dict(zip(TOKEN_STAGES, np.diff(t).tolist())),
            "device_ms": min(runs), "device_ms_runs": runs, "bound_ms": bound,
            "stage_ms": token_stage_ms(text, offs, lens, W, col, step)}, struct


def tokenizer_task(path: str, chrom: str, donor: str, dev, threads: int) -> np.ndarray:
    """The tokenizer's per-donor task: read, tokenize on the card, assemble."""
    with native.vcf_text(path, threads) as vt:
        dec = tokenize_vcf_device(vt, donor, device=dev)
    return snp_struct_from_decoded(dec, dec["chrom"], chrom_filter=chrom)


def whole_file_on_card(path: str, donors: list, want: dict, chrom: str, dev, threads: int,
                       what: str) -> tuple[dict, dict]:
    """``tokenize_vcf_device`` on the card for ``donors``: each struct
    byte-equal to ``want[donor]``, the last donor's columns held against the
    CPU.  Returns the last donor's columns and the numbers."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with native.vcf_text(path, threads) as vt:
        W = choose_window(int(vt.line_lengths.max()))
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for i, donor in enumerate(donors):
            dec = tokenize_vcf_device(vt, donor, device=dev)
            if i == 0:
                peak = torch.cuda.max_memory_allocated() - mem0
            check(not dec["long_line"].any(), f"{what}: a line past the window")
            got = snp_struct_from_decoded(dec, dec["chrom"], chrom_filter=chrom)
            check(got.dtype == want[donor].dtype and got.tobytes() == want[donor].tobytes(),
                  f"{what} {donor}: the tokenizer's struct differs")
        n_cpu = token_on_cpu(vt, dec, donors[-1], what)
        out = {"records": vt.n_lines, "W": W, "text_bytes": int(vt.text.shape[0]),
               "peak_mem_gib": peak / 2**30, "cpu_lines": n_cpu}
    return dec, out


def streaming_reads(card: str, path: str, donor: str, whole: dict, dev, threads: int,
                    what: str, region=None) -> dict:
    """``tokenize_vcf_streaming`` on the card, cut into at least
    ``MIN_CHUNKS`` chunks: every column bit-equal to the whole-file rows of
    the lines it read.  Returns its wall time and its stats."""
    with native.BgzfRangeReader(path) as reader:
        total = reader.total_usize
    chunk_bytes = total // (10 * MIN_CHUNKS if region else MIN_CHUNKS + 2)
    st = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = tokenize_vcf_streaming(path, donor, threads, chunk_bytes=chunk_bytes,
                                 region=region, device=dev, stats=st)
    wall = time.perf_counter() - t0
    check(st["chunks"] >= MIN_CHUNKS, f"{what}: {st['chunks']} chunks")
    n = got["start"].shape[0]
    if region is None:
        check_columns(got, whole, f"{what}: streaming against the whole file")
        j = 0
    else:
        # the lines read start at the .tbi's seek: find them in the whole file
        cands = np.flatnonzero(whole["start"] == got["start"][0])
        j = next((int(c) for c in cands if all(
            np.array_equal(got[k], whole[k][c:c + n]) for k in whole)), None)
        check(j is not None, f"{what}: the region read matches no run of the whole file")
        check_columns(got, {k: v[j:j + n] for k, v in whole.items()}, what)
        beg, end = region[1], region[2]
        inside = np.flatnonzero((whole["start"] >= beg) & (whole["start"] < end))
        check(n < whole["start"].shape[0] and j <= inside[0] and inside[-1] < j + n,
              f"{what}: the read does not cover the region")
    out = {"chunk_bytes": chunk_bytes, "records": n, "first_row": j, "wall_s": wall, **st}
    log(f"[{card}] tokenizer streaming {what}: {n:,} records in {st['chunks']} chunks of "
        f"{chunk_bytes / 2**20:.1f} MiB at W={st['W']}, {wall:.3f} s (host clock to the host "
        f"columns); the loop's host time {st['host_s']:.3f} s, the device's {st['device_ms']:.2f} "
        f"ms (CUDA events, each chunk's copy to its last op), sum {st['host_s'] + st['device_ms'] / 1e3:.3f} s; "
        "every column bit-equal to the whole-file tokenizer's")
    return out


def writer_round_trip(tmp: str, path22: str, want: dict, threads: int, dev) -> dict:
    """The cohort file's first ``WRITER_RECORDS`` records, cut to the donors of
    ``want``, as plain text (the source) and through ``VcfWriter`` (``z``) and
    ``BcfWriter`` (``b``); each read back, its structs byte-equal to the
    source's and those to the head of ``want[donor]`` (phase 14's structs)."""
    donors = list(want)
    with native.vcf_text(path22, threads) as vt:
        head = int(vt.line_offsets[0])
        stop = int(vt.line_offsets[WRITER_RECORDS - 1] + vt.line_lengths[WRITER_RECORDS - 1])
        header = VcfHeader.from_text(vt.text[:head].tobytes().decode())
        keep = [9 + vt.samples.index(d) for d in donors]
        rows = vt.text[head:stop].tobytes().split(b"\n")
    header.set_samples(donors)
    lines = ["\t".join(f[i].decode() for i in list(range(9)) + keep)
             for f in (r.split(b"\t") for r in rows)]
    src = os.path.join(tmp, "writer_source.vcf")
    with open(src, "w") as f:
        f.write(header.as_string() + "\n".join(lines) + "\n")
    times, paths = {}, {"z": os.path.join(tmp, "written.vcf.gz"),
                        "b": os.path.join(tmp, "written.bcf")}
    for mode, cls in (("z", VcfWriter), ("b", BcfWriter)):
        t0 = time.perf_counter()
        with cls(paths[mode], header=header, mode=mode) as w:
            for line in lines:
                w.write_line(line)
        times[mode] = time.perf_counter() - t0
    check(is_bcf(paths["b"]) and not is_bcf(paths["z"]), "the writers' formats")
    conv = VCFtoHDF5Converter("smoke_wr", tmp, os.path.join(tmp, "out_wr"),
                              os.path.join(tmp, "samples.txt"), cores=1, cxx_threads=threads,
                              single_pass=False, device=dev)
    n_snps = 0
    for d in donors:
        source, n = conv.parse_snps(src, d, "chr22")
        check(n == WRITER_RECORDS, f"writer source {d}: {n} records")
        check(source.tobytes() == want[d][: len(source)].tobytes(),
              f"writer source {d}: not the head of phase 14's struct")
        for mode in ("z", "b"):
            got, _ = conv.parse_snps(paths[mode], d, "chr22")
            check(got.tobytes() == source.tobytes(), f"VcfWriter({mode!r}) {d}: struct differs")
        cols = bcf_decoded_columns(paths["b"], d, threads=threads)
        got = snp_struct_from_decoded(cols, cols["chrom"], chrom_filter="chr22")
        check(got.tobytes() == source.tobytes(), f"bcf_decoded_columns {d}: struct differs")
        n_snps += len(source)
    sizes = {m: os.path.getsize(p) for m, p in paths.items()}
    log(f"writers: the first {WRITER_RECORDS:,} chr22 records for {len(donors)} donors through "
        f"VcfWriter('z') {times['z']:.2f} s ({sizes['z'] / 1e6:.2f} MB) and BcfWriter('b') "
        f"{times['b']:.2f} s ({sizes['b'] / 1e6:.2f} MB); read back through parse_snps and "
        f"bcf_decoded_columns, {n_snps:,} SNP rows byte-equal to the source's")
    return {"records": WRITER_RECORDS, "donors": len(donors), "vcf_z_s": times["z"],
            "bcf_b_s": times["b"], "bytes": sizes}


def tokenizer_phase(card: str, tmp: str, dev, ctx: dict) -> dict:
    """Phase 16 (``ctx``: phase 8's files, donors and structs; phase 14's
    cohort file and some of its donors' structs)."""
    t_phase = time.perf_counter()
    threads, samples, chr1, chr22 = ctx["threads"], ctx["samples"], ctx["chr1"], ctx["chr22"]
    out = {"card": card}

    # -- the whole-file route: chr1's 8 donors against phase 8's frame12 structs
    whole1, out["chr1"] = whole_file_on_card(chr1, samples, ctx["structs"], "chr1", dev, threads,
                                             "chr1")
    donors22 = list(ctx["structs22"])
    whole22, out["chr22"] = whole_file_on_card(chr22, donors22, ctx["structs22"], "chr22", dev,
                                               threads, "chr22")
    log(f"tokenizer checks: tokenize_vcf_device on the card, chr1's {len(samples)} structs "
        f"byte-equal to phase 8's frame12 structs and chr22's {len(donors22)} to phase 14's; "
        f"{out['chr1']['cpu_lines']:,} + {out['chr22']['cpu_lines']:,} lines bit-equal to the "
        f"CPU's, every column")

    # -- the streaming route, whole and by region, against the whole file
    out["stream_chr1"] = streaming_reads(card, chr1, samples[-1], whole1, dev, threads, "chr1")
    out["stream_chr22"] = streaming_reads(card, chr22, donors22[-1], whole22, dev, threads,
                                          "chr22")
    t0 = time.perf_counter()
    build_index(chr22)
    out["build_index_s"] = time.perf_counter() - t0
    out["stream_region"] = streaming_reads(card, chr22, donors22[-1], whole22, dev, threads,
                                           f"chr22 region {REGION22}", region=REGION22)

    # -- the converter's tokenizer branch on the 300-contig file
    kw = dict(cores=1, cxx_threads=threads, chromosomes=[1], single_pass=False, device=dev)
    tok = VCFtoHDF5Converter("smoke_tok", tmp, os.path.join(tmp, "out_tok"), ctx["samples_path"],
                             use_tokenizer=True, **kw)
    ref64 = VCFtoHDF5Converter("smoke_tok", tmp, os.path.join(tmp, "out_64"),
                               ctx["samples_path"], **kw)
    for fn in (decode_frames12_kernel, decode_frames_kernel, encode_windows_kernel):
        fn.launches = 0
    branch = {d: tok.parse_snps(ctx["ctg_path"], d, None) for d in samples[:2]}
    torch.cuda.synchronize()
    launches = _kernel_launches()
    check(not any(launches.values()), f"the tokenizer branch launched {launches}")
    for d, (s, n) in branch.items():
        want, wn = ref64.parse_snps(ctx["ctg_path"], d, None)
        check(n == wn and s.tobytes() == want.tobytes(),
              f"tokenizer branch {d}: struct differs from the 64-byte route's")
    log(f"converter tokenizer branch: parse_snps(use_tokenizer=True) on the {N_CONTIGS}-contig "
        f"file for {len(branch)} donors byte-equal to the 64-byte route "
        f"({len(branch[samples[0]][0]):,} SNPs for {samples[0]}); kernel launches {launches}")
    out["branch_launches"] = launches

    # -- the writers, and the variant table
    out["writers"] = writer_round_trip(tmp, chr22, ctx["structs22"], threads, dev)
    t0 = time.perf_counter()
    table = VariantTable.from_vcf(chr22)
    out["variant_table_s"] = time.perf_counter() - t0
    check(table.n == whole22["start"].shape[0], "VariantTable records")
    check(np.array_equal(table.is_snp(), whole22["snp_mask"])
          and np.array_equal(table.start, whole22["start"]),
          "VariantTable's SNP mask or start differs from the tokenizer's")
    log(f"[{card}] VariantTable.from_vcf on chr22: {table.n:,} records in "
        f"{out['variant_table_s']:.2f} s; is_snp ({int(table.is_snp().sum()):,}) and start equal "
        "to the tokenizer's snp_mask and start")
    del table, whole1, whole22

    # -- times: the tokenizer's task against frame12's on one donor, in turns
    donor = samples[0]
    tasks = {"tokenizer": [], "frame12": []}
    for _ in range(2):
        t0 = time.perf_counter()
        got = tokenizer_task(chr1, "chr1", donor, dev, threads)
        tasks["tokenizer"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        want, _ = ref64.parse_snps(chr1, donor, "chr1")
        tasks["frame12"].append(time.perf_counter() - t0)
        check(got.tobytes() == want.tobytes(), "timed tokenizer task")
    n1 = out["chr1"]["records"]
    out["task_s"] = tasks
    out["records_per_s"] = {k: n1 / min(v) for k, v in tasks.items()}
    log(f"[{card}] tokenizer task on chr1 for {donor} (vcf_text + tokenize_vcf_device + struct): "
        f"{', '.join(f'{x:.3f}' for x in tasks['tokenizer'])} s, "
        f"{out['records_per_s']['tokenizer']:,.0f} records/s; the frame12 task (parse_snps) "
        f"{', '.join(f'{x:.3f}' for x in tasks['frame12'])} s, "
        f"{out['records_per_s']['frame12']:,.0f} records/s (host clock, in turns)")
    for what, path, chrom, d in (("chr1", chr1, "chr1", donor),
                                 ("chr22", chr22, "chr22", donors22[0])):
        split, struct = token_split(path, chrom, d, dev, threads)
        want = ctx["structs"][d] if what == "chr1" else ctx["structs22"][d]
        check(struct.tobytes() == want.tobytes(), f"{what} split: struct differs")
        out[what] |= split
        log(f"[{card}] tokenizer split {what} ({split['records']:,} records, W={split['W']}; s, "
            "each stage to a synchronize): "
            + ", ".join(f"{k} {v:.4f}" for k, v in split["split_s"].items())
            + f"; device ops {split['device_ms']:.3f} ms (CUDA events, best of "
            f"{', '.join(f'{m:.3f}' for m in split['device_ms_runs'])}) against a bound of "
            f"{split['bound_ms']:.4f} ms (N x (2W + 39) bytes at 3.35 TB/s), "
            f"{split['bound_ms'] / split['device_ms']:.3f} of it; by stage (ms, CUDA events) "
            + ", ".join(f"{k} {v:.3f}" for k, v in split["stage_ms"].items())
            + f"; peak device memory {out[what]['peak_mem_gib']:.3f} GiB")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"tokenizer phase: {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 17: the parallel path at world size 1
# ---------------------------------------------------------------------------

#: train steps held bit-equal to the unsharded step; then each step's timed
#: steps (after 3 warm-up steps) in turns, unsharded, sharded, sharded,
#: unsharded, N_PAR_TURNS times; train_on_sampler's steps
N_PAR_CHECK, N_PAR_TIMED, N_PAR_TURNS, N_PAR_TRAIN_ON = 5, 20, 4, 3
#: phase 17's convert_sharded may take this long on chr22 x 128 before the
#: donors are cut (to 32)
PAR_CONVERT_LIMIT_S = 120


def _states_equal(a, b) -> bool:
    """Parameters and AdamW slots of two train states bit-equal."""
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    return (all(torch.equal(x, y) for x, y in zip(a.model.parameters(), b.model.parameters()))
            and all(torch.equal(sa[i][k], sb[i][k]) for i in sa for k in sa[i]))


def parallel_train(card: str, seed: int, sampler, mesh) -> dict:
    """``make_train_step(mesh)`` against ``make_train_step()`` from one seed
    on the same sampler batches: losses, parameters and AdamW slots bit-equal
    after each step; then their ms a step (CUDA events) in turns, unsharded,
    sharded, sharded, unsharded (``N_PAR_TURNS`` times), after which the two
    states must still be bit-equal; then ``train_on_sampler(mesh=...)`` with
    the window kernel's launches counted.  A ``torch.profiler`` trace of
    each step (device busy, device ops a step) follows the timing."""
    cfg = HaploFormerConfig()
    batches = [sampler.sample() for _ in range(N_PAR_CHECK + 3 + N_PAR_TIMED)]
    first = batches[0]
    kw = dict(seed=seed, device=sampler.device)
    st = {"unsharded": create_train_state(cfg, (first.hap1, first.hap2), **kw),
          "sharded": create_train_state(cfg, (first.hap1, first.hap2), mesh=mesh, **kw)}
    steps = {"unsharded": make_train_step(), "sharded": make_train_step(mesh)}
    losses = []
    for i, b in enumerate(batches[:N_PAR_CHECK]):
        out = {k: steps[k](st[k], b.hap1, b.hap2, b.n_variants) for k in st}
        st = {k: v[0] for k, v in out.items()}
        m_ref, m_par = out["unsharded"][1], out["sharded"][1]
        check(all(torch.equal(m_ref[k], m_par[k]) for k in m_ref), f"step {i}: metrics differ")
        check(_states_equal(st["unsharded"], st["sharded"]), f"step {i}: a parameter or slot differs")
        losses.append(m_par["loss"].item())
    timed = batches[N_PAR_CHECK:]

    def runner(key):
        def run(i):
            b = timed[i % len(timed)]
            st[key] = steps[key](st[key], b.hap1, b.hap2, b.n_variants)[0]
        return run

    ms = {"unsharded": [], "sharded": []}
    for key in ("unsharded", "sharded", "sharded", "unsharded") * N_PAR_TURNS:
        ms[key].append(step_times(runner(key), 3, N_PAR_TIMED)[0])
    # then a profiler trace of each (after the timing: a session slows the
    # launch path after it), on the same batches
    traces = {}
    for key in ("unsharded", "sharded"):
        calls = iter(range(6))
        text, traces[key] = trace_calls(lambda: runner(key)(next(calls)), 5,
                                        f"{key} train step at world size 1", top=8)
        log(f"[{card}] {text}")
    check(_states_equal(st["unsharded"], st["sharded"]), "after the timed steps: states differ")
    log(f"parallel train step at world size 1 (NCCL), HaploFormerConfig() B={BATCH} "
        f"L={SEQ_LENGTH}: {N_PAR_CHECK} steps bit-equal to make_train_step() (losses "
        f"{[round(x, 4) for x in losses]}; every parameter and AdamW slot), and again after "
        f"{4 * N_PAR_TURNS * (3 + N_PAR_TIMED) + 12} timed and traced steps")
    med = {k: float(np.median(v)) for k, v in ms.items()}
    log(f"[{card}] train step at world size 1 (CUDA events, {N_PAR_TIMED} steps a run, in "
        f"turns): sharded median {med['sharded']:.4f} ms (" + ", ".join(
            f"{x:.4f}" for x in ms["sharded"]) + f"), unsharded median {med['unsharded']:.4f} "
        "ms (" + ", ".join(f"{x:.4f}" for x in ms["unsharded"]) + ")")
    del st, batches, timed

    encode_windows_kernel.launches = draw_windows.launches = 0
    _, tos_losses = train_on_sampler(sampler, steps=N_PAR_TRAIN_ON, log_every=1, seed=seed,
                                     mesh=mesh)
    torch.cuda.synchronize()
    launches, draws = encode_windows_kernel.launches, draw_windows.launches
    check(launches == N_PAR_TRAIN_ON + 1, f"train_on_sampler(mesh): {launches} window launches")
    check(draws == N_PAR_TRAIN_ON + 1, f"train_on_sampler(mesh): {draws} draw launches")
    check(all(map(math.isfinite, losses + tos_losses)), "a loss is not finite")
    log(f"train_on_sampler(mesh=..., steps={N_PAR_TRAIN_ON}): losses "
        f"{[round(x, 4) for x in tos_losses]}; window kernel launches {launches}, draw kernel "
        f"launches {draws}")
    return {"checked_steps": N_PAR_CHECK, "losses": losses, "ms_step_sharded": ms["sharded"],
            "ms_step_unsharded": ms["unsharded"], "trace": traces,
            "train_on_sampler_losses": tos_losses, "window_launches": launches,
            "draw_launches": draws}


def parallel_decode(card: str, chr1: str, donor: str, mesh, dev) -> dict:
    """``sharded_decode_frames`` on one donor's chr1 64-byte frames, with the
    decode64 kernel's launches counted, against the unsharded kernel call and
    the plain version on the same frames."""
    frames = VCFSource(chr1, os.cpu_count()).frame(donor, "chr1").records
    decode_frames_kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec = sharded_decode_frames(frames, mesh)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = decode_frames_kernel.launches
    check(launches == 1, f"sharded_decode_frames: {launches} decode64 launches")
    f64 = torch.from_numpy(frames).to(dev)
    err = 0
    for what, want in (("the unsharded kernel call", unpack64_decoded(*decode_frames_kernel(f64))),
                       ("the plain version", decode_frames(f64))):
        for name in dec._fields:
            g, w = getattr(dec, name), getattr(want, name)
            check(g.shape == w.shape == (frames.shape[0],), f"decode {name} shape")
            d = int((g.long() - w.long()).abs().max())
            err = max(err, d)
            check(d == 0, f"sharded_decode_frames {name} differs from {what} (max |d| {d})")
    log(f"[{card}] sharded_decode_frames on {frames.shape[0]:,} chr1 frames of {donor}: "
        f"{secs:.4f} s (h2d and decode, host clock); decode64 launches {launches}; every "
        "column bit-equal to the unsharded kernel call and to the plain version")
    return {"records": frames.shape[0], "s": secs, "decode64_launches": launches,
            "max_abs_err": err}


def parallel_genome(card: str, genome, mesh, seed: int) -> dict:
    """``ShardedGenome.from_codes`` of the deployment genome from the host
    (halo L), and ``sharded_window_gather`` of B windows, one past the end."""
    flat = genome.codes_flat
    codes = flat.cpu().numpy()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    sg = ShardedGenome.from_codes(codes, mesh, halo=SEQ_LENGTH)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    mem = (torch.cuda.memory_allocated() - mem0) / 2**30
    total = codes.shape[0]
    check(sg.chunk_local.shape == (sg.chunk + SEQ_LENGTH,) and torch.equal(sg.chunk_local[:total], flat)
          and bool((sg.chunk_local[total:] == N_CODE).all()), "the shard's chunk and halo")
    rng = np.random.default_rng(seed + 17)
    starts = np.append(rng.integers(0, total - SEQ_LENGTH, BATCH - 1), sg.chunk + 5)
    t0 = time.perf_counter()
    win = sharded_window_gather(sg, starts, SEQ_LENGTH)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    gather_ms, gather_host_ms = step_times(
        lambda i: sharded_window_gather(sg, starts, SEQ_LENGTH), 3, 20)
    st = torch.from_numpy(starts[:-1]).to(flat.device)
    want = flat[st[:, None] + torch.arange(SEQ_LENGTH, device=flat.device)]
    check(win.shape == (BATCH, SEQ_LENGTH) and torch.equal(win[:-1], want), "windows differ")
    check(not bool(win[-1].any()), "a start past the last shard must give zeros")
    try:
        sharded_window_gather(sg, starts, SEQ_LENGTH + 1)
    except ValueError:
        pass
    else:
        check(False, "a window past the halo was not refused")
    log(f"[{card}] ShardedGenome.from_codes of {total:,} codes (host numpy, halo {SEQ_LENGTH}): "
        f"{upload_s:.4f} s, {mem:.3f} GiB more on the card; sharded_window_gather of "
        f"({BATCH}, {SEQ_LENGTH}) windows: the first call {first_ms:.3f} ms (host clock), then "
        f"{gather_ms:.4f} ms a call (CUDA events, 20 calls), {gather_host_ms:.4f} ms (host "
        "clock); equal to the codes' slices, zeros past the last shard, L > halo refused")
    return {"codes": total, "upload_s": upload_s, "shard_gib": mem, "first_gather_ms": first_ms,
            "gather_ms": gather_ms, "gather_host_ms": gather_host_ms}


def parallel_convert(card: str, tmp: str, dev, mesh) -> dict:
    """``convert_sharded(device_decode=True)`` on phase 14's chr22 file
    against ``CohortTensors.from_structs`` of the single pass's structs
    (``convert_chromosome``), with its file passes counted."""
    cdir = os.path.join(tmp, "cohort")
    path22 = os.path.join(cdir, "chr22.filtered.vcf.gz")
    with open(os.path.join(cdir, "samples.txt")) as f:
        donors = [line.strip() for line in f if line.strip()]
    threads = os.cpu_count()
    conv = VCFtoHDF5Converter("smoke22", cdir, os.path.join(cdir, "out_par"),
                              os.path.join(cdir, "samples.txt"), cores=1, cxx_threads=threads,
                              chromosomes=[22], device=dev)
    structs, task_s, _ = collect_structs(conv, 22)
    want = CohortTensors.from_structs({(d, "chr22"): s for d, s in structs.items()},
                                      donors, ["chr22"])
    # convert_sharded's stacking of the structs into (T, V) columns, alone
    t0 = time.perf_counter()
    _structs_to_task_tensors([structs[d] for d in donors], want.max_variants)
    stack_s = time.perf_counter() - t0
    del structs
    hostio_vcf.FRAME_COUNTS.clear()
    t0 = time.perf_counter()
    got = convert_sharded({"chr22": path22}, donors, ["chr22"], mesh, threads=threads,
                          host_workers=1, device_decode=True)
    secs = time.perf_counter() - t0
    check(secs <= PAR_CONVERT_LIMIT_S, f"convert_sharded took {secs:.1f} s: cut the donors")
    passes = hostio_vcf.FRAME_COUNTS[path22]
    check(passes == 1, f"convert_sharded framed the file {passes} times")
    for k in ("pos", "ref_code", "alt_code", "phase1", "phase2", "counts"):
        g, w = getattr(got, k), getattr(want, k)
        check(g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes(),
              f"convert_sharded {k} differs from from_structs of the single pass")
    log(f"[{card}] convert_sharded(device_decode=True) on chr22 x {len(donors)} donors: "
        f"{secs:.3f} s, {passes} file pass; every column byte-equal to from_structs of "
        f"convert_chromosome's structs ({task_s:.3f} s); V {got.pos.shape[2]:,}; its "
        f"_structs_to_task_tensors alone on those structs {stack_s:.3f} s")
    return {"donors": len(donors), "s": secs, "passes": passes,
            "single_pass_task_s": task_s, "stack_s": stack_s}


def parallel_phase(seed: int, tmp: str) -> dict:
    """Phase 17 (``--parallel DIR``, in a process of its own; ``DIR`` holds
    phase 7's and phase 14's files): NCCL with one rank through
    ``make_mesh(MeshConfig(1, 1))`` on the deployment state of ``--seed``."""
    t_phase = time.perf_counter()
    dev, card = torch.device("cuda"), card_line()
    mesh = make_mesh(MeshConfig(1, 1))
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1, "an NCCL group of one")
    genome, cohort, regions = make_state(seed, dev)
    sampler = DeviceHaplotypeSampler(genome, cohort, regions,
                                     SamplerConfig(seq_length=SEQ_LENGTH, batch_size=BATCH))
    out = {"card": card, "backend": dist.get_backend(), "world_size": dist.get_world_size()}
    out["train"] = parallel_train(card, seed, sampler, mesh)
    with open(os.path.join(tmp, "samples.txt")) as f:
        donor = f.readline().strip()
    out["decode"] = parallel_decode(card, os.path.join(tmp, "chr1.filtered.vcf.gz"), donor,
                                    mesh, dev)
    out["genome"] = parallel_genome(card, genome, mesh, seed)
    counts = cohort.counts
    check(torch.equal(all_gather_cohort(counts, mesh), counts), "all_gather_cohort of the counts")
    total = psum_counts(counts, mesh)
    check(total.shape == (1,) and int(total) == int(counts.sum()), "psum_counts of the counts")
    log(f"all_gather_cohort and psum_counts on the cohort's {tuple(counts.shape)} counts: "
        f"equal to the counts and to their sum ({int(total):,})")
    del sampler, genome, cohort
    torch.cuda.empty_cache()
    out["convert"] = parallel_convert(card, tmp, dev, mesh)
    dist.destroy_process_group()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"parallel phase: {out['phase_s']:.1f} s")
    return out


def run_parallel(seed: int, tmp: str) -> dict:
    """``parallel_phase`` in a child process; its log lines are relayed."""
    torch.cuda.empty_cache()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--parallel", tmp, "--seed", str(seed)],
        capture_output=True, text=True, timeout=600,
    )
    lines = proc.stdout.splitlines()
    for line in lines[:-1]:
        log(line)
    check(proc.returncode == 0 and lines,
          f"--parallel exited {proc.returncode}: {proc.stderr[-3000:]}")
    return json.loads(lines[-1])


# ---------------------------------------------------------------------------
# phase 18: sample_chain, one CUDA graph over the window kernel
# ---------------------------------------------------------------------------

#: the chain checked against the eager plain chain; the one-hot chain; the
#: JAX bench's chain (bench.py:1256), which the benchmark's chain cell runs;
#: window-kernel launches checked at its links' B=16,384
CHAIN_CHECK, CHAIN_ONEHOT, CHAIN_BENCH = (3, 4), (2, 2), (16, 256)
N_LINK_CHECKED = 2


def host_digest(batch) -> int:
    """The JAX package's chain digest of a batch, computed in numpy on the
    host (``chain_digest``'s yardstick on the card)."""
    leaves = {name: getattr(batch, name).cpu().numpy().astype(np.int64)
              for name in HaplotypeBatch._fields}
    d = (int(leaves["hap1_codes"].sum()) & 1) ^ ((int(leaves["hap2_codes"].sum()) & 1) << 1)
    d ^= int(leaves["n_variants"].sum()) & 0xFFFFFFFF
    if leaves["hap1"].ndim > leaves["hap1_codes"].ndim:
        d ^= ((int(leaves["hap1"].sum()) & 1) << 2) ^ ((int(leaves["hap2"].sum()) & 1) << 3)
    return d


def chain_phase(card: str, seed: int, genome, cohort, regions, sampler,
                cmp: Comparisons) -> tuple[dict, int]:
    """Phase 18 on the phase-3 sampler.  Returns what its checks saw and the
    window kernel's launches on the chain's own run."""
    out: dict = {"card": card}
    key = seed + 18
    n_chain, n_batches = CHAIN_CHECK
    want = sampler.chain_run(n_chain, n_batches, key=key, kernel="baseline")
    sampler.sample_chain(n_chain, n_batches, key=key)  # warm-up and capture

    # the chain's run: every launch counted, no host round-trip before the fetch
    step0 = sampler._step
    encode_windows_kernel.launches = draw_windows.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    got = sampler.chain_run(n_chain, n_batches, key=key)
    keyless = [sampler.sample_chain(n_chain, n_batches) for _ in range(2)]
    same = [sampler.sample_chain(n_chain, n_batches, key=key + 1) for _ in range(2)]
    torch.cuda.set_sync_debug_mode(0)
    launches, draws = encode_windows_kernel.launches, draw_windows.launches
    check(launches == 5 * n_chain, f"5 chains of {n_chain} links launched the window kernel "
                                   f"{launches} times")
    check(draws == 5 * n_chain, f"5 chains of {n_chain} links launched the draw kernel "
                                f"{draws} times")
    check(int(got.digest) == int(want.digest),
          f"chain digest {int(got.digest)} differs from the eager plain chain's {int(want.digest)}")
    check(torch.equal(got.keys, want.keys), "a link's key differs from the eager plain chain's")
    check(got.keys[0].tolist() == list(prng_key(key)), "link 0's key is not PRNGKey(key)")
    flat = HaplotypeWindows(*(t.reshape(-1, *t.shape[2:]) for t in got.last[2:]))
    cmp.windows(flat, HaplotypeWindows(*(t.reshape(-1, *t.shape[2:]) for t in want.last[2:])),
                f"sample_chain{CHAIN_CHECK} last link")
    check(int(chain_digest(got.last)) == host_digest(got.last),
          "chain_digest on the card differs from the host's digest of the same windows")
    check(sampler._step == step0 + 2 * n_chain * n_batches, "a key-less chain kept the step")
    check(int(keyless[0]) != int(keyless[1]), "two key-less chains gave one digest")
    check(int(same[0]) == int(same[1]), "two chains of one key gave two digests")
    # a link's draws from the last key on the card, with its digest, against the CPU's
    args = draw_args(sampler)
    last_key, digest = got.keys[-1], chain_digest(got.last)
    on_card = draw_windows(last_key, 0, CHAIN_BENCH[1], BATCH, *args, digest=digest)
    on_cpu = draws_plain(last_key.cpu(), 0, CHAIN_BENCH[1], BATCH,
                         *(t.cpu() for t in args[:2]), *args[2:], digest=digest.cpu())
    check(all(torch.equal(a.cpu(), b) for a, b in zip(on_card, on_cpu)),
          "the chain's draws on the card differ from the CPU's")
    out |= {"digest": int(got.digest), "launches": launches, "draw_launches": draws,
            "draws_checked": on_cpu.start.numel()}

    # the one-hot chain, on a sampler of its own over the same state
    onehot = DeviceHaplotypeSampler(genome, cohort, regions, sampler.config, emit_onehot=True)
    a = onehot.chain_run(*CHAIN_ONEHOT, key=key, kernel="baseline")
    b = onehot.chain_run(*CHAIN_ONEHOT, key=key)
    b = onehot.chain_run(*CHAIN_ONEHOT, key=key)  # a replay of the cached graph
    check(int(a.digest) == int(b.digest) and torch.equal(a.keys, b.keys),
          "emit_onehot: the graph's chain differs from the eager plain chain")
    check(torch.equal(a.last.hap1, b.last.hap1), "emit_onehot: one-hot windows differ")
    check(int(chain_digest(b.last)) == host_digest(b.last),
          "emit_onehot: chain_digest on the card differs from the host's")
    del onehot, a, b
    log(f"chain checks: sample_chain{CHAIN_CHECK} bit-equal to the eager plain chain (digest "
        f"{out['digest']}, {n_chain} keys, the last link's {n_batches * BATCH} windows), "
        f"{launches} window and {draws} draw launches for 5 calls under sync debug mode "
        f"'error'; key-less calls advance the step; {out['draws_checked']:,} lanes of a "
        f"link's draws from the card's last key equal to the CPU's; "
        f"emit_onehot {CHAIN_ONEHOT} equal")

    # the JAX bench's chain against the eager plain chain, and the window
    # kernel at its links' B against the plain version
    n_chain, n_batches = CHAIN_BENCH
    want = sampler.chain_run(n_chain, n_batches, key=key, kernel="baseline")
    got = sampler.chain_run(n_chain, n_batches, key=key)
    check(int(got.digest) == int(want.digest) and torch.equal(got.keys, want.keys),
          f"sample_chain{CHAIN_BENCH}: the graph's chain differs from the eager plain chain")
    flat = HaplotypeWindows(*(t.reshape(-1, *t.shape[2:]) for t in got.last[2:]))
    cmp.windows(flat, HaplotypeWindows(*(t.reshape(-1, *t.shape[2:]) for t in want.last[2:])),
                f"sample_chain{CHAIN_BENCH} last link")
    for i in range(N_LINK_CHECKED):
        d = draw_windows(prng_key(key + 300 + i), 0, n_batches, BATCH, *args)
        cmp.encode(sampler.index, d.donor_idx, d.chrom_idx, d.start, SEQ_LENGTH, K_MAX,
                   f"window kernel at B={n_batches * BATCH}, batch {i}")
    out["bench_shape_checked"] = {"digest": int(got.digest), "links": n_chain,
                                  "windows": flat.hap1.shape[0], "kernel_batches": N_LINK_CHECKED}
    log(f"chain checks at sample_chain{CHAIN_BENCH}: the graph's chain equal to the eager plain "
        f"chain (digest {int(got.digest)}, {n_chain} keys, the last link's "
        f"{n_batches * BATCH} windows) and {N_LINK_CHECKED} window kernel launches at "
        f"B={n_batches * BATCH} equal to the plain version")
    return out, launches


# ---------------------------------------------------------------------------
# phase 20: Enformer's conv-block kernels, batch norm and GELU
# ---------------------------------------------------------------------------

#: sequences through the trunk in the benchmark's Enformer cell (2 pairs)
BN_N = 4
#: the float32 shapes: the widest block, a middle one, the final block
BN_F32_SHAPES = 3


def conv_block_shapes(cfg: EnformerConfig, n: int) -> list[tuple[int, int, int]]:
    """The input shape of each of Enformer's conv blocks, in the order the
    forward runs them: the stem's pointwise block, each tower stage's two,
    the final block."""
    L = cfg.sequence_length
    shapes = [(n, cfg.channels // 2, L)]
    c_in = cfg.channels // 2
    for f in cfg.filter_list:
        L //= 2
        shapes += [(n, c_in, L), (n, f, L)]
        c_in = f
    return shapes + [(n, cfg.channels, cfg.target_length)]


def bn_inputs(shape, dtype, gen) -> dict:
    """x off zero mean and unit variance per channel, dz, the parameters and
    moving statistics off their initial values."""
    N, C, L = shape
    dev = gen.device

    def rnd(*s):
        return torch.randn(s, generator=gen, device=dev)

    x = (rnd(N, C, L) * (1 + rnd(C, 1).abs()) + rnd(C, 1)).to(dtype)
    return {"x": x, "dz": rnd(N, C, L).to(dtype), "scale": 1 + 0.1 * rnd(C),
            "bias": 0.1 * rnd(C), "mean": 0.1 * rnd(C), "var": 1 + 0.1 * rnd(C).abs()}


def bn_times(inp: dict) -> dict:
    """Device ms of a forward and of a backward (CUDA events, 10 calls
    each): the kernels, the plain version, and ``F.batch_norm`` with the
    GELU's three ops in bf16 (the library yardstick)."""
    def library(x, scale, bias, mean, var, training, momentum, eps):
        return gelu(torch.nn.functional.batch_norm(x, mean, var, scale, bias, training,
                                                   momentum, eps))

    out = {}
    for name, fn in (("kernel", batchnorm_gelu), ("plain", batchnorm_gelu_plain),
                     ("library", library)):
        x = inp["x"].detach().requires_grad_()
        scale, bias = (inp[k].detach().requires_grad_() for k in ("scale", "bias"))
        mean, var = inp["mean"].clone(), inp["var"].clone()
        args = (x, scale, bias, mean, var, True, BN_MOMENTUM, BN_EPS)
        fn(*args)  # warm-up
        fwd = device_ms(fn, [args] * 10)[0]
        z = fn(*args)
        bwd = device_ms(lambda: torch.autograd.grad(z, (x, scale, bias), inp["dz"],
                                                    retain_graph=True), [()] * 10)[0]
        out[name] = {"forward_ms": fwd, "backward_ms": bwd}
        del z
        torch.cuda.empty_cache()
    n = inp["x"].numel() * inp["x"].element_size()
    out["bound"] = {"forward_ms": 3 * n / HBM_BYTES_PER_S * 1e3,
                    "backward_ms": 5 * n / HBM_BYTES_PER_S * 1e3}
    return out


def bn_step(seed: int) -> dict:
    """The main path: one bf16 training-mode forward and backward of
    ``Enformer(EnformerConfig())`` on the benchmark cell's ``BN_N // 2``
    window pairs, the counters reset to 0 just before it.  Each conv block
    calls the kernels once forward and once backward (3 + 3 launches), and
    no op dispatched in the step is a batch norm; the one ``sigmoid`` is the
    head's GELU."""
    cfg = EnformerConfig()
    model = Enformer(cfg, seed=seed, device="cuda").train()
    blocks = sum(isinstance(m, ConvBlock) for m in model.modules())
    check(blocks == 2 + 2 * cfg.tower_stages, f"{blocks} conv blocks")
    gen = torch.Generator(device="cuda").manual_seed(seed + 21)
    h1, h2 = (torch.randint(0, 5, (BN_N // 2, cfg.sequence_length), generator=gen,
                            device="cuda").to(torch.int8) for _ in range(2))
    seen: dict = {}

    class Names(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            seen[name] = seen.get(name, 0) + 1
            return func(*args, **(kwargs or {}))

    batchnorm_gelu.launches = batchnorm_gelu.forward_calls = batchnorm_gelu.backward_calls = 0
    t0 = time.perf_counter()
    with Names():
        model(h1, h2, generator=gen)["rates"].mean().backward()
    torch.cuda.synchronize()
    out = {"blocks": blocks, "launches": batchnorm_gelu.launches,
           "forward_calls": batchnorm_gelu.forward_calls,
           "backward_calls": batchnorm_gelu.backward_calls,
           "batch_norm_ops": sum(n for k, n in seen.items() if "batch_norm" in k),
           "sigmoid_ops": seen.get("sigmoid", 0)}
    log(f"batchnorm_gelu: a train-mode step of Enformer(EnformerConfig()) at {BN_N} sequences "
        f"in {time.perf_counter() - t0:.1f} s: {out}")
    check(out["forward_calls"] == out["backward_calls"] == blocks,
          f"{out['forward_calls']} forward and {out['backward_calls']} backward calls for "
          f"{blocks} conv blocks")
    check(out["launches"] == 6 * blocks, f"{out['launches']} launches for {blocks} conv blocks")
    check(out["batch_norm_ops"] == 0, f"{out['batch_norm_ops']} batch_norm ops dispatched")
    check(out["sigmoid_ops"] == 1, f"{out['sigmoid_ops']} sigmoid ops, not the head's one")
    del model
    torch.cuda.empty_cache()
    return out


def batchnorm_gelu_phase(card: str, seed: int) -> dict:
    """Phase 20.  Returns the main path's step, the comparisons, their worst
    gaps, times and launches."""
    dev = torch.device("cuda")
    step = bn_step(seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 20)
    shapes = conv_block_shapes(EnformerConfig(), BN_N)
    picked = (0, len(shapes) // 2, len(shapes) - 1)
    cases = [(s, torch.bfloat16) for s in shapes]
    cases += [(shapes[i], torch.float32) for i in picked[:BN_F32_SHAPES]]
    batchnorm_gelu.launches = batchnorm_gelu.forward_calls = batchnorm_gelu.backward_calls = 0
    worst: dict = {}
    t0 = time.perf_counter()
    for shape, dtype in cases:
        inp = bn_inputs(shape, dtype, gen)
        for k, v in bn_compare(inp, True, f"batchnorm_gelu {shape} {dtype}").items():
            worst[k] = max(worst.get(k, 0.0), v)
        del inp
        torch.cuda.empty_cache()
    eval_gaps = bn_compare(bn_inputs(shapes[-1], torch.bfloat16, gen), False,
                           f"batchnorm_gelu eval {shapes[-1]}")
    n_cmp = len(cases) + 1
    launches = batchnorm_gelu.launches
    # a comparison runs the kernels twice: 2 x (3 + 3) launches in training, 2 x (2 + 3) in eval
    check(launches == 12 * len(cases) + 10, f"{launches} batchnorm_gelu launches")
    check(batchnorm_gelu.forward_calls == batchnorm_gelu.backward_calls == 2 * n_cmp,
          "one backward call a forward call")
    log(f"batchnorm_gelu: {n_cmp} comparisons ({len(shapes)} block shapes in bf16, "
        f"{BN_F32_SHAPES} in float32, one in eval mode) in {time.perf_counter() - t0:.1f} s, "
        f"{launches} launches; worst gaps {worst}, eval {eval_gaps}")
    inp = bn_inputs(shapes[0], torch.bfloat16, gen)
    times = bn_times(inp)
    log(f"batchnorm_gelu at {shapes[0]} bf16 ({card}): {times}")
    return {"step": step, "comparisons": n_cmp, "launches": launches, "worst": worst,
            "eval": eval_gaps, "shape": list(shapes[0]), "times": times}


def granite_main_step(seed: int) -> dict:
    """The main path of phases 21 and 22: one bf16 forward and backward of
    ``GraniteHybrid(GraniteHybridConfig())`` on the benchmark cell's one
    window pair of ``GRANITE_L`` bases, the scan's and the norms' counters
    reset to 0 just before it (``tools/granite_step_check.py``), and no op's
    output as large as the step's logits.  Returns the reading without its
    dispatch counts, but for ``pow`` and ``rsqrt``."""
    t0 = time.perf_counter()
    step = granite_step(seed)
    check_granite_step(step)
    check(step["largest_numel"] < step["logits_numel"], f"a tensor of "
          f"{step['largest_numel']} elements, the step's logits {step['logits_numel']}")
    ops = step.pop("ops")
    step.update(pow_ops=ops.get("pow", 0), rsqrt_ops=ops.get("rsqrt", 0))
    log(f"a step of GraniteHybrid(GraniteHybridConfig()) on 1 window pair of {GRANITE_L} bp "
        f"in {time.perf_counter() - t0:.1f} s: {step}")
    return step


def ssd_scan_phase(card: str, seed: int, step: dict | None = None) -> dict:
    """Phase 21.  Returns the main path's step (``step``, else one run
    here), the comparisons' gaps, their launches and the times at the cell's
    shape."""
    dev = torch.device("cuda")
    step = step or granite_main_step(seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 21)
    ssd_scan.launches = ssd_scan.forward_calls = ssd_scan.backward_calls = 0
    t0 = time.perf_counter()
    gaps = {}
    for shape in (CELL_SHAPE, (3, 768, 5, 24, 40)):
        gaps[str(shape)] = ssd_compare(ssd_inputs(shape, gen, dev))
        torch.cuda.empty_cache()
    # a comparison runs the kernels twice
    check(ssd_scan.forward_calls == ssd_scan.backward_calls == 4,
          f"{ssd_scan.forward_calls} forward and {ssd_scan.backward_calls} backward calls")
    launches = ssd_scan.launches
    check(launches == 4 * (3 + 5), f"{launches} ssd_scan launches")
    log(f"ssd_scan: 2 shapes in {time.perf_counter() - t0:.1f} s, {launches} launches; "
        f"gaps {gaps}")
    inp = ssd_inputs(CELL_SHAPE, gen, dev)
    times = {}
    # the plain version one call each: its backward launches ~480 kernels (a
    # loop over the 32 chunks), so three overflow the card's queue of pending
    # launches and the host falls behind device_ms's sleep
    for name, fn, wide, n in (("kernel", ssd_scan, None, 10),
                              ("plain", ssd_scan_plain, torch.float32, 1)):
        cast = (lambda t: t.to(wide)) if wide is not None else (lambda t: t)
        args = [cast(inp[k]).detach().requires_grad_() for k in ("x", "dt", "A", "B", "C", "D")]
        dy = cast(inp["dy"])
        y = fn(*args, 256)
        torch.autograd.grad(y, args, dy)  # warm-up
        fwd = device_ms(lambda: fn(*args, 256), [()] * n)[0]
        y = fn(*args, 256)
        bwd = device_ms(lambda: torch.autograd.grad(y, args, dy, retain_graph=True),
                        [()] * n)[0]
        times[name] = {"forward_ms": fwd, "backward_ms": bwd}
        del y, args
        torch.cuda.empty_cache()
    log(f"ssd_scan at {CELL_SHAPE} ({card}): {times} (the kernel times include the "
        f"torch.bmm products)")
    return {"step": step, "comparisons": len(gaps), "gaps": gaps, "launches": launches,
            "times": times}


# ---------------------------------------------------------------------------
# phase 22: the norms' kernels

#: (rows, width, gated, the width of the tensor the gate is a view of) of
#: phase 22's comparisons and times: the Granite cell's plain and gated norms
RMS_CASES = ((ROWS, HIDDEN, False, None), (ROWS, MIXER, True, IN_PROJ))


def rms_times(inp: dict) -> dict:
    """Device ms of a forward and of a backward (CUDA events, 10 calls
    each): the kernels, the plain version, and ``F.rms_norm`` in bf16 (after
    the gate's ``silu`` and product in bf16 where there is a gate) as the
    library yardstick, beside the byte bound: each input read once and each
    output written once (2 and 3 passes of the element size plain, 3 and 5
    gated)."""
    def library(x, weight, eps, gate=None):
        u = x if gate is None else x * torch.nn.functional.silu(gate)
        return torch.nn.functional.rms_norm(u, (x.shape[-1],), weight.to(x.dtype), eps)

    gated = "gate" in inp
    out = {}
    for name, fn in (("kernel", rms_norm), ("plain", rms_norm_plain), ("library", library)):
        x, weight = (inp[k].detach().requires_grad_() for k in ("x", "weight"))
        gate = inp["gate"].detach().requires_grad_() if gated else None
        leaves = (x, weight) if gate is None else (x, weight, gate)
        args = (x, weight, RMS_EPS, gate)
        fn(*args)  # warm-up
        fwd = device_ms(fn, [args] * 10)[0]
        y = fn(*args)
        bwd = device_ms(lambda: torch.autograd.grad(y, leaves, inp["dout"], retain_graph=True),
                        [()] * 10)[0]
        out[name] = {"forward_ms": fwd, "backward_ms": bwd}
        del y
        torch.cuda.empty_cache()
    n = inp["x"].numel() * inp["x"].element_size()
    out["bound"] = {"forward_ms": (3 if gated else 2) * n / HBM_BYTES_PER_S * 1e3,
                    "backward_ms": (5 if gated else 3) * n / HBM_BYTES_PER_S * 1e3}
    out["bound_share"] = {k: out["bound"][k] / out["kernel"][k] for k in out["bound"]}
    return out


def rms_norm_phase(card: str, seed: int, step: dict | None = None) -> dict:
    """Phase 22.  Returns the main path's step (``step``, else one run
    here), the comparisons' worst gaps, their launches and the times at the
    cell's two shapes."""
    step = step or granite_main_step(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 22)
    rms_norm.launches = rms_norm.forward_calls = rms_norm.backward_calls = 0
    t0 = time.perf_counter()
    gaps = {}
    for rows, width, gated, gate_from in RMS_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            what = f"({rows}, {width}) {'gated' if gated else 'plain'} {dtype}"
            gaps[what] = rms_compare(rms_inputs(rows, width, gated, dtype, gen, gate_from), what)
            torch.cuda.empty_cache()
    # a comparison runs the kernels twice: 2 x (1 + 2) launches
    launches = rms_norm.launches
    check(rms_norm.forward_calls == rms_norm.backward_calls == 2 * len(gaps),
          f"{rms_norm.forward_calls} forward and {rms_norm.backward_calls} backward calls")
    check(launches == 6 * len(gaps), f"{launches} rms_norm launches")
    log(f"rms_norm: {len(gaps)} comparisons in {time.perf_counter() - t0:.1f} s, {launches} "
        f"launches; gaps {gaps}")
    times = {}
    for rows, width, gated, gate_from in RMS_CASES:
        what = f"({rows}, {width}) {'gated' if gated else 'plain'}"
        times[what] = rms_times(rms_inputs(rows, width, gated, torch.bfloat16, gen, gate_from))
        log(f"rms_norm at {what} bf16 ({card}): {times[what]}")
    return {"step": step, "comparisons": len(gaps), "gaps": gaps, "launches": launches,
            "times": times}


# ---------------------------------------------------------------------------
# phase 23: the Nemotron-H hybrid

#: (rows, width, gated, the width of the tensor the gate is a view of, the
#: group) of phase 23's norm comparisons: the Nemotron-H cell's plain and
#: grouped gated norms
NEMOTRON_RMS_CASES = ((NEMOTRON_ROWS, NEMOTRON_HIDDEN, False, None, None),
                      (NEMOTRON_ROWS, MIXER, True, NEMOTRON_IN_PROJ, NEMOTRON_GROUP))


def nemotron_phase(card: str, seed: int) -> dict:
    """Phase 23.  Returns the main path's step, the comparisons' gaps and the
    held experts' products' time."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    step = nemotron_step(seed)
    check_nemotron_step(step)
    log(f"a step of NemotronH(NemotronHConfig()) on 2 window pairs of 8192 bp in "
        f"{time.perf_counter() - t0:.1f} s: {step}")
    gen = torch.Generator(device=dev).manual_seed(seed + 23)
    ssd_scan.launches = ssd_scan.forward_calls = ssd_scan.backward_calls = 0
    gaps = {}
    for shape in (NEMOTRON_SHAPE, (3, 640, 6, 24, 40, 3)):
        gaps[f"ssd {shape}"] = ssd_compare(ssd_inputs(shape, gen, dev), NEMOTRON_CHUNK)
        torch.cuda.empty_cache()
    check(ssd_scan.forward_calls == ssd_scan.backward_calls == 4 and ssd_scan.launches == 32,
          f"{ssd_scan.forward_calls} forward and {ssd_scan.backward_calls} backward calls, "
          f"{ssd_scan.launches} launches")
    for rows, width, gated, gate_from, group in NEMOTRON_RMS_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            what = f"rms_norm ({rows}, {width}) group {group} {dtype}"
            gaps[what] = rms_compare(rms_inputs(rows, width, gated, dtype, gen, gate_from), what,
                                     group)
            torch.cuda.empty_cache()
    moe = moe_compare(seed + 1)
    gaps["moe"] = moe["gaps"]
    log(f"nemotron: {len(gaps)} comparisons in {time.perf_counter() - t0:.1f} s; gaps {gaps}; "
        f"the MoE layer's counters {moe['counters']}")
    times = experts_times(seed + 2, device_ms)
    log(f"the held experts' grouped products at 32768 tokens, 16 of 128 experts ({card}): "
        f"{times}")
    return {"step": step, "comparisons": len(gaps), "gaps": gaps,
            "moe_counters": moe["counters"], "experts_times": times}


# ---------------------------------------------------------------------------

#: the kernels line's times of the window and draw kernels, which the
#: benchmark measures (``portbench/run.py``: ``link_roofline.chain``,
#: ``window_roofline.enformer`` and each cell's device-op breakdown)
UNTIMED = {"ms": None, "plain_ms": None, "bound_ms": None, "bound_by": None, "library_ms": None}
#: the phases ``--phase`` runs alone
PHASES = ("single_pass", "tokenizer", "reference", "parallel", "long_windows", "batchnorm_gelu",
          "ssd_scan", "rms_norm", "nemotron")


def run_phase(name: str, seed: int) -> dict:
    """``--phase name``: that phase alone, after the set-up it needs (its
    kernels build at first use).  Returns its JSON line's object."""
    card, dev = card_line(), torch.device("cuda")
    if name == "batchnorm_gelu":
        return {"batchnorm_gelu": batchnorm_gelu_phase(card, seed)}
    if name == "ssd_scan":
        return {"ssd_scan": ssd_scan_phase(card, seed)}
    if name == "rms_norm":
        return {"rms_norm": rms_norm_phase(card, seed)}
    if name == "nemotron":
        return {"nemotron": nemotron_phase(card, seed)}
    if name == "long_windows":
        genome, cohort, regions = make_state(seed, dev)
        sampler = DeviceHaplotypeSampler(genome, cohort, regions,
                                         SamplerConfig(seq_length=SEQ_LENGTH, batch_size=BATCH))
        cmp = Comparisons()
        long = long_windows_phase(seed, genome, cohort, regions, sampler, cmp)
        return {"long_windows": long, "max_abs_err": cmp.max_abs_err}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        if name == "reference":
            cmp = Comparisons()
            reference = reference_phase(card, tmp, seed, dev, cmp)[0]
            return {"reference": reference, "comparisons": cmp.count,
                    "max_abs_err": cmp.max_abs_err}
        if name == "parallel":
            make_converter_input(tmp, seed)
            cohort_input(tmp, seed)
            return {"parallel": run_parallel(seed, tmp)}
        ctx = converter_main_path(tmp, seed, dev, DecodeComparisons())
        out = {"single_pass": single_pass_phase(card, tmp, seed, dev, ctx)}
        if name == "tokenizer":
            torch.cuda.empty_cache()
            out["tokenizer"] = tokenizer_phase(card, tmp, dev, ctx)
        return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phase", choices=PHASES,
                    help="run this phase alone, with the set-up it needs, and print its "
                         "JSON line")
    ap.add_argument("--parallel", metavar="DIR",
                    help="phase 17's child process: run it on the files phases 7 and 14 "
                         "wrote under DIR and print its numbers as one JSON line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    if args.parallel:
        print(json.dumps(parallel_phase(args.seed, args.parallel)), flush=True)
        return 0
    if args.phase:
        print(json.dumps(run_phase(args.phase, args.seed)), flush=True)
        return 0
    dev = torch.device("cuda")
    cmp = Comparisons()

    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_kernels()
    log(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        if name == "window_kernel_lab":
            continue
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas {name}: {line.strip()}")
    for inst, (used, spill) in lab_ptxas(logs["window_kernel_lab"]).items():
        w = int(inst.rsplit("_w", 1)[1])
        log(f"  ptxas window_kernel_lab {inst}: {used}; dynamic shared memory "
            f"{lab_smem_bytes(w, SEQ_LENGTH)} B at L={SEQ_LENGTH}, {lab_smem_bytes(w, 4080)} B "
            f"at L=4080; {spill}")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # -- 2. state -----------------------------------------------------------
    t0 = time.perf_counter()
    genome, cohort, regions = make_state(args.seed, dev)
    torch.cuda.synchronize()
    D, C, V = cohort.pos.shape
    log(f"state: genome {genome.codes_flat.numel():,} codes over {C} chromosomes; "
        f"cohort D={D} C={C} V={V:,} ({int(cohort.counts.sum()):,} SNVs); "
        f"{len(regions):,} regions; made in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the device")
    log("reduced: sampler none (full GRCh38 chr1-chr12 lengths, 128 donors, "
        "100,000 regions, L=1000, B=64, K=128); converter 8 samples instead of the "
        "2,504 of 1000 Genomes Phase 3 (records and chr1 length in full); single-pass "
        f"cohort file {N_COHORT_DONORS} donors ({COHORT_CUT}; chr22's records and length "
        "in full)")

    # -- 3. main path -------------------------------------------------------
    cfg = SamplerConfig(seq_length=SEQ_LENGTH, batch_size=BATCH)
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    sampler = DeviceHaplotypeSampler(genome, cohort, regions, cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    encode_windows_kernel.launches = draw_windows.launches = 0
    torch.cuda.set_sync_debug_mode("error")  # no host round-trip while sampling
    singles = [sampler.sample() for _ in range(3)]
    many = sampler.sample_many(16)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    main_launches, main_draws = encode_windows_kernel.launches, draw_windows.launches
    first = sampler.index.first
    index_bytes = sampler.index.sub12.nbytes + first.nbytes
    log(f"main path: sampler construction (index build) {t1 - t0:.3f} s, "
        f"{(torch.cuda.memory_allocated() - mem0) / 2**30:.3f} GiB more allocated "
        f"(index {index_bytes / 2**30:.3f} GiB: sub12 {sampler.index.sub12.nbytes / 2**30:.3f}, "
        f"bucket table first "
        f"{tuple(first.shape)} at BK={BK} {first.nbytes / 2**30:.3f} GiB); "
        f"3 x sample() + sample_many(16) "
        f"{time.perf_counter() - t1:.3f} s; window kernel launches {main_launches}, draw "
        f"kernel launches {main_draws}; "
        f"device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    check(sampler.kernel == "kernel", "auto must pick the kernel on CUDA")
    check(main_launches > 0, "the main path never launched the window kernel")
    check(main_draws == 4, f"3 x sample() + sample_many(16) launched the draw kernel "
                           f"{main_draws} times, not once a call")

    # the plain versions of the draws and the encode, from the sampler's key
    base = prng_key(cfg.seed)
    for step, b in enumerate(singles):
        check(b.hap1 is b.hap1_codes and b.hap1.shape == (BATCH, SEQ_LENGTH), "batch form")
        d = draws_plain(base, step, 1, BATCH, *draw_args(sampler))
        want = sampler.windows_from_draws(*d[1:4], kernel="baseline")
        cmp.windows(b, want, f"sample() step {step}")
    d = draws_plain(base, 3, 16, BATCH, *draw_args(sampler))
    want = sampler.windows_from_draws(*d[1:4], kernel="baseline")
    flat = HaplotypeWindows(*(t.reshape(-1, *t.shape[2:]) for t in many[2:]))
    cmp.windows(flat, HaplotypeWindows(*want[2:]), "sample_many(16)")
    allcodes = torch.cat([many.hap1_codes.flatten(), many.hap2_codes.flatten()])
    check(int(allcodes.min()) >= 0 and int(allcodes.max()) <= N_CODE, "codes in [0, 4]")
    check(torch.equal(many.overflow, (many.n_variants - K_MAX).clamp(min=0)), "overflow")
    mean_nv = float(many.n_variants.float().mean())
    check(mean_nv > 0, "windows hold variants")
    log(f"main path checks: bit-equal to the plain versions of the draws and the encode; "
        f"mean in-window SNVs {mean_nv:.3f}, max {int(many.n_variants.max())}")
    draw_cmp = Comparisons()
    lanes = draw_checks(sampler, args.seed, draw_cmp)
    log(f"draw kernel checks: {draw_cmp.count} launches at {DRAW_BATCHES} x B={BATCH}, at "
        f"(n_batches, B) in {DRAW_ODD_BATCHES} and at R in {DRAW_SPANS} ({lanes:,} lanes) "
        f"bit-equal to the plain version (host keys, keys on the card, a chain digest); "
        f"step {JAX_DRAWS['step']} of PRNGKey({JAX_DRAWS['seed']}) and "
        f"fold_in(key, {JAX_DRAWS['digest']:#x}) equal to the JAX package's")

    # -- 4. edge fixtures ---------------------------------------------------
    for name, (state, dr, L, K) in edge_fixtures().items():
        idx = build_window_index(*(torch.from_numpy(a).to(dev) for a in state))
        cmp.encode(idx, *(torch.from_numpy(a).to(dev) for a in dr), L, K, name)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    for B in (1, 61, 64, 4096):
        for L in (256, 333, 1000, 2049, 4080):
            for K in (8, 64, 128):
                d, c, s = random_draws(sampler, B, L, gen)
                cmp.encode(sampler.index, d, c, s, L, K, f"B={B} L={L} K={K}")
    # the main path's two launch shapes, sample()'s B=64 and sample_many(16)'s
    # B=1024, on the sampler's draws of later steps
    for step0, steps in ((1000, 1), (2000, 16)):
        for i in range(4):
            d = draw_windows(base, step0 + i * steps, steps, BATCH, *draw_args(sampler))
            got = cmp.encode(sampler.index, d.donor_idx, d.chrom_idx, d.start, SEQ_LENGTH,
                             K_MAX, f"sampled batch B={steps * BATCH}")
            if i == 0:
                lo, hi = window_bounds(sampler.index, d.donor_idx, d.chrom_idx, d.start,
                                       SEQ_LENGTH)
                check(torch.equal((hi - lo).int(), got.n_variants),
                      f"window_bounds' n_in differs from the kernel's at B={steps * BATCH}")
    log(f"edge fixtures: {cmp.count} kernel/plain comparisons bit-equal so far")

    # -- 5. from_files ------------------------------------------------------
    if importlib.util.find_spec("h5py") is None:
        log("from_files: not run: h5py is not installed on this machine "
            "(tests/test_torch_sampler.py holds from_files against the JAX package)")
    else:
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
            check_from_files(tmp, args.seed, cfg, cmp)

    # -- 7-10. the converter -------------------------------------------------
    dec = DecodeComparisons()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    conv_dir = tempfile.TemporaryDirectory(dir=_build.BUILD_DIR)  # phases 7-10, 14-16
    try:
        tmp = conv_dir.name
        ctx = converter_main_path(tmp, args.seed, dev, dec)
        src, donor = VCFSource(ctx["chr1"], ctx["threads"]), ctx["samples"][0]
        f12 = torch.from_numpy(src.frame12(donor, "chr1")[0]).to(dev)
        f64 = torch.from_numpy(src.frame(donor, "chr1").records).to(dev)
        decode_edge_fixtures(tmp, args.seed, dev, dec, f12, f64)
        times = decode_times(card, ctx, f12, f64)
        del f12, f64

        # -- 11-12. the window-kernel lab ------------------------------------
        lab_cmp = Comparisons()
        lab_checks(sampler, args.seed, lab_cmp)
        lab_times = lab_path(card, args.seed, sampler, lab_cmp)

        # -- 13. the training path -------------------------------------------
        t0 = time.perf_counter()
        train = train_path(args.seed, sampler, cmp)
        log(f"training path phase: {time.perf_counter() - t0:.1f} s")
        log(json.dumps({"train": {"card": card, "config": "HaploFormerConfig() d_model 256, "
                                  "8 heads, 4 layers, bf16", "B": BATCH, "L": SEQ_LENGTH,
                                  **train}}))

        # -- 14. the single-pass converter -----------------------------------
        torch.cuda.empty_cache()
        single_pass = single_pass_phase(card, tmp, args.seed, dev, ctx)
        log(json.dumps({"single_pass": single_pass}))

        # -- 15. the reference path ------------------------------------------
        torch.cuda.empty_cache()
        reference, ref_launches = reference_phase(card, tmp, args.seed, dev, cmp)
        log(json.dumps({"reference": reference}))

        # -- 16. the tokenizer route and the host I/O surface ---------------
        torch.cuda.empty_cache()
        log(json.dumps({"tokenizer": tokenizer_phase(card, tmp, dev, ctx)}))

        # -- 17. the parallel path at world size 1 ---------------------------
        parallel = run_parallel(args.seed, tmp)
        log(json.dumps({"parallel": parallel}))
    finally:
        conv_dir.cleanup()

    # -- 18. sample_chain: one CUDA graph over the window kernel ------------
    torch.cuda.empty_cache()
    chain, chain_launches = chain_phase(card, args.seed, genome, cohort, regions, sampler, cmp)
    log(json.dumps({"chain": chain}))

    # -- 19. long windows and K past 128 ------------------------------------
    torch.cuda.empty_cache()
    long_cmp = Comparisons()
    long = long_windows_phase(args.seed, genome, cohort, regions, sampler, long_cmp)
    log(json.dumps({"long_windows": long}))

    # -- 20. Enformer's conv-block kernels ---------------------------------
    torch.cuda.empty_cache()
    bn = batchnorm_gelu_phase(card, args.seed)
    log(json.dumps({"batchnorm_gelu": bn}))

    # -- 21. the chunked scan's kernels ------------------------------------
    torch.cuda.empty_cache()
    granite = granite_main_step(args.seed)  # the main path of phases 21 and 22
    ssd = ssd_scan_phase(card, args.seed, granite)
    log(json.dumps({"ssd_scan": ssd}))

    # -- 22. the norms' kernels --------------------------------------------
    torch.cuda.empty_cache()
    rms = rms_norm_phase(card, args.seed, granite)
    log(json.dumps({"rms_norm": rms}))

    # -- 23. the Nemotron-H hybrid -----------------------------------------
    torch.cuda.empty_cache()
    nemotron = nemotron_phase(card, args.seed)
    log(json.dumps({"nemotron": nemotron}))

    kernels = [{
        "name": "window_kernel",
        "route": "cuda",
        "source": "haplohyped_tpu_torch/csrc/window_kernel.cu",
        "replaces": "haplohyped_tpu/ops/pallas_window.py:178",
        "launches": (main_launches + train["window_launches"] + ref_launches
                     + parallel["train"]["window_launches"] + chain_launches),
        "max_abs_err": cmp.max_abs_err,
        **UNTIMED,
    }, {
        "name": "window_kernel_long",
        "route": "cuda",
        "source": "haplohyped_tpu_torch/csrc/window_kernel.cu",
        "replaces": "haplohyped_tpu/ops/pallas_window.py:178",
        "launches": long["launches"],
        "max_abs_err": long_cmp.max_abs_err,
        **UNTIMED,
    }]
    for name, line in (("vcf_decode12", 151), ("vcf_decode64", 70)):
        ms, plain_ms, bound = times[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "haplohyped_tpu_torch/csrc/vcf_decode.cu",
            "replaces": f"haplohyped_tpu/ops/pallas_decode.py:{line}",
            "launches": ctx["launches"][name] + (parallel["decode"]["decode64_launches"]
                                                 if name == "vcf_decode64" else 0),
            "max_abs_err": dec.max_abs_err[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes",
            "library_ms": None,
        })
    kernels.append({
        "name": "window_kernel_lab",
        "route": "cuda",
        "source": "haplohyped_tpu_torch/csrc/window_kernel_lab.cu",
        "replaces": "tools/window_kernel_lab.py:133",
        "launches": lab_times["launches"],
        "max_abs_err": lab_cmp.max_abs_err,
        "ms": lab_times["ms"],
        "plain_ms": lab_times["plain_ms"],
        "bound_ms": lab_times["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    })
    kernels.append({
        "name": "draw_kernel",
        "route": "cuda",
        "source": "haplohyped_tpu_torch/csrc/draw_kernel.cu",
        "replaces": None,  # no Pallas kernel: the jax.random ops of data/sampler.py:110-116
        "launches": (main_draws + train["draw_launches"] + reference["draw_launches"]
                     + parallel["train"]["draw_launches"] + chain["draw_launches"]),
        "max_abs_err": draw_cmp.max_abs_err,
        **UNTIMED,
    })
    bn_ms = bn["times"]
    kernels.append({
        "name": "batchnorm_gelu",
        "route": "cuda",
        "source": "haplohyped_tpu_torch/csrc/batchnorm_gelu.cu",
        "replaces": None,  # no Pallas kernel: Enformer's F.batch_norm and GELU ops
        "launches": bn["step"]["launches"],  # one Enformer step; the comparisons' own apart
        "max_abs_err": None,  # held to the plain version by bf16 steps and norms, phase 20
        "ms": {k: bn_ms["kernel"][k] for k in ("forward_ms", "backward_ms")},
        "plain_ms": bn_ms["plain"],
        "bound_ms": bn_ms["bound"],
        "bound_by": "bytes",
        "library_ms": bn_ms["library"],
    })
    ssd_ms = ssd["times"]
    kernels.append({
        "name": "ssd_scan",
        "route": "cuda",
        "source": "haplohyped_tpu_torch/csrc/ssd_scan.cu",
        "replaces": None,  # no Pallas kernel: the JAX package has no state-space model
        "launches": ssd["step"]["ssd_scan"]["launches"],  # one Granite step; the comparisons' own apart
        "max_abs_err": None,  # held to the plain version by shares of its norm, phase 21
        "ms": ssd_ms["kernel"],
        "plain_ms": ssd_ms["plain"],
        "bound_ms": None,  # the benchmark's: ssd_fwd_roofline.granite, ssd_bwd_roofline.granite
        "bound_by": None,
        "library_ms": None,
    })
    rms_ms = rms["times"]
    kernels.append({
        "name": "rms_norm",
        "route": "cuda",
        "source": "haplohyped_tpu_torch/csrc/rms_norm.cu",
        "replaces": None,  # no Pallas kernel: the Granite hybrid's RMSNorm and gate ops
        "launches": rms["step"]["rms_norm"]["launches"],  # one Granite step; the comparisons' own apart
        "max_abs_err": None,  # held to the plain version by bf16 steps and norms, phase 22
        "ms": {k: v["kernel"] for k, v in rms_ms.items()},
        "plain_ms": {k: v["plain"] for k, v in rms_ms.items()},
        "bound_ms": {k: v["bound"] for k, v in rms_ms.items()},
        "bound_by": "bytes",
        "library_ms": {k: v["library"] for k, v in rms_ms.items()},
    })
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"comparisons": {"main": cmp.count, "draw": draw_cmp.count,
                                    "lab": lab_cmp.count, "long": long_cmp.count,
                                    "decode": dec.count, "batchnorm_gelu": bn["comparisons"],
                                    "ssd_scan": ssd["comparisons"],
                                    "rms_norm": rms["comparisons"],
                                    "nemotron": nemotron["comparisons"]}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
