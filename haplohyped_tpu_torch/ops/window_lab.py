"""The window-kernel lab: the window encode with its load and compute legs
switchable, on a Hopper kernel beside its plain PyTorch versions.

It is the counterpart of the JAX package's ``tools/window_kernel_lab.py``
(``lab_kernel_variant``, launched by ``make_variant_call``), which split the
Pallas window kernel's time into DMA latency and compute.  Each variant is a
template instance of ``csrc/window_kernel_lab.cu``, the production kernel
(``csrc/window_kernel.cu``, whose device code it shares) with one leg
switched off; all three read the production kernel's index
(:class:`~.window_kernel.WindowIndex`).

- ``full``: the encode, :func:`~.haplotype_window.encode_haplotype_windows`,
  with ``sink`` 0.
- ``dma_only``: every load of the encode and no substitution.  With ``flat``
  the clamped flat start, the window is the genome read from the
  ``sp``-word-aligned base ``4 * ((flat >> 2) // sp) * sp + (flat & 3)``;
  ``n_variants`` and ``overflow`` are ``pos`` and ``sub12`` at ``lo0 =
  max(#{pos[row, ::sp] < start} - 1, 0) * sp``, the first entry of the
  chunk of the JAX lab's coarse grid that its search reads: what the JAX
  lab's DMA-only variant returns.  ``sink`` is the XOR of ``pos ^ sub12``
  over the applied variants (those ``full`` applies), so the kernel's loads
  of them stay live.  The JAX lab has no sink.
- ``compute_only``: ``full`` on the synthetic state of
  :func:`synthetic_state`, which the kernel computes in registers where
  ``full`` loads.  The JAX lab's variant reads scratch memory that no copy
  filled, an output no port can be held to; this one is defined and keeps a
  deployment's ~1.2 variants per 1,000 bp.

:func:`encode_windows_lab` launches the kernel for CUDA tensors and runs the
plain version for CPU tensors; it never falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from haplohyped_tpu_torch.core.constants import INT32_MAX
from haplohyped_tpu_torch.ops import _build
from haplohyped_tpu_torch.ops.haplotype_window import (
    _CHUNK_ELEMS,
    encode_haplotype_windows,
)
from haplohyped_tpu_torch.ops.window_kernel import BK, WindowIndex, _check

VARIANTS = ("full", "dma_only", "compute_only")
#: windows per block of 128 threads the kernel takes
WINDOWS_PER_BLOCK = (1, 2, 4, 8, 16, 32)
#: dma_only's default grid stride: its n_variants and overflow read the row
#: at lo0, a multiple of SP
SP = 512
#: compute_only: bp between synthetic variants (~1.2 SNVs per kb)
SYNTH_STRIDE = 833


class LabWindows(NamedTuple):
    hap1: torch.Tensor  # (B, L) int8
    hap2: torch.Tensor  # (B, L) int8
    n_variants: torch.Tensor  # (B,) int32
    overflow: torch.Tensor  # (B,) int32
    sink: torch.Tensor  # (B,) int32 — dma_only's XOR of its applied loads, else 0


def synthetic_state(index: WindowIndex) -> tuple[torch.Tensor, ...]:
    """compute_only's state, as the plain version's eight operands: the shapes,
    ``offsets`` and ``counts`` of ``index``; genome byte ``x`` is ``x & 3``;
    variant ``i < counts[row]`` of a row sits at ``i * SYNTH_STRIDE`` and
    ``INT32_MAX`` past the count; ``sub1 = i & 3`` and ``sub2 = (i >> 2) &
    3`` (REF, ALT and the phases are constant along the donor and chromosome
    axes, so they are broadcast views)."""
    D, C, V = index.pos.shape
    if V * SYNTH_STRIDE >= 2**31:
        raise ValueError(f"V={V} too large for synthetic positions i * {SYNTH_STRIDE} in int32")
    dev = index.pos.device
    G = index.genome.shape[0]
    genome = torch.arange(4, dtype=torch.int8, device=dev).repeat(-(-G // 4))[:G]
    i = torch.arange(V, dtype=torch.int32, device=dev)
    pos = torch.where(i < index.counts[..., None], i * SYNTH_STRIDE, INT32_MAX)
    ref = (i & 3).to(torch.int8).expand(D, C, V)  # sub1: p1 = 0 picks REF
    alt = ((i >> 2) & 3).to(torch.int8).expand(D, C, V)  # sub2: p2 = 1 picks ALT
    p1 = torch.zeros((), dtype=torch.int8, device=dev).expand(D, C, V)
    p2 = torch.ones((), dtype=torch.int8, device=dev).expand(D, C, V)
    return genome, index.offsets, pos, ref, alt, p1, p2, index.counts


def _xor_rows(x: torch.Tensor) -> torch.Tensor:
    """XOR of each row of a (b, n) integer tensor, by halving."""
    while x.shape[1] > 1:
        if x.shape[1] % 2:
            x = torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
        h = x.shape[1] // 2
        x = x[:, :h] ^ x[:, h:]
    return x[:, 0]


def grid_lo0(pos_rows: torch.Tensor, s: torch.Tensor, sp: int) -> torch.Tensor:
    """dma_only's ``lo0`` of each row of ``pos_rows`` (b, V) at start ``s``
    (b,): ``max(#{pos_rows[:, ::sp] < s} - 1, 0) * sp``, counted over the
    JAX lab's coarse grid, whole rows."""
    blo = (pos_rows[:, ::sp] < s[:, None]).sum(dim=1)
    return (blo - 1).clamp(min=0) * sp


def _dma_only_chunk(index: WindowIndex, donor_idx, chrom_idx, start, L, K, sp):
    D, C, V = index.pos.shape
    dev = start.device
    d = donor_idx.long().clamp(0, D - 1)
    c = chrom_idx.long().clamp(0, C - 1)
    s = start.to(torch.int32)
    row = d * C + c
    flat = (index.offsets[c].long() + s.long()).clamp(0, index.genome.shape[0] - L)
    base = (flat >> 2) // sp * sp * 4 + (flat & 3)
    window = index.genome[base[:, None] + torch.arange(L, device=dev)]

    pos_rows = index.pos.reshape(D * C, V)[row]  # (b, V)
    sub_rows = index.sub12.reshape(D * C, V)[row].int()
    lo0 = grid_lo0(pos_rows, s, sp)[:, None]
    n_variants = torch.gather(pos_rows, 1, lo0)[:, 0]
    overflow = torch.gather(sub_rows, 1, lo0)[:, 0]

    # the applied variants, selected as the encode selects them
    lo = torch.searchsorted(pos_rows, s[:, None], side="left")[:, 0]
    hi = torch.searchsorted(pos_rows, (s + L)[:, None], side="left")[:, 0]
    count = index.counts.reshape(D * C)[row].long()
    n_in = (torch.minimum(hi, count) - torch.minimum(lo, count)).clamp(min=0)
    k = torch.arange(K, device=dev)
    take = (lo[:, None] + k).clamp(max=V - 1)
    applied = k[None, :] < n_in.clamp(max=K)[:, None]
    loads = torch.gather(pos_rows, 1, take) ^ torch.gather(sub_rows, 1, take)
    sink = _xor_rows(torch.where(applied, loads, 0))
    return window, window.clone(), n_variants, overflow, sink


def _dma_only_plain(index, donor_idx, chrom_idx, start, L, K, sp) -> LabWindows:
    B = start.shape[0]
    step = max(1, _CHUNK_ELEMS // index.pos.shape[2])
    parts = [
        _dma_only_chunk(index, donor_idx[i : i + step], chrom_idx[i : i + step],
                        start[i : i + step], L, K, sp)
        for i in range(0, max(B, 1), step)
    ]
    return LabWindows(*(torch.cat(p) for p in zip(*parts)))


def lab_plain(index: WindowIndex, donor_idx, chrom_idx, start, *, L: int, K: int,
              variant: str, sp: int = SP) -> LabWindows:
    """The plain PyTorch version of ``variant``, on any device."""
    if variant == "dma_only":
        return _dma_only_plain(index, donor_idx, chrom_idx, start, L, K, sp)
    state = index.plain_args if variant == "full" else synthetic_state(index)
    win = encode_haplotype_windows(*state, donor_idx, chrom_idx, start, L=L, K=K)
    return LabWindows(*win, torch.zeros_like(win.n_variants))


@functools.cache
def _library() -> ctypes.CDLL:
    """The lab kernel's library, with every instance's shared memory limit
    raised on the current device."""
    lib = _build.load_kernel("window_kernel_lab")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hh_window_lab.argtypes = [
        i, i, p, ctypes.c_longlong, p, p, p, p, p, i, i, i, i, i,
        p, p, p, i, i, i, p, p, p, p, p, p,
    ]
    lib.hh_window_lab.restype = ctypes.c_int
    lib.hh_lab_error_string.argtypes = [ctypes.c_int]
    lib.hh_lab_error_string.restype = ctypes.c_char_p
    lib.hh_window_lab_smem.argtypes = [i, i]
    for fn in (lib.hh_window_lab_smem, lib.hh_window_lab_bucket_bits, lib.hh_window_lab_init):
        fn.restype = ctypes.c_int
    lib.hh_window_lab_bucket_bits.argtypes = lib.hh_window_lab_init.argtypes = []
    if lib.hh_window_lab_bucket_bits() != BK:
        raise RuntimeError(f"lab kernel searches buckets of 2^{lib.hh_window_lab_bucket_bits()} "
                           f"bp, the index's are 2^{BK}")
    rc = lib.hh_window_lab_init()
    if rc != 0:
        raise RuntimeError(f"lab kernel set-up failed: {lib.hh_lab_error_string(rc).decode()}")
    return lib


def lab_smem_bytes(w: int, L: int) -> int:
    """Dynamic shared memory of a launch of the lab kernel at ``w`` windows a
    block of ``L`` bytes, as the kernel's source computes it (needs a card)."""
    return _library().hh_window_lab_smem(w, L)


def encode_windows_lab(
    index: WindowIndex,
    donor_idx: torch.Tensor,  # (B,) int32
    chrom_idx: torch.Tensor,  # (B,) int32
    start: torch.Tensor,  # (B,) int32 window start within chrom
    *,
    L: int,
    K: int,
    variant: str,
    w: int = 1,
    sp: int = SP,
) -> LabWindows:
    """One lab variant over a batch of windows: the Hopper kernel, ``w``
    windows a block, for CUDA tensors; the plain version for CPU tensors.
    ``sp``, a power of two, is ``dma_only``'s grid stride.
    ``encode_windows_lab.launches`` counts the kernel's launches."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown lab variant {variant!r}; one of {VARIANTS}")
    if w not in WINDOWS_PER_BLOCK:
        raise ValueError(f"w={w} windows per block; one of {WINDOWS_PER_BLOCK}")
    if start.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no lab kernel for device {start.device}")
    if sp < 1 or sp & (sp - 1):
        raise ValueError(f"sp={sp} must be a power of two")
    _check(index, donor_idx, chrom_idx, start, L, K)
    D, C, V = index.pos.shape
    if variant == "compute_only" and V * SYNTH_STRIDE >= 2**31:
        raise ValueError(f"V={V} too large for synthetic positions i * {SYNTH_STRIDE} in int32")
    if start.device.type == "cpu":
        return lab_plain(index, donor_idx, chrom_idx, start, L=L, K=K, variant=variant, sp=sp)
    B = start.shape[0]
    dev = start.device
    hap1 = torch.empty((B, L), dtype=torch.int8, device=dev)
    hap2 = torch.empty((B, L), dtype=torch.int8, device=dev)
    n_variants, overflow, sink = (torch.empty((B,), dtype=torch.int32, device=dev)
                                  for _ in range(3))
    out = LabWindows(hap1, hap2, n_variants, overflow, sink)
    if B == 0:
        return out
    with torch.cuda.device(dev):
        lib = _library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hh_window_lab(
            VARIANTS.index(variant), w, index.genome.data_ptr(), index.genome.shape[0],
            index.offsets.data_ptr(), index.pos.data_ptr(), index.sub12.data_ptr(),
            index.first.data_ptr(), index.counts.data_ptr(), D, C, V,
            index.first.shape[2], sp, donor_idx.data_ptr(), chrom_idx.data_ptr(),
            start.data_ptr(), B, L, K, *(t.data_ptr() for t in out), stream,
        )
    if rc != 0:
        raise RuntimeError(f"lab kernel launch failed: {lib.hh_lab_error_string(rc).decode()}")
    encode_windows_lab.launches += 1
    return out


encode_windows_lab.launches = 0
