"""The Hopper window-encode kernel and its wrapper.

:func:`encode_windows_kernel` computes what :func:`haplohyped_tpu_torch.ops.
haplotype_window.encode_haplotype_windows` computes, bit for bit, in one
launch of ``csrc/window_kernel.cu`` per batch.  It replaces the JAX package's
Pallas kernel ``haplohyped_tpu/ops/pallas_window.py::_window_kernel``.

:func:`build_window_index` prepares, once per dataset and with torch ops on
the device, what the kernels read besides the genome and cohort tensors: the
packed substitution codes ``sub12 = sub1 | sub2 << 8`` (phase selection does
not depend on the window), the bucket table ``first`` that the window kernel
searches with (:func:`bucket_table`); the window-kernel lab reads the same
index.  :func:`window_bounds` is a plain model of the window kernel's
search, for tests and ``chip_smoke.py``.

On a CPU tensor the wrapper runs the plain version.  On a CUDA tensor it
launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from haplohyped_tpu_torch.core.constants import INT32_MAX
from haplohyped_tpu_torch.ops import _build
from haplohyped_tpu_torch.ops.haplotype_window import (
    HaplotypeWindows,
    encode_haplotype_windows,
)

#: log2 of the bucket width in bp: first[d, c, j] = #{pos[d, c] < j << BK};
#: the kernel's kBK, held against it when the library loads
BK = 12

#: the kernel applies at most this many variants per window
K_MAX = 128


class WindowIndex(NamedTuple):
    """Device tensors of one dataset, for the kernel and the plain version."""

    genome: torch.Tensor  # (G,) int8
    offsets: torch.Tensor  # (C,) int32
    pos: torch.Tensor  # (D, C, V) int32, sorted per row, INT32_MAX padded
    ref: torch.Tensor  # (D, C, V) int8
    alt: torch.Tensor  # (D, C, V) int8
    p1: torch.Tensor  # (D, C, V) int8
    p2: torch.Tensor  # (D, C, V) int8
    counts: torch.Tensor  # (D, C) int32
    sub12: torch.Tensor  # (D, C, V) int16 — sub1 | sub2 << 8
    first: torch.Tensor  # (D, C, NB + 1) int32 — #{pos[d, c] < j << BK}

    @property
    def plain_args(self) -> tuple:
        """The plain version's operands, in its argument order."""
        return (self.genome, self.offsets, self.pos, self.ref, self.alt,
                self.p1, self.p2, self.counts)


def bucket_table(pos: torch.Tensor, counts: torch.Tensor, bk: int = BK) -> torch.Tensor:
    """``first[d, c, j] = #{pos[d, c] < j << bk}`` for ``j`` in ``[0, NB]``,
    (D, C, NB + 1) int32, with one batched ``searchsorted`` on the device.

    ``NB = (P >> bk) + 1`` for ``P`` the largest position a row's count
    covers (0 buckets if none), capped so that ``NB << bk`` fits in int32.
    The kernel is right for any ``NB``: a start past the table searches to
    the row's count.  One device sync."""
    if not 0 <= bk <= 30:
        raise ValueError(f"bk={bk} outside [0, 30]")
    D, C, V = pos.shape
    rows = pos.reshape(D * C, V)
    last = rows.gather(1, (counts.reshape(D * C, 1).long() - 1).clamp(0, V - 1))[:, 0]
    last = torch.where((counts.reshape(-1) > 0) & (last < INT32_MAX), last, -1)
    top = int(last.max()) if last.numel() else -1
    nb = min((top >> bk) + 1, INT32_MAX >> bk) if top >= 0 else 0
    starts = torch.arange(nb + 1, dtype=torch.int32, device=pos.device) << bk
    first = torch.searchsorted(rows, starts.expand(D * C, nb + 1).contiguous(), out_int32=True)
    return first.reshape(D, C, nb + 1)


def build_window_index(genome, offsets, pos, ref, alt, p1, p2, counts) -> WindowIndex:
    """Build the kernels' index with torch ops on the tensors' device.

    Checks once (one device sync) that REF/ALT codes lie in [0, 128), so the
    packed ``sub12`` holds both codes exactly."""
    for name, codes in (("ref", ref), ("alt", alt)):
        if codes.numel():
            lo, hi = (int(v) for v in torch.aminmax(codes))
            if lo < 0 or hi >= 128:
                raise ValueError(f"{name} codes must lie in [0, 128), got [{lo}, {hi}]")
    sub1 = torch.where(p1 == 1, alt, ref).to(torch.int16)
    sub2 = torch.where(p2 == 1, alt, ref).to(torch.int16)
    sub12 = sub1 | (sub2 << 8)
    del sub1, sub2
    first = bucket_table(pos, counts)
    return WindowIndex(genome, offsets, pos, ref, alt, p1, p2, counts, sub12, first)


def _check(index: WindowIndex, donor_idx, chrom_idx, start, L: int, K: int):
    """Raise on what the kernel does not take."""
    dev = start.device
    want = {
        "genome": torch.int8, "offsets": torch.int32, "pos": torch.int32,
        "counts": torch.int32, "sub12": torch.int16, "first": torch.int32,
    }
    tensors = {name: getattr(index, name) for name in want}
    tensors.update(donor_idx=donor_idx, chrom_idx=chrom_idx, start=start)
    want.update(donor_idx=torch.int32, chrom_idx=torch.int32, start=torch.int32)
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, start is on {dev}")
        if t.dtype != want[name]:
            raise TypeError(f"{name} must be {want[name]}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if start.dim() != 1:
        raise ValueError("start must be (B,)")
    D, C, V = index.pos.shape
    B = start.shape[0]
    G = index.genome.shape[0]
    if index.sub12.shape != (D, C, V) or index.counts.shape != (D, C):
        raise ValueError("sub12/counts shapes do not match pos")
    if index.offsets.shape != (C,):
        raise ValueError("offsets shape does not match pos")
    if (index.first.dim() != 3 or index.first.shape[:2] != (D, C)
            or not 1 <= index.first.shape[2] <= (INT32_MAX >> BK) + 1):
        raise ValueError(f"first must be (D, C, NB + 1) with NB << BK in int32, "
                         f"got {tuple(index.first.shape)}")
    if donor_idx.shape != (B,) or chrom_idx.shape != (B,):
        raise ValueError("donor_idx and chrom_idx must be (B,), like start")
    if not 1 <= K <= K_MAX:
        raise ValueError(f"K={K} outside [1, {K_MAX}]")
    if not 1 <= L <= G:
        raise ValueError(f"L={L} outside [1, G={G}]")
    if V < 1 or D * C * V >= 2**63 or max(V, B) >= 2**31:
        raise ValueError(f"unsupported sizes D={D} C={C} V={V} B={B}")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_kernel("window_kernel")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hh_window_encode.argtypes = [
        p, ctypes.c_longlong, p, p, p, p, p, i, i, i, i,
        p, p, p, i, i, i, p, p, p, p, p,
    ]
    lib.hh_window_encode.restype = ctypes.c_int
    lib.hh_cuda_error_string.argtypes = [ctypes.c_int]
    lib.hh_cuda_error_string.restype = ctypes.c_char_p
    lib.hh_window_bucket_bits.restype = ctypes.c_int
    if lib.hh_window_bucket_bits() != BK:
        raise RuntimeError(f"window kernel searches buckets of 2^{lib.hh_window_bucket_bits()} "
                           f"bp, the index's are 2^{BK}")
    return lib


def encode_windows_kernel(
    index: WindowIndex,
    donor_idx: torch.Tensor,  # (B,) int32
    chrom_idx: torch.Tensor,  # (B,) int32
    start: torch.Tensor,  # (B,) int32 window start within chrom
    *,
    L: int,
    K: int,
) -> HaplotypeWindows:
    """Encode a batch of windows: the Hopper kernel for CUDA tensors, the
    plain version for CPU tensors.  ``encode_windows_kernel.launches`` counts
    the kernel's launches."""
    if start.device.type == "cpu":
        return encode_haplotype_windows(
            *index.plain_args, donor_idx, chrom_idx, start, L=L, K=K
        )
    if start.device.type != "cuda":
        raise ValueError(f"no window kernel for device {start.device}")
    _check(index, donor_idx, chrom_idx, start, L, K)
    D, C, V = index.pos.shape
    B = start.shape[0]
    haps = torch.empty((2, B, L), dtype=torch.int8, device=start.device)
    tallies = torch.empty((2, B), dtype=torch.int32, device=start.device)
    out = HaplotypeWindows(haps[0], haps[1], tallies[0], tallies[1])
    if B == 0:
        return out
    lib = _library()
    with torch.cuda.device(start.device):
        stream = torch.cuda.current_stream(start.device).cuda_stream
        rc = lib.hh_window_encode(
            index.genome.data_ptr(), index.genome.shape[0],
            index.offsets.data_ptr(), index.pos.data_ptr(),
            index.sub12.data_ptr(), index.first.data_ptr(),
            index.counts.data_ptr(), D, C, V, index.first.shape[2],
            donor_idx.data_ptr(), chrom_idx.data_ptr(), start.data_ptr(),
            B, L, K, out.hap1.data_ptr(), out.hap2.data_ptr(),
            out.n_variants.data_ptr(), out.overflow.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"window kernel launch failed: {lib.hh_cuda_error_string(rc).decode()}"
        )
    encode_windows_kernel.launches += 1
    return out


encode_windows_kernel.launches = 0


def window_slice(index: WindowIndex, donor_idx, chrom_idx, start, L: int):
    """``(a, e)``, (B,) int64: the slice of each window's row that the
    kernel reads, from two entries of ``index.first``.  Every position before
    ``a`` is < start, every one from ``e`` to the row's count >= start + L."""
    D, C, V = index.pos.shape
    nb = index.first.shape[2] - 1
    d = donor_idx.long().clamp(0, D - 1)
    c = chrom_idx.long().clamp(0, C - 1)
    s = start.long()
    row = d * C + c
    first = index.first.reshape(D * C, nb + 1)
    fa = first[row, (s.clamp(min=0) >> BK).clamp(max=nb)].long()
    je = (((s + L - 1) >> BK) + 1).clamp(min=0)
    fe = torch.where(je <= nb, first[row, je.clamp(max=nb)].long(), INT32_MAX)
    cnt = index.counts.reshape(D * C)[row].long().clamp(0, V)
    a = torch.where(s < 0, 0, torch.minimum(fa, cnt))
    return a, torch.maximum(a, torch.minimum(fe, cnt))


def window_bounds(index: WindowIndex, donor_idx, chrom_idx, start, L: int):
    """``(lo, hi)``, (B,) int64: the kernel's search as plain torch ops.
    ``lo``/``hi`` count the positions < start / < start + L within the row's
    count, by counting inside :func:`window_slice`; ``hi - lo`` is the
    window's ``n_variants``.  One device sync (the longest slice)."""
    D, C, V = index.pos.shape
    a, e = window_slice(index, donor_idx, chrom_idx, start, L)
    row = donor_idx.long().clamp(0, D - 1) * C + chrom_idx.long().clamp(0, C - 1)
    width = int((e - a).max()) if a.numel() else 0
    j = a[:, None] + torch.arange(width, device=a.device)
    inside = j < e[:, None]
    p = index.pos.reshape(-1)[row[:, None] * V + j.clamp(max=V - 1)].long()
    s = start.long()[:, None]
    lo = a + ((p < s) & inside).sum(dim=1)
    hi = a + ((p < s + L) & inside).sum(dim=1)
    return lo, hi
