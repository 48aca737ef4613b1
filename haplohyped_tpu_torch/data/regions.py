"""BED region handling and the midpoint window crop.

``calculate_midpoint_region`` re-centers a region to a fixed ``seq_length``
window around its midpoint, clamped at 0.
"""

from __future__ import annotations

import numpy as np


def calculate_midpoint_region(start: int, end: int, seq_length: int):
    midpt = (start + end) // 2
    half_seq_length = seq_length // 2
    new_start = max(0, midpt - half_seq_length)
    new_end = midpt + half_seq_length
    return new_start, new_end


def load_bed_regions(bed_file: str) -> tuple[np.ndarray, np.ndarray, list[str]]:
    """Parse a 3-column BED (chrom, start, end).

    Returns ``(chrom_names_per_row, (R, 2) int64 spans, unique_chrom_names)``.
    """
    chroms: list[str] = []
    spans: list[tuple[int, int]] = []
    with open(bed_file) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(("#", "track", "browser")):
                continue
            parts = line.split("\t") if "\t" in line else line.split()
            chroms.append(parts[0])
            spans.append((int(parts[1]), int(parts[2])))
    uniq = sorted(set(chroms), key=lambda x: (len(x), x))
    return np.asarray(chroms), np.asarray(spans, dtype=np.int64), uniq
