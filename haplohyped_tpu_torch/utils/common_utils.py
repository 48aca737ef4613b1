"""Sequence-encoding utilities (numpy).

``parse_encode_dict`` turns an encode spec into ``{base: index}``;
``encode_sequence``/``array_to_onehot`` give a ``(length, n_channels)``
one-hot whose channel order is the spec's order (default ``[A, C, G, T,
N]``), bases mapped through a 256-entry lookup table.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

from haplohyped_tpu_torch.core.constants import DEFAULT_ENCODE_DICT


def parse_encode_dict(encode_spec=None) -> dict[str, int]:
    """Parse an encoding specification into a ``{base: index}`` dict.

    Accepts ``None`` (default ``{A:0, C:1, G:2, T:3, N:4}``), a list/tuple/str
    of bases (enumerated in order), or a mapping (values taken as ints).
    """
    if not encode_spec:
        return dict(DEFAULT_ENCODE_DICT)
    if isinstance(encode_spec, (list, tuple, str)):
        return {_as_str(base): i for i, base in enumerate(encode_spec)}
    if isinstance(encode_spec, Mapping):
        return {_as_str(k): int(v) for k, v in encode_spec.items()}
    raise TypeError("Please input as dict, list or string!")


def _as_str(base) -> str:
    return base.decode() if isinstance(base, (bytes, np.bytes_)) else str(base)


def _build_lut(encode_spec: Mapping[str, int], unknown_code: int) -> np.ndarray:
    """ASCII byte -> code LUT honoring an arbitrary encode spec."""
    lut = np.full(256, unknown_code, dtype=np.int16)
    for base, code in encode_spec.items():
        lut[ord(base.upper())] = code
        lut[ord(base.lower())] = code
    return lut


def _coerce_bytes(seq_data, ignore_case: bool) -> np.ndarray:
    """Coerce str / |S1 ndarray input to a uint8 ASCII array (upper-cased
    where ``ignore_case``)."""
    if isinstance(seq_data, str):
        if ignore_case:
            seq_data = seq_data.upper()
        return np.frombuffer(seq_data.encode("ascii"), dtype=np.uint8).copy()
    if isinstance(seq_data, np.ndarray):
        if seq_data.dtype != np.dtype("|S1"):
            seq_data = seq_data.astype("|S1")
        arr = seq_data.view(np.uint8).copy()
        if ignore_case:
            lower = (arr >= ord("a")) & (arr <= ord("z"))
            arr[lower] = arr[lower] - 32
        return arr
    raise TypeError("Please input as string or numpy array!")


def nucleotide_to_index(seq, encode_spec=None, ignore_case: bool = True) -> np.ndarray:
    """Convert a DNA sequence (str or |S1 array) to int8 base codes.

    Bases not in the spec map to the spec's ``N`` code (the last code where
    the spec has no ``N``).
    """
    spec = parse_encode_dict(encode_spec)
    unknown = spec.get("N", len(spec) - 1)
    lut = _build_lut(spec, unknown)
    raw = _coerce_bytes(seq, ignore_case)
    return lut[raw].astype(np.int8)


def array_to_onehot(seq_array: np.ndarray, base_list: Sequence) -> np.ndarray:
    """One-hot encode an ``|S1`` byte array with channels ordered by
    ``base_list``.  Any byte outside {A, C, G, T} becomes ``N`` first; where
    ``base_list`` has no ``N``, those rows are all zero."""
    bases = [_as_str(b) for b in base_list]
    spec = {b: i for i, b in enumerate(bases)}
    raw = _coerce_bytes(np.asarray(seq_array), ignore_case=False)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    raw = np.where(np.isin(raw, acgt), raw, np.uint8(ord("N")))
    unknown = spec.get("N", len(spec))  # out of range => all-zero row
    lut = _build_lut(spec, unknown)
    codes = lut[raw]
    onehot = np.zeros((codes.shape[0], len(bases)), dtype=np.uint8)
    valid = codes < len(bases)
    onehot[np.nonzero(valid)[0], codes[valid]] = 1
    return onehot


def encode_sequence(seq_data, encode_spec=None, ignore_case: bool = True) -> np.ndarray:
    """One-hot encode a sequence: ``(length, n_channels)`` uint8.

    Channel order follows the encode spec (default ``[A, C, G, T, N]``).
    """
    spec = parse_encode_dict(encode_spec)
    base_list = list(spec.keys())
    raw = _coerce_bytes(seq_data, ignore_case)
    return array_to_onehot(raw.view("|S1"), base_list)
