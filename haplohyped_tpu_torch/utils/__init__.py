"""Sequence-encoding and bit-packing utilities (numpy)."""

from haplohyped_tpu_torch.utils.bitpack import (
    bitpack_indices,
    index_to_onehot,
    pack_2bit,
    unpack_2bit,
    unpack_bits,
)
from haplohyped_tpu_torch.utils.common_utils import (
    array_to_onehot,
    encode_sequence,
    nucleotide_to_index,
    parse_encode_dict,
)

__all__ = [
    "array_to_onehot",
    "encode_sequence",
    "nucleotide_to_index",
    "parse_encode_dict",
    "bitpack_indices",
    "index_to_onehot",
    "unpack_bits",
    "pack_2bit",
    "unpack_2bit",
]
