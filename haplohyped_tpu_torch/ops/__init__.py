"""ops layer of haplohyped_tpu_torch."""

from haplohyped_tpu_torch.ops.onehot import ascii_to_codes, codes_to_onehot
from haplohyped_tpu_torch.ops.vcf_decode import decode_frames, decoded_to_numpy

__all__ = [
    "decode_frames",
    "decoded_to_numpy",
    "ascii_to_codes",
    "codes_to_onehot",
]
