"""The port's encode-spec utilities, numpy bit-packing codecs, constants and
``FastaEncodeConfig`` against the JAX package's (equal outputs, the same
``TypeError``s)."""

import numpy as np
import pytest

from haplohyped_tpu.core import constants as jax_constants
from haplohyped_tpu.core.config import FastaEncodeConfig as JaxFastaEncodeConfig
from haplohyped_tpu.utils import bitpack as jax_bitpack
from haplohyped_tpu.utils import common_utils as jax_common
from haplohyped_tpu_torch.core import constants
from haplohyped_tpu_torch.core.config import FastaEncodeConfig
from haplohyped_tpu_torch.utils import bitpack, common_utils

SPECS = {
    "none": None,
    "empty": "",
    "str": "ACGTN",
    "str_reordered": "TGCA",
    "list": ["A", "C", "G", "T"],
    "tuple": ("N", "A"),
    "bytes_list": [b"A", b"C", b"G"],
    "dict": {"A": 0, "C": 1, "G": 2, "T": 3, "N": 4},
    "dict_bytes_keys": {b"a": "1", b"N": 0},
}

SEQUENCES = {
    "str": "ACGTNacgtn",
    "iupac": "RYKMSWBDHVN-.acgt",
    "s1": np.array(list(b"AcGtNRx"), dtype=np.uint8).view("|S1"),
    "s1_from_str_array": np.array(list("ACgtN")),
}


def test_constants_and_config_match_jax():
    assert constants.DEFAULT_ENCODE_DICT == jax_constants.DEFAULT_ENCODE_DICT
    assert constants.REFERENCE_COMPRESSION_OPTS == jax_constants.REFERENCE_COMPRESSION_OPTS
    cfg = FastaEncodeConfig(fasta_path="g.fa", out_dir="out")
    jcfg = JaxFastaEncodeConfig(fasta_path="g.fa", out_dir="out")
    for name in ("chromosomes", "write_codes", "tmp_dir", "final_h5_path"):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    assert cfg.replace(chromosomes=("chr22",)).chromosomes == ("chr22",)


@pytest.mark.parametrize("spec", list(SPECS))
def test_parse_encode_dict_matches_jax(spec):
    assert common_utils.parse_encode_dict(SPECS[spec]) == jax_common.parse_encode_dict(SPECS[spec])


@pytest.mark.parametrize("bad", [5, 3.5, object()], ids=["int", "float", "object"])
def test_parse_encode_dict_type_errors(bad):
    for mod in (common_utils, jax_common):
        with pytest.raises(TypeError, match="dict, list or string"):
            mod.parse_encode_dict(bad)


@pytest.mark.parametrize("seq", list(SEQUENCES))
@pytest.mark.parametrize("spec", ["none", "str_reordered", "tuple", "dict"])
@pytest.mark.parametrize("ignore_case", [True, False])
def test_nucleotide_to_index_and_encode_sequence_match_jax(seq, spec, ignore_case):
    s, sp = SEQUENCES[seq], SPECS[spec]
    got = common_utils.nucleotide_to_index(s, sp, ignore_case)
    want = jax_common.nucleotide_to_index(s, sp, ignore_case)
    assert got.dtype == want.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    got = common_utils.encode_sequence(s, sp, ignore_case)
    want = jax_common.encode_sequence(s, sp, ignore_case)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bases", [list("ACGTN"), list("NTGCA"), list("ACGT"), [b"A", b"N"]])
def test_array_to_onehot_matches_jax(bases):
    arr = np.array(list(b"ACGTNRYacgt"), dtype=np.uint8).view("|S1")
    np.testing.assert_array_equal(common_utils.array_to_onehot(arr, bases),
                                  jax_common.array_to_onehot(arr, bases))


@pytest.mark.parametrize("fn", ["nucleotide_to_index", "encode_sequence"])
def test_sequence_type_errors(fn):
    for mod in (common_utils, jax_common):
        with pytest.raises(TypeError, match="string or numpy array"):
            getattr(mod, fn)(["A", "C"])


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 7, 8, 13, 4096, 4097])
def test_bitpack_codecs_match_jax(n):
    rng = np.random.default_rng(n)
    codes = rng.integers(0, 5, n).astype(np.int8)
    got, want = bitpack.bitpack_indices(codes), jax_bitpack.bitpack_indices(codes)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(bitpack.unpack_bits(got, n), jax_bitpack.unpack_bits(want, n))
    np.testing.assert_array_equal(bitpack.unpack_bits(got, n), codes)
    packed, mask, length = bitpack.pack_2bit(codes)
    jpacked, jmask, jlength = jax_bitpack.pack_2bit(codes)
    np.testing.assert_array_equal(packed, jpacked)
    np.testing.assert_array_equal(mask, jmask)
    assert length == jlength == n
    np.testing.assert_array_equal(bitpack.unpack_2bit(packed, mask, n), codes)
    np.testing.assert_array_equal(bitpack.unpack_2bit(packed, mask, n),
                                  jax_bitpack.unpack_2bit(jpacked, jmask, n))


@pytest.mark.parametrize("num_classes", [3, 5])
def test_index_to_onehot_matches_jax(num_classes):
    idx = np.array([-1, 0, 1, 2, 4, 7], dtype=np.int8)
    np.testing.assert_array_equal(bitpack.index_to_onehot(idx, num_classes),
                                  jax_bitpack.index_to_onehot(idx, num_classes))
