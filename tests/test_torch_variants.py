"""The port's ``VariantTable`` against the JAX package's.

Both tables are built from the same files: every eager and lazy column,
every predicate, both genotype forms, the phase queries and the typed INFO
and FORMAT getters must be equal, on a hand-made file of every record kind
and on the corpora, whole and restricted to a region.  The SNP mask must
agree with the tokenizer's under the rule the JAX package's test uses.
"""

import numpy as np
import pytest

from haplohyped_tpu.hostio.variants import VariantTable as JaxTable

from haplohyped_tpu_torch.hostio import VariantTable, native
from haplohyped_tpu_torch.hostio.bgzf import bgzf_write
from haplohyped_tpu_torch.hostio.writer import VcfHeader
from haplohyped_tpu_torch.ops.vcf_decode import decode_frames_numpy
from haplohyped_tpu_torch.ops.vcf_tokenize import tokenize_vcf_device
from haplohyped_tpu_torch.hostio.vcf import VCFSource

from tests.synth import make_corpus

KINDS = [
    "chr1\t100\trs1\tA\tG\t50\tPASS\tAC=1;AF=0.25;DB\tGT:DP\t0|1:30\t0|0:12\t1|1:5",
    "chr1\t200\t.\tC\tT\t.\tq10\tAC=2\tGT:DP\t1|1:7\t0/1:9\t./.:3",
    "chr1\t300\t.\tG\tA,T\t9.5\tPASS\t.\tGT\t1|2\t0|1\t2|2",
    "chr1\t350\t.\tG\tA,TT\t.\tPASS\t.\tGT\t1|2\t0|1\t0|0",
    "chr1\t400\t.\tTA\tT\t.\tPASS\t.\tGT\t0|1\t1|1\t0|0",
    "chr1\t500\t.\tT\tTGG\t.\tPASS\t.\tGT\t0|1\t.|.\t1",
    "chr1\t600\t.\tN\t<DEL>\t.\tPASS\tSVTYPE=DEL;END=700\tGT\t0|1\t0|0\t1|0",
    "chr1\t650\t.\tC\t.\t.\tPASS\t.\tGT\t0|0\t0|0\t0/0",
    "chr2\t10\t.\tA\tC\t.\tPASS\tAF=0.5,0.1\tDP:GT\t4:0|1\t5:1/0\t6:.|1",
    "chr2\t20\t.\tA\tC\t.\tPASS\tGENE=BRCA1\tDP\t4\t5\t6",
    "chr2\t30\t.\tA\tC\t.\tPASS\t.",
    "chr2\t40\t.\tA\tC",
]


def header() -> VcfHeader:
    h = VcfHeader("VCF4.2")
    for c in ("chr1", "chr2"):
        h.add_contig(c, length=100_000)
    h.add_filter("q10", "low qual")
    h.add_info("AC", "A", "Integer", "Allele count")
    h.add_info("AF", "A", "Float", "Allele frequency")
    h.add_info("DB", "0", "Flag", "dbSNP")
    h.add_info("SVTYPE", "1", "String", "SV type")
    h.add_info("END", "1", "Integer", "End")
    h.add_info("GENE", "1", "String", "Gene")
    h.add_format("GT", "1", "String", "Genotype")
    h.add_format("DP", "1", "Integer", "Depth")
    h.set_samples(["sA", "sB", "sC"])
    return h


@pytest.fixture(scope="module")
def files(tmp_path_factory, test_data_dir):
    d = tmp_path_factory.mktemp("vt")
    kinds = str(d / "kinds.vcf.gz")  # the writer refuses the 5-field line
    bgzf_write(kinds, (header().as_string() + "\n".join(KINDS) + "\n").encode())
    synth = make_corpus(str(d / "synth"), n_variants=400, n_samples=4, missing_rate=0.05,
                        indel_rate=0.1)
    return {"kinds": kinds, "corpus": str(test_data_dir / "chr22.filtered.vcf.gz"),
            "synth": synth["vcf"]}


def assert_equal(got, want, what):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got == want, what


COLUMNS = ["n", "pos", "start", "end", "chrom", "id", "ref", "alts", "qual", "filter", "info",
           "format_keys", "sample_fields", "samples"]
QUERIES = ["is_snp", "is_indel", "is_sv", "is_multiallelics", "is_multiallelic_snp",
           "ploidy", "gt_phase", "is_all_phased"]

REGIONS = [("kinds", None), ("kinds", "chr2"), ("kinds", "chr1:150-520"), ("kinds", "chr1:300-"),
           ("corpus", None), ("corpus", "chr22:100000-200000"), ("synth", None),
           ("synth", "chr22:5000-9000")]


@pytest.mark.parametrize("name,region", REGIONS)
def test_table_matches_jax(files, name, region):
    got = VariantTable.from_vcf(files[name], region=region)
    want = JaxTable.from_vcf(files[name], region=region)
    assert got.n > 0 and got.header.lines == want.header.lines
    for col in COLUMNS:
        assert_equal(getattr(got, col), getattr(want, col), col)
    for q in QUERIES:
        assert_equal(getattr(got, q)(), getattr(want, q)(), q)
    for presence in (False, True):
        assert_equal(got.genotypes(presence=presence), want.genotypes(presence=presence),
                     f"genotypes presence={presence}")


@pytest.mark.parametrize("tag", ["AC", "AF", "DB", "SVTYPE", "END", "GENE", "NOPE"])
def test_info_tag_matches_jax(files, tag):
    got, want = VariantTable.from_vcf(files["kinds"]), JaxTable.from_vcf(files["kinds"])
    assert_equal(got.info_tag(tag), want.info_tag(tag), tag)


@pytest.mark.parametrize("tag", ["GT", "DP", "NOPE"])
@pytest.mark.parametrize("region", [None, "chr2"])
def test_format_tag_matches_jax(files, tag, region):
    got = VariantTable.from_vcf(files["kinds"], region=region)
    want = JaxTable.from_vcf(files["kinds"], region=region)
    assert_equal(got.format_tag(tag), want.format_tag(tag), tag)


def test_kinds_fixture_answers(files):
    t = VariantTable.from_vcf(files["kinds"])
    assert t.n == len(KINDS) - 1  # the 5-field line is skipped, as the reference does
    np.testing.assert_array_equal(t.is_snp()[:4], [True, True, False, False])
    assert t.is_multiallelic_snp()[2] and not t.is_multiallelic_snp()[3]
    assert t.is_sv()[6] and t.is_indel()[4] and t.is_indel()[5]
    assert t.genotypes()[1, 2, 0] == -9 and tuple(t.genotypes(presence=True)[1, 2]) == (1, 0)


def test_snp_mask_matches_the_tokenizer(files):
    """The rule of the JAX package's ``test_snp_mask_matches_pipeline``:
    ``is_snp`` equals the decode's ``snp_mask`` and ``start`` its start, here
    against the port's tokenizer (on the CPU) and its 64-byte decode."""
    for name in ("corpus", "synth"):
        t = VariantTable.from_vcf(files[name])
        with native.vcf_text(files[name]) as vt:
            dec = tokenize_vcf_device(vt, None, device="cpu")
        np.testing.assert_array_equal(t.is_snp(), dec["snp_mask"])
        np.testing.assert_array_equal(t.start, dec["start"])
        fr = decode_frames_numpy(VCFSource(files[name]).frame().records, with_sample=False)
        np.testing.assert_array_equal(t.is_snp(), fr["snp_mask"])
