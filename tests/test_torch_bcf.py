"""The port's BCF input against the JAX package's.

The native BCF parser's bindings (``bcf_parse``, ``bcf_parse_v2``,
``bcf_samples``) and ``is_bcf`` and their decode schemas must equal the JAX
package's column by column; a BCF cohort must convert, single pass and per
donor, to the JAX package's file and to the port's file of the same records
as a VCF; a BCF of more than 255 contigs falls back to the per-donor path
and its shards are merged into the direct-write file.
"""

import gzip
import shutil

import numpy as np
import pytest

from haplohyped_tpu.hostio import bcf as jax_bcf
from haplohyped_tpu.hostio import native as jax_native
from haplohyped_tpu.pipeline.vcf_to_h5 import VCFtoHDF5Converter as JaxConverter

from haplohyped_tpu_torch.hostio import bcf, native
from haplohyped_tpu_torch.pipeline.vcf_to_h5 import VCFtoHDF5Converter

from tests.bcf_writer import vcf_text_to_bcf
from tests.synth import make_corpus
from tests.test_torch_convert import assert_ok, assert_same_file
from tests.test_torch_decode import assert_columns_equal


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(str(tmp_path_factory.mktemp("bcf")), n_variants=400, n_samples=4,
                       missing_rate=0.05, indel_rate=0.1)


@pytest.fixture(scope="module")
def bcf_dir(corpus, tmp_path_factory):
    """The corpus as a BCF under the converter's file name."""
    d = tmp_path_factory.mktemp("bcf_dir")
    vcf_text_to_bcf(corpus["vcf"], str(d / "chr22.filtered.vcf.gz"))
    shutil.copy(corpus["samples_file"], d / "samples.txt")
    return d


def test_detection_and_samples(corpus, bcf_dir, tmp_path):
    path = str(bcf_dir / "chr22.filtered.vcf.gz")
    plain = tmp_path / "plain.bcf"
    plain.write_bytes(b"BCF\x02\x02" + b"\0" * 32)
    for p in (path, str(plain)):
        assert bcf.is_bcf(p) and jax_native.is_bcf(p)
    for p in (corpus["vcf"], corpus["fasta"]):
        assert not bcf.is_bcf(p) and not jax_native.is_bcf(p)
    assert not jax_native.is_bcf(str(tmp_path / "missing.bcf"))
    with pytest.raises(FileNotFoundError):
        bcf.is_bcf(str(tmp_path / "missing.bcf"))
    assert bcf.bcf_samples(path) == jax_native.bcf_samples(path) == corpus["samples"]
    with pytest.raises(RuntimeError, match="not a BCF2"):
        native.bcf_samples(corpus["vcf"])


@pytest.mark.parametrize("sample", [None, 0, 3])
def test_decoded_columns_match_jax(corpus, bcf_dir, sample):
    path = str(bcf_dir / "chr22.filtered.vcf.gz")
    name = None if sample is None else corpus["samples"][sample]
    got, want = bcf.bcf_decoded_columns(path, name, 2), jax_bcf.bcf_decoded_columns(path, name, 2)
    assert list(got) == list(want)
    assert_columns_equal(got, want, f"bcf_decoded_columns {name}")
    raw, jraw = native.bcf_parse(path, name), jax_native.bcf_parse(path, name)
    assert raw["contigs"] == jraw["contigs"] == ["chr22"]
    assert_columns_equal({k: v for k, v in raw.items() if k != "contigs"},
                         {k: v for k, v in jraw.items() if k != "contigs"}, "bcf_parse")


@pytest.mark.parametrize("order", ["all", "reversed", "one", "none"])
def test_decoded_v2_matches_jax(corpus, bcf_dir, order):
    path = str(bcf_dir / "chr22.filtered.vcf.gz")
    s = corpus["samples"]
    samples = {"all": s, "reversed": s[::-1], "one": s[1:2], "none": []}[order]
    (got, contigs), (want, jcontigs) = (m.bcf_decoded_v2(path, samples, 2) for m in (bcf, jax_bcf))
    assert contigs == jcontigs == ["chr22"] and list(got) == list(want)
    assert_columns_equal(got, want, f"bcf_decoded_v2 {order}")
    assert got["phase1"].shape == (400, len(samples))
    with pytest.raises(RuntimeError, match="sample not found"):
        bcf.bcf_decoded_v2(path, s[:1] + ["ghost"])


def convert(cls, vcf_dir, out_dir, samples, **kw):
    conv = cls("co", str(vcf_dir), str(out_dir), str(samples), 1, 1, chromosomes=[22], **kw)
    res = conv.run()
    return conv, res


@pytest.mark.parametrize("single_pass", [True, False])
def test_bcf_cohort_matches_jax_and_vcf(corpus, bcf_dir, tmp_path, single_pass):
    samples = bcf_dir / "samples.txt"
    conv, res = convert(VCFtoHDF5Converter, bcf_dir, tmp_path / "bcf", samples,
                        single_pass=single_pass, device="cpu")
    assert_ok(res, 4)
    jconv, jres = convert(JaxConverter, bcf_dir, tmp_path / "jax", samples,
                          single_pass=single_pass, device_decode=False)
    assert_ok(jres, 4)
    assert_same_file(conv.config.final_h5_path, jconv.config.final_h5_path)
    vconv, vres = convert(VCFtoHDF5Converter, corpus["dir"], tmp_path / "vcf", samples,
                          device="cpu")
    assert_ok(vres, 4)
    assert_same_file(conv.config.final_h5_path, vconv.config.final_h5_path)


def test_bcf_single_pass_reads_the_file_once(bcf_dir, tmp_path, monkeypatch):
    calls = []
    real = native.bcf_parse_v2
    monkeypatch.setattr(native, "bcf_parse_v2", lambda *a: calls.append(a[0]) or real(*a))
    monkeypatch.setattr(native, "bcf_parse", lambda *a: pytest.fail("per-donor parse"))
    _, res = convert(VCFtoHDF5Converter, bcf_dir, tmp_path, bcf_dir / "samples.txt",
                     device="cpu")
    assert_ok(res, 4)
    assert len(calls) == 1


def test_bcf_past_255_contigs_takes_the_per_donor_path(tmp_path):
    """300 contigs overflow the chrom-id table: each donor is parsed alone
    into a temp shard, and the shards are merged into the direct-write
    file; the result equals the JAX package's."""
    rng = np.random.default_rng(8)
    donors = ["a", "b", "c"]
    rows = ["##fileformat=VCFv4.2"] + [f"##contig=<ID=ctg{i},length=10000>" for i in range(299)]
    rows += ["##contig=<ID=chr22,length=100000>",
             '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t" + "\t".join(donors)]
    gts = np.array(["0|0", "0|1", "1|0", "1|1", "./."])
    for i in range(600):
        chrom = "chr22" if i % 2 else f"ctg{i % 299}"
        ref, alt = rng.choice(list("ACGT"), 2, replace=False)
        rows.append(f"{chrom}\t{100 + i}\t.\t{ref}\t{alt}\t.\tPASS\t.\tGT\t"
                    + "\t".join(rng.choice(gts, 3)))
    vcf = tmp_path / "ctg.vcf.gz"
    with gzip.open(vcf, "wt") as f:
        f.write("\n".join(rows) + "\n")
    d = tmp_path / "in"
    d.mkdir()
    vcf_text_to_bcf(str(vcf), str(d / "chr22.filtered.vcf.gz"))
    (d / "samples.txt").write_text("\n".join(donors) + "\n")
    conv, res = convert(VCFtoHDF5Converter, d, tmp_path / "port", d / "samples.txt", device="cpu")
    assert_ok(res, 3)
    assert {r.n_snps for r in res} == {300}
    jconv, _ = convert(JaxConverter, d, tmp_path / "jax", d / "samples.txt", device_decode=False)
    assert_same_file(conv.config.final_h5_path, jconv.config.final_h5_path)


def test_per_donor_bcf_parse_matches_jax(corpus, bcf_dir, tmp_path):
    path = str(bcf_dir / "chr22.filtered.vcf.gz")
    conv = VCFtoHDF5Converter("co", str(bcf_dir), str(tmp_path / "p"),
                              str(bcf_dir / "samples.txt"), 1, 1, device="cpu")
    jconv = JaxConverter("co", str(bcf_dir), str(tmp_path / "j"), str(bcf_dir / "samples.txt"),
                         1, 1, device_decode=False)
    for donor in corpus["samples"]:
        (got, n), (want, jn) = conv.parse_snps(path, donor, "chr22"), jconv._parse_snps(
            path, donor, "chr22")
        assert n == jn == 400 and got.tobytes() == want.tobytes() and len(got) > 300
