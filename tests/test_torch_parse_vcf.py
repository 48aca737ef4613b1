"""The port's ``parse_vcf`` loaders and the small leftovers against the JAX
package's: ``load_vcf`` and ``load_vcf_without_sample`` (module functions
and ``VCFLoader``) give the same tuples, and ``chrom_list``,
``reference_dataset_path`` and ``__version__`` the same values."""

import pytest

import haplohyped_tpu
from haplohyped_tpu import parse_vcf as jax_parse_vcf
from haplohyped_tpu.core.config import chrom_list as jax_chrom_list
from haplohyped_tpu.core.constants import reference_dataset_path as jax_reference_dataset_path

import haplohyped_tpu_torch
from haplohyped_tpu_torch import parse_vcf
from haplohyped_tpu_torch.core.config import chrom_list
from haplohyped_tpu_torch.core.constants import reference_dataset_path

from tests.synth import make_corpus
from tests.test_vcf_decode import corpus_samples


@pytest.fixture(scope="module")
def files(test_data_dir, tmp_path_factory):
    synth = make_corpus(str(tmp_path_factory.mktemp("pv")), n_variants=300, n_samples=3,
                        missing_rate=0.05, indel_rate=0.1)
    return {"corpus": (str(test_data_dir / "chr22.filtered.vcf.gz"),
                       corpus_samples(test_data_dir)),
            "synth": (synth["vcf"], synth["samples"])}


@pytest.mark.parametrize("chrom", ["", "chr22", "chr22:5000-15000"])
@pytest.mark.parametrize("name", ["corpus", "synth"])
def test_load_vcf_matches_jax(files, name, chrom):
    path, samples = files[name]
    for sample in samples:
        got = parse_vcf.load_vcf(path, sample, chrom)
        assert got == jax_parse_vcf.load_vcf(path, sample, chrom)
        assert got == parse_vcf.VCFLoader.load_vcf(path, sample, chrom)
    got = parse_vcf.load_vcf_without_sample(path, chrom)
    assert got == jax_parse_vcf.load_vcf_without_sample(path, chrom)
    assert got == parse_vcf.VCFLoader.load_vcf_without_sample(path, chrom)
    assert len(got) > 0 and all(len(t) == 5 for t in got)


def test_load_vcf_of_no_record(files):
    """A region without records: the port returns no tuple; the JAX package
    raises in ``_set_u32`` on the empty struct (a fault the port fixes)."""
    path, samples = files["corpus"]
    assert parse_vcf.load_vcf(path, samples[0], "chr1") == []
    assert parse_vcf.load_vcf_without_sample(path, "chr1") == []
    with pytest.raises(ValueError):
        jax_parse_vcf.load_vcf(path, samples[0], "chr1")


def test_load_vcf_tuples(files):
    path, samples = files["corpus"]
    rows = parse_vcf.load_vcf(path, samples[0], "chr22")
    assert len(rows) == 1000 and rows[0][0] == "chr22"
    assert all(len(t) == 7 and t[2] == t[1] + 1 and t[5] in (0, 1) for t in rows)


@pytest.mark.parametrize("chroms", [[1, 22], ["chr2", "X"], (), ["3", "chrY", 7]])
def test_chrom_list_matches_jax(chroms):
    assert chrom_list(chroms) == jax_chrom_list(chroms)


@pytest.mark.parametrize("chrom", ["chr1", "chr22", "chrX"])
def test_reference_dataset_path_matches_jax(chrom):
    assert reference_dataset_path(chrom) == jax_reference_dataset_path(chrom) == f"{chrom}/sequence"


def test_version_matches_jax():
    assert haplohyped_tpu_torch.__version__ == haplohyped_tpu.__version__
