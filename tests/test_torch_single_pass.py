"""The port's single-pass converter against the JAX package's and its own
per-donor path.

``VCFtoHDF5Converter(..., device="cpu")`` on its default flags (single pass,
direct write) must write the JAX package's single-pass file (numpy decode)
dataset by dataset: names, dtype, shape, values, chunks, the compressed
chunks and the filter with its cd_values; and the port's per-donor file.  A
100-donor chromosome is framed once (the port's ``DECOMPRESS_COUNT``).
"""

import os
import sys

import h5py
import numpy as np
import pytest

from haplohyped_tpu.hostio.bgzf import bgzf_write
from haplohyped_tpu.pipeline.vcf_to_h5 import VCFtoHDF5Converter as JaxConverter

from haplohyped_tpu_torch.hostio import native
from haplohyped_tpu_torch.pipeline import vcf_to_h5
from haplohyped_tpu_torch.pipeline.vcf_to_h5 import VCFtoHDF5Converter, main

from tests.synth import make_corpus
from tests.test_torch_convert import assert_ok, assert_same_file

GTS = np.array(["0|0", "0|1", "1|0", "1|1", "./.", "0/1", "1|2"])


def write_cohort(d, donors, chroms, n_variants, seed, empty_donor=None):
    """BGZF ``chr{N}.filtered.vcf.gz`` for each of ``chroms`` with
    ``n_variants`` records (SNVs, some indels and multi-allelic sites) and
    ``donors`` genotypes; ``empty_donor`` (if any) gets only '.' (a haploid
    missing call, which no SNP struct keeps)."""
    rng = np.random.default_rng(seed)
    bases = np.array(list("ACGT"))
    for c in chroms:
        pos = np.cumsum(rng.integers(10, 70_000, size=n_variants)) + 100
        refs = bases[rng.integers(0, 4, size=n_variants)]
        alts = bases[(np.searchsorted(bases, refs) + rng.integers(1, 4, n_variants)) % 4].astype(
            object)
        alts[rng.random(n_variants) < 0.05] = "AT"
        alts[rng.random(n_variants) < 0.03] = "A,C"
        gts = GTS[rng.integers(0, len(GTS), size=(n_variants, len(donors)))]
        if empty_donor is not None:
            gts[:, donors.index(empty_donor)] = "."
        rows = ["##fileformat=VCFv4.2", f"##contig=<ID=chr{c},length=400000000>",
                '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
                "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t" + "\t".join(donors)]
        rows += [f"chr{c}\t{pos[i]}\t.\t{refs[i]}\t{alts[i]}\t.\tPASS\t.\tGT\t"
                 + "\t".join(gts[i]) for i in range(n_variants)]
        bgzf_write(str(d / f"chr{c}.filtered.vcf.gz"), ("\n".join(rows) + "\n").encode())
    (d / "samples.txt").write_text("\n".join(donors) + "\n")
    return d


@pytest.fixture(scope="module")
def cohort100(tmp_path_factory):
    donors = [f"donor-{i:04d}" for i in range(100)]
    return write_cohort(tmp_path_factory.mktemp("c100"), donors, [1], 5_000, seed=11)


@pytest.fixture(scope="module")
def cohort2(tmp_path_factory):
    """12 donors on chr1 and chr2 (one donor with no kept SNP)."""
    donors = [f"d{i}" for i in range(12)]
    return write_cohort(tmp_path_factory.mktemp("c2"), donors, [1, 2], 3_000, seed=12,
                        empty_donor="d5")


def port(vcf_dir, out_dir, chromosomes, samples=None, **kw):
    kw = dict(cores=2, cxx_threads=2, chromosomes=chromosomes, device="cpu") | kw
    conv = VCFtoHDF5Converter("co", str(vcf_dir), str(out_dir),
                              str(samples or vcf_dir / "samples.txt"), **kw)
    return conv, conv.run()


def jax_single_pass(vcf_dir, out_dir, chromosomes, samples=None):
    conv = JaxConverter("co", str(vcf_dir), str(out_dir), str(samples or vcf_dir / "samples.txt"),
                        cores=2, cxx_threads=2, chromosomes=chromosomes, device_decode=False)
    res = conv.run()
    assert not any(r.error for r in res)
    return conv.config.final_h5_path


@pytest.mark.parametrize("device_decode", [True, False])
def test_corpus_matches_jax_and_per_donor(test_data_dir, tmp_path, device_decode):
    samples = test_data_dir / "ipscs_samples_test.txt"
    conv, res = port(test_data_dir, tmp_path / "sp", [22], samples, device_decode=device_decode)
    assert_ok(res, 3)
    assert {r.n_snps for r in res} == {1000} and {r.n_records for r in res} == {1000}
    assert_same_file(conv.config.final_h5_path,
                     jax_single_pass(test_data_dir, tmp_path / "jax", [22], samples))
    pd, _ = port(test_data_dir, tmp_path / "pd", [22], samples, single_pass=False)
    assert_same_file(conv.config.final_h5_path, pd.config.final_h5_path)
    assert not os.path.exists(conv.tmp_dir)


def test_synth_corpus_matches_jax(tmp_path):
    synth = make_corpus(str(tmp_path / "synth"), n_variants=2000, n_samples=5, seed=3,
                        missing_rate=0.05, indel_rate=0.1)
    d = tmp_path / "synth"
    conv, res = port(d, tmp_path / "sp", [22])
    assert_ok(res, 5)
    assert_same_file(conv.config.final_h5_path, jax_single_pass(d, tmp_path / "jax", [22]))
    with h5py.File(conv.config.final_h5_path, "r") as f:
        got = f[f"donor_{synth['samples'][0]}/chr_22/snp_data"][()]
    np.testing.assert_array_equal(got["start"], [t[0] for t in synth["truth"]])


@pytest.mark.parametrize("device_decode", [True, False])
def test_two_chromosomes_match_jax_and_per_donor(cohort2, tmp_path, device_decode):
    """Two chromosome tasks on the thread pool, 12 donors, one of them
    without any kept SNP: its datasets are empty.  The JAX package fails
    that donor (its struct assembly raises on an empty struct), so the JAX
    file is compared without it."""
    conv, res = port(cohort2, tmp_path / "sp", [1, 2], device_decode=device_decode)
    assert_ok(res, 24)
    empty = [r for r in res if r.donor_id == "d5"]
    assert len(empty) == 2 and all(r.n_snps == 0 and r.n_records == 3_000 for r in empty)
    with h5py.File(conv.config.final_h5_path, "r") as f:
        for c in (1, 2):
            ds = f[f"donor_d5/chr_{c}/snp_data"]
            assert ds.shape == (0,) and ds.dtype == f[f"donor_d0/chr_{c}/snp_data"].dtype
    pd, pres = port(cohort2, tmp_path / "pd", [1, 2], single_pass=False)
    assert_ok(pres, 24)
    assert_same_file(conv.config.final_h5_path, pd.config.final_h5_path)

    others = cohort2 / "samples11.txt"
    others.write_text("\n".join(f"d{i}" for i in range(12) if i != 5) + "\n")
    sp11, _ = port(cohort2, tmp_path / "sp11", [1, 2], others)
    assert_same_file(sp11.config.final_h5_path,
                     jax_single_pass(cohort2, tmp_path / "jax", [1, 2], others))


def test_one_decompression_for_100_donors(cohort100, tmp_path):
    before = native.DECOMPRESS_COUNT
    conv, res = port(cohort100, tmp_path, [1])
    assert native.DECOMPRESS_COUNT - before == 1
    assert_ok(res, 100)
    with h5py.File(conv.config.final_h5_path, "r") as f:
        assert len(f.keys()) == 100 and f["donor_donor-0000/chr_1/snp_data"].shape[0] > 0


def test_per_donor_path_frames_once_per_donor(cohort100, tmp_path):
    ten = cohort100 / "samples10.txt"
    ten.write_text("\n".join(f"donor-{i:04d}" for i in range(10)) + "\n")
    before = native.DECOMPRESS_COUNT
    _, res = port(cohort100, tmp_path, [1], ten, single_pass=False)
    assert_ok(res, 10)
    assert native.DECOMPRESS_COUNT - before == 10


def test_100_donors_match_jax(cohort100, tmp_path):
    conv, _ = port(cohort100, tmp_path / "sp", [1])
    assert_same_file(conv.config.final_h5_path, jax_single_pass(cohort100, tmp_path / "jax", [1]))


def test_direct_write_equals_merge_write(cohort2, tmp_path):
    direct, res = port(cohort2, tmp_path / "dw", [1, 2])
    merged, mres = port(cohort2, tmp_path / "mw", [1, 2], direct_write=False)
    assert_ok(res, 24)
    assert_ok(mres, 24)
    assert not os.path.exists(direct.tmp_dir) or not os.listdir(direct.tmp_dir)
    assert_same_file(direct.config.final_h5_path, merged.config.final_h5_path)


def test_resume_skips_existing_shards(cohort100, tmp_path):
    conv = VCFtoHDF5Converter("spr", str(cohort100), str(tmp_path), str(cohort100 / "samples.txt"),
                              2, 2, chromosomes=[1], resume=True, device="cpu")
    with h5py.File(conv.tmp_h5_path("donor-0007", 1), "w") as f:
        f.create_group("donor_donor-0007/chr_1")
    results = conv.run(cleanup=False)
    assert [r.donor_id for r in results if r.skipped] == ["donor-0007"]
    assert len([r for r in results if not r.skipped and not r.error]) == 99
    assert len(os.listdir(conv.tmp_dir)) == 100  # the shards, kept for a later resume


def test_missing_donor_is_isolated(cohort100, tmp_path):
    bad = tmp_path / "samples_bad.txt"
    bad.write_text("\n".join([f"donor-{i:04d}" for i in range(5)] + ["ghost-donor"]) + "\n")
    conv, res = port(cohort100, tmp_path / "out", [1], bad)
    errs = [r for r in res if r.error]
    assert [r.donor_id for r in errs] == ["ghost-donor"]
    assert "sample not found in VCF header" in str(errs[0].error)
    with h5py.File(conv.config.final_h5_path, "r") as f:
        assert len(f.keys()) == 5


def test_missing_chromosome_file_is_recorded(cohort2, tmp_path):
    conv, res = port(cohort2, tmp_path / "out", [1, 3])
    errs = [r for r in res if r.error]
    assert [(r.donor_id, r.chromosome) for r in errs] == [("*", 3)]
    assert sum(1 for r in res if not r.error) == 12


def test_failed_direct_run_then_resume(cohort2, tmp_path, monkeypatch):
    """A direct-write run that fails one write leaves an incomplete file;
    resume redoes every task through temp shards and rebuilds it whole."""
    real, calls = vcf_to_h5.write_dataset_direct, {"n": 0}

    def flaky(group, name, data, kw, workers=4):
        calls["n"] += 1
        if calls["n"] == 3:
            raise OSError("injected disk failure")
        return real(group, name, data, kw, workers=workers)

    monkeypatch.setattr(vcf_to_h5, "write_dataset_direct", flaky)
    _, res = port(cohort2, tmp_path / "out", [1], cores=1)
    assert sum(1 for r in res if r.error) == 1
    monkeypatch.setattr(vcf_to_h5, "write_dataset_direct", real)
    resumed, res = port(cohort2, tmp_path / "out", [1], cores=1, resume=True)
    assert_ok(res, 12)
    clean, _ = port(cohort2, tmp_path / "clean", [1], cores=1)
    assert_same_file(resumed.config.final_h5_path, clean.config.final_h5_path)


def test_convert_chromosome_with_a_writer_needs_no_h5py(cohort2, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)  # import h5py now raises
    conv = VCFtoHDF5Converter("co", str(cohort2), str(tmp_path), str(cohort2 / "samples.txt"), 1,
                              2, device="cpu")
    got = {}
    res = conv.convert_chromosome(2, writer=lambda d, c, s: got.setdefault((d, c), s))
    assert_ok(res, 12)
    assert sorted(got) == sorted((f"d{i}", 2) for i in range(12))
    with pytest.raises(ImportError):
        conv.run()
    monkeypatch.delitem(sys.modules, "h5py")
    for donor in ("d0", "d5", "d11"):
        want, n = conv.parse_snps(conv.config.vcf_path(2), donor, "chr2")
        assert n == 3_000 and got[(donor, 2)].tobytes() == want.tobytes()


def test_cli_default_flags(test_data_dir, tmp_path):
    args = ["--cohort_name", "cli", "--vcf", str(test_data_dir), "--outdir", str(tmp_path / "sp"),
            "--sample_list", str(test_data_dir / "ipscs_samples_test.txt"), "--cores", "2",
            "--cxx_threads", "2", "--device", "cpu"]
    main(args)
    main(args[:5] + [str(tmp_path / "pd")] + args[6:] + ["--per-donor"])
    assert_same_file(tmp_path / "sp" / "cli.h5", tmp_path / "pd" / "cli.h5")
    assert not os.path.exists(tmp_path / "sp" / "tmp_files")
