"""The port's per-donor converter against the JAX package's, file by file.

The port's ``VCFtoHDF5Converter(single_pass=False, device="cpu")`` runs the
decode kernels' plain versions; its final HDF5 must match the JAX
converter's deterministic ``device_decode=False`` file dataset by dataset:
names, dtype, shape, raw bytes, compressed chunks, and the filter with its
cd_values (Blosc 32001 where libblosc is present, gzip where not).
"""

import gzip
import os

import h5py
import numpy as np
import pytest
import torch

from haplohyped_tpu.pipeline.vcf_to_h5 import VCFtoHDF5Converter as JaxConverter

from haplohyped_tpu_torch.core.constants import COHORT_COMPRESSION_OPTS, SNP_STRUCT_DTYPE
from haplohyped_tpu_torch.pipeline import vcf_to_h5
from haplohyped_tpu_torch.pipeline.vcf_to_h5 import VCFtoHDF5Converter, main
from haplohyped_tpu_torch.storage.blosc import blosc_available

from tests.synth import make_corpus
from tests.test_vcf_decode import corpus_samples


def convert(cls, vcf_dir, samples, out_dir, chromosomes, **kw):
    conv = cls("co", str(vcf_dir), str(out_dir), str(samples), cores=2, cxx_threads=2,
               chromosomes=chromosomes, single_pass=False, **kw)
    return conv, conv.run()


def port(vcf_dir, samples, out_dir, chromosomes, **kw):
    return convert(VCFtoHDF5Converter, vcf_dir, samples, out_dir, chromosomes,
                   device="cpu", **kw)


def jax(vcf_dir, samples, out_dir, chromosomes):
    return convert(JaxConverter, vcf_dir, samples, out_dir, chromosomes, device_decode=False)


def datasets(path) -> dict:
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                chunks = [obj.id.read_direct_chunk((i,))[1]
                          for i in range(0, obj.shape[0], obj.chunks[0])] if obj.chunks else []
                out[name] = (obj.dtype, obj.shape, obj[()].tobytes(), dict(obj._filters),
                             obj.chunks, chunks)
        f.visititems(visit)
    return out


def assert_same_file(got_path, want_path):
    got, want = datasets(got_path), datasets(want_path)
    assert sorted(got) == sorted(want) and got
    for name in want:
        for what, g, w in zip(("dtype", "shape", "bytes", "filters", "chunks", "chunk bytes"),
                              got[name], want[name]):
            assert g == w, f"{name}: {what}"
        filters = got[name][3]
        if blosc_available():
            assert tuple(filters["32001"][4:]) == COHORT_COMPRESSION_OPTS[4:]
        else:
            assert "gzip" in filters


def assert_ok(results, n):
    assert len(results) == n and not any(r.error for r in results)


@pytest.mark.parametrize("device_decode", [True, False])
def test_corpus_matches_jax(test_data_dir, tmp_path, device_decode):
    samples = test_data_dir / "ipscs_samples_test.txt"
    conv, res = port(test_data_dir, samples, tmp_path / "port", [22], device_decode=device_decode)
    jconv, jres = jax(test_data_dir, samples, tmp_path / "jax", [22])
    assert_ok(res, 3)
    assert {(r.donor_id, r.n_records, r.n_snps) for r in res} == \
        {(r.donor_id, r.n_records, r.n_snps) for r in jres}
    assert_same_file(conv.config.final_h5_path, jconv.config.final_h5_path)
    assert not os.path.exists(conv.tmp_dir)  # cleaned up after a clean run


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """tests/synth.py corpus: 5 donors, indels, missing genotypes."""
    return make_corpus(str(tmp_path_factory.mktemp("synth")), n_variants=2000,
                       n_samples=5, seed=3, missing_rate=0.05, indel_rate=0.1)


@pytest.mark.parametrize("device_decode", [True, False])
def test_synth_corpus_matches_jax(synth, tmp_path, device_decode):
    conv, res = port(synth["dir"], synth["samples_file"], tmp_path / "port",
                     [synth["chrom_num"]], device_decode=device_decode)
    jconv, _ = jax(synth["dir"], synth["samples_file"], tmp_path / "jax", [synth["chrom_num"]])
    assert_ok(res, 5)
    assert_same_file(conv.config.final_h5_path, jconv.config.final_h5_path)
    with h5py.File(conv.config.final_h5_path, "r") as f:
        d = f[f"donor_{synth['samples'][0]}/chr_{synth['chrom_num']}/snp_data"][()]
    assert d.dtype == SNP_STRUCT_DTYPE
    assert len(d) == len(synth["truth"])
    np.testing.assert_array_equal(d["start"], [t[0] for t in synth["truth"]])
    np.testing.assert_array_equal(d["phase1"], [t[3][0][0] for t in synth["truth"]])


@pytest.fixture(scope="module")
def many_contigs(tmp_path_factory):
    """chr1.filtered.vcf.gz with chr1 records interleaved with 299 other
    contigs, 3 donors."""
    d = tmp_path_factory.mktemp("ctg300")
    rng = np.random.default_rng(5)
    donors = ["d0", "d1", "d2"]
    rows = ["##fileformat=VCFv4.2",
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t" + "\t".join(donors)]
    gts = np.array(["0|0", "0|1", "1|0", "1|1", "./.", "0/1"])
    for i in range(900):
        chrom = "chr1" if i % 3 == 0 else f"ctg{i % 299}"
        ref, alt = rng.choice(list("ACGT"), 2, replace=False)
        alt = alt if i % 7 else "AT"
        rows.append(f"{chrom}\t{1000 + 10 * i}\t.\t{ref}\t{alt}\t.\tPASS\t.\tGT\t"
                    + "\t".join(rng.choice(gts, 3)))
    with gzip.open(d / "chr1.filtered.vcf.gz", "wt") as f:
        f.write("\n".join(rows) + "\n")
    (d / "samples.txt").write_text("\n".join(donors) + "\n")
    return d


def test_many_contigs_matches_jax(many_contigs, tmp_path):
    samples = many_contigs / "samples.txt"
    conv, res = port(many_contigs, samples, tmp_path / "port", [1])
    jconv, _ = jax(many_contigs, samples, tmp_path / "jax", [1])
    assert_ok(res, 3)
    assert_same_file(conv.config.final_h5_path, jconv.config.final_h5_path)


@pytest.mark.parametrize("donor", ["d0", "d1", "d2"])
def test_many_contigs_without_region_takes_the_64_byte_route(many_contigs, tmp_path,
                                                            monkeypatch, donor):
    """Framing every contig of a >255-contig file: the 12-byte framer
    refuses, the decode64 wrapper runs, and the struct equals the JAX
    converter's for the same parse."""
    calls = []
    wrapped = vcf_to_h5.decode_frames_kernel
    monkeypatch.setattr(vcf_to_h5, "decode_frames_kernel",
                        lambda *a, **k: calls.append(a[0].shape) or wrapped(*a, **k))
    samples = many_contigs / "samples.txt"
    path = str(many_contigs / "chr1.filtered.vcf.gz")
    conv = VCFtoHDF5Converter("co", str(many_contigs), str(tmp_path / "p"), str(samples), 1, 1,
                              single_pass=False, device="cpu")
    got, n = conv.parse_snps(path, donor, None)
    assert calls == [(900, 64)]
    jconv = JaxConverter("co", str(many_contigs), str(tmp_path / "j"), str(samples), 1, 1,
                         single_pass=False, device_decode=False)
    want, jn = jconv._parse_snps(path, donor, None)
    assert n == jn == 900
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert {b"chr1", b"ctg1", b"ctg29"} <= set(got["chrom"])  # every contig, cut to S5


def test_parse_snps_without_device_decode_matches_kernel_route(test_data_dir, tmp_path):
    samples = test_data_dir / "ipscs_samples_test.txt"
    path = str(test_data_dir / "chr22.filtered.vcf.gz")
    a = VCFtoHDF5Converter("co", str(test_data_dir), str(tmp_path / "a"), str(samples), 1, 1,
                           single_pass=False, device="cpu")
    b = VCFtoHDF5Converter("co", str(test_data_dir), str(tmp_path / "b"), str(samples), 1, 1,
                           single_pass=False, device="cpu", device_decode=False)
    for donor in corpus_samples(test_data_dir):
        (sa, na), (sb, nb) = a.parse_snps(path, donor, "chr22"), b.parse_snps(path, donor, "chr22")
        assert sa.tobytes() == sb.tobytes() and na == nb == 1000


def test_empty_frame_decodes_on_the_host(tmp_path, monkeypatch):
    d = tmp_path / "vcf"
    d.mkdir()
    with gzip.open(d / "chr2.filtered.vcf.gz", "wt") as f:
        f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\t"
                "FORMAT\ts1\nchr1\t5\t.\tA\tG\t.\tPASS\t.\tGT\t0|1\n")
    (d / "s.txt").write_text("s1\n")
    monkeypatch.setattr(vcf_to_h5, "decode_frames12_kernel",
                        lambda *a, **k: pytest.fail("launched on an empty frame"))
    conv, res = port(d, d / "s.txt", tmp_path / "out", [2])
    assert_ok(res, 1)
    assert res[0].n_snps == 0 and res[0].n_records == 1


def test_resume_skips_existing(test_data_dir, tmp_path):
    conv = VCFtoHDF5Converter("rc", str(test_data_dir), str(tmp_path),
                              str(test_data_dir / "ipscs_samples_test.txt"), 1, 1,
                              chromosomes=[22], resume=True, single_pass=False, device="cpu")
    sample0 = corpus_samples(test_data_dir)[0]
    r1 = conv.genotype_vcf_to_hdf5(conv.config.vcf_path(22), sample0, 22)
    assert not r1.skipped and r1.n_snps == 1000
    r2 = conv.genotype_vcf_to_hdf5(conv.config.vcf_path(22), sample0, 22)
    assert r2.skipped
    res = conv.run()
    assert sorted(r.skipped for r in res) == [False, False, True]
    with h5py.File(conv.config.final_h5_path, "r") as f:
        assert len(f.keys()) == 3


def test_missing_vcf_is_recorded(test_data_dir, tmp_path):
    conv, res = port(tmp_path, test_data_dir / "ipscs_samples_test.txt", tmp_path / "out", [22])
    assert len(res) == 3 and all(r.error is not None and r.chromosome == "*" for r in res)
    assert os.path.exists(conv.tmp_dir)  # kept for a resume
    with pytest.raises(FileNotFoundError):
        conv.process_donor(corpus_samples(test_data_dir)[0])


def test_one_bad_donor_does_not_sink_cohort(test_data_dir, tmp_path):
    samples = corpus_samples(test_data_dir)
    sample_file = tmp_path / "samples.txt"
    sample_file.write_text(f"{samples[0]}\ndonor-that-does-not-exist\n")
    conv, res = port(test_data_dir, sample_file, tmp_path / "out", [22])
    errs = [r for r in res if r.error is not None]
    assert [r.donor_id for r in errs] == ["donor-that-does-not-exist"]
    with h5py.File(conv.config.final_h5_path, "r") as f:
        assert list(f.keys()) == [f"donor_{samples[0]}"]


def test_cuda_without_a_card_raises(test_data_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        VCFtoHDF5Converter("co", str(test_data_dir), str(tmp_path),
                           str(test_data_dir / "ipscs_samples_test.txt"), 1, 1,
                           single_pass=False)
    assert not os.path.exists(tmp_path / "tmp_files")


def test_cli_per_donor_on_the_cpu(test_data_dir, tmp_path):
    """The CLI on its default flags (single pass, direct write) and with
    ``--per-donor`` write the same file; a directory with no VCF exits."""
    args = ["--cohort_name", "cli", "--vcf", str(test_data_dir), "--outdir", str(tmp_path / "sp"),
            "--sample_list", str(test_data_dir / "ipscs_samples_test.txt"), "--cores", "2",
            "--cxx_threads", "2", "--device", "cpu"]
    main(args)
    per_donor = args[:5] + [str(tmp_path / "pd")] + args[6:] + ["--per-donor"]
    main(per_donor)
    with h5py.File(tmp_path / "pd" / "cli.h5", "r") as f:
        assert len(f.keys()) == 3
        assert all(f[k]["chr_22/snp_data"].shape == (1000,) for k in f.keys())
    assert_same_file(tmp_path / "sp" / "cli.h5", tmp_path / "pd" / "cli.h5")
    for flags in ([], ["--per-donor"]):
        with pytest.raises(SystemExit):
            main(args[:3] + [str(tmp_path / "none")] + args[4:] + flags)
