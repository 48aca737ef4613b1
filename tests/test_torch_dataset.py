"""The port's host ``RandomHaplotypeDataset`` and ``encode_haplotypes_host``
against the JAX package's, on the corpus artifacts of
``tests/test_dataset.py`` (the JAX converter's cohort file and FASTA
encoder's reference file); and the port's sampler windows against the port
dataset's encode on the same (donor, chrom, start)."""

import numpy as np
import pytest
import torch

from haplohyped_tpu.core.config import FastaEncodeConfig
from haplohyped_tpu.data import RandomHaplotypeDataset as JaxRandomHaplotypeDataset
from haplohyped_tpu.data.haplotype_dataset import (
    encode_haplotypes_host as jax_encode_haplotypes_host,
)
from haplohyped_tpu.pipeline.fasta_encoder import encode_fasta
from haplohyped_tpu.pipeline.vcf_to_h5 import VCFtoHDF5Converter
from haplohyped_tpu_torch.core.config import SamplerConfig
from haplohyped_tpu_torch.core.constants import BASE_LUT, SNP_STRUCT_DTYPE
from haplohyped_tpu_torch.data import DeviceHaplotypeSampler, RandomHaplotypeDataset
from haplohyped_tpu_torch.data.haplotype_dataset import encode_haplotypes_host
from haplohyped_tpu_torch.storage.h5_reader import VCFH5Reader
from haplohyped_tpu_torch.storage.reference import ReferenceGenomeReader

from tests.synth import make_corpus


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(str(tmp_path_factory.mktemp("synth")))


@pytest.fixture(scope="module")
def artifacts(corpus, tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("artifacts"))
    conv = VCFtoHDF5Converter(
        cohort_name="synth", vcf_dir=corpus["dir"], out_dir=outdir,
        sample_list_path=corpus["samples_file"], cores=2, cxx_threads=1,
        chromosomes=[corpus["chrom_num"]],
    )
    conv.run()
    ref_h5 = encode_fasta(FastaEncodeConfig(
        fasta_path=corpus["fasta"], out_dir=outdir, cores=1, chromosomes=(corpus["chrom"],)))
    return {"cohort": conv.config.final_h5_path, "reference": ref_h5}


def datasets(corpus, artifacts, **kw):
    files = dict(bed_file=corpus["bed"], hdf5_genotype_file=artifacts["cohort"],
                 hdf5_reference_file=artifacts["reference"],
                 samples_file=corpus["samples_file"])
    return RandomHaplotypeDataset(**files, **kw), JaxRandomHaplotypeDataset(**files, **kw)


@pytest.mark.parametrize("seed,batch_size,seq_length", [(1, 4, 512), (42, 3, 128), (7, 2, 20_000)])
def test_batches_equal_jax(corpus, artifacts, seed, batch_size, seq_length):
    ds, jds = datasets(corpus, artifacts, seed=seed, batch_size=batch_size,
                       seq_length=seq_length)
    try:
        assert len(ds) == len(jds) == 12
        assert ds.chromosomes == jds.chromosomes and ds.donor_ids == jds.donor_ids
        assert ds.encode_spec == jds.encode_spec == ds.reference_genome.encode_spec
        for _ in range(3):
            (h1, h2), (j1, j2) = ds.sample_numpy(), jds.sample_numpy()
            assert h1.dtype == np.float32 and h1.shape == (batch_size, seq_length, 5)
            np.testing.assert_array_equal(h1, j1)
            np.testing.assert_array_equal(h2, j2)
        t1, t2 = ds[0]
        w1, w2 = jds[0]
        for t, w in ((t1, w1), (t2, w2)):
            assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
            assert t.device.type == "cpu" and tuple(t.shape) == (batch_size, seq_length, 5)
            np.testing.assert_array_equal(t.numpy(), w.numpy())
        ds.set_random_seed(5)
        jds.set_random_seed(5)
        np.testing.assert_array_equal(ds.sample_numpy()[0], jds.sample_numpy()[0])
    finally:
        ds.close()
        jds.close()


def test_dataloader_batches(corpus, artifacts):
    ds, jds = datasets(corpus, artifacts, seed=3, batch_size=2, seq_length=64)
    jds.close()
    try:
        loader = torch.utils.data.DataLoader(ds, batch_size=None, num_workers=0)
        h1, h2 = next(iter(loader))
        assert h1.shape == (2, 64, 5) and h1.sum(-1).eq(1).all()
    finally:
        ds.close()


def test_encode_haplotypes_host_matches_jax_with_duplicates():
    rng = np.random.default_rng(11)
    n, L, start = 400, 300, 1_000
    t = np.zeros(n, dtype=SNP_STRUCT_DTYPE)
    t["chrom"] = b"chr1"
    t["start"] = rng.integers(start - 50, start + L + 50, n)  # many repeats, some outside
    t["stop"] = t["start"] + 1
    t["ref"] = rng.choice([b"A", b"c", b"G", b"T", b"N", b"AT"], n)
    t["alt"] = rng.choice([b"A", b"C", b"g", b"T", b"*", b"R"], n)
    t["phase1"] = rng.integers(0, 2, n)
    t["phase2"] = rng.integers(0, 2, n)
    ref = rng.integers(0, 5, L).astype(np.int8)
    got = encode_haplotypes_host(ref, t, start, start + L)
    want = jax_encode_haplotypes_host(ref, t, start, start + L)
    assert np.unique(t["start"]).size < n
    for g, w in zip(got, want):
        assert g.dtype == np.int8
        np.testing.assert_array_equal(g, w)
    # a duplicate position takes its last row, as numpy's fancy assignment does
    pos = int(t["start"][np.nonzero((t["start"] >= start) & (t["start"] < start + L))[0][-1]])
    last = np.nonzero(t["start"] == pos)[0][-1]
    base = t["alt"][last] if t["phase1"][last] == 1 else t["ref"][last]
    assert got[0][pos - start] == BASE_LUT[base[0]]
    empty = encode_haplotypes_host(ref, t[:0], start, start + L)
    np.testing.assert_array_equal(empty[0], ref)


def test_sampler_windows_equal_the_datasets_encode(corpus, artifacts):
    cfg = SamplerConfig(seq_length=512, batch_size=8, seed=0, max_variants_per_window=64)
    sampler = DeviceHaplotypeSampler.from_files(
        bed_file=corpus["bed"], cohort_h5=artifacts["cohort"],
        reference_h5=artifacts["reference"], samples_file=corpus["samples_file"],
        config=cfg, device="cpu")
    region, donor, chrom = sampler.draw_indices(0)
    batch = sampler.windows_from_draws(region, donor, chrom)
    starts = sampler.window_starts(region, chrom)
    n_var = 0
    with VCFH5Reader(artifacts["cohort"]) as vr, \
            ReferenceGenomeReader(artifacts["reference"]) as ref:
        for b in range(cfg.batch_size):
            name = sampler.genome.chrom_names[int(chrom[b])]
            s = int(starts[b])
            table = vr.fetch_genotypes(sampler.cohort.donors[int(donor[b])],
                                       name.removeprefix("chr"))
            h1, h2 = encode_haplotypes_host(ref.get_codes(name, s, s + 512), table, s, s + 512)
            np.testing.assert_array_equal(batch.hap1_codes[b].numpy(), h1)
            np.testing.assert_array_equal(batch.hap2_codes[b].numpy(), h2)
            n_var += int(batch.n_variants[b])
    assert n_var > 0
