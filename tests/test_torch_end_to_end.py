"""The PyTorch port alone, end to end, on the CPU: the synthetic corpus ->
the port's cohort HDF5 and reference HDF5 -> the port's ``from_files`` ->
``train_on_sampler`` (with and without ``mesh=``), ``convert_sharded`` and
``sample_chain``.  The counterpart of ``tests/test_end_to_end.py``.

Where the JAX package is the yardstick the check is exact: the files equal
dataset by dataset (dtype, shape, chunks, filters, stored chunk bytes and
values), the sampler's windows bit-equal on the JAX sampler's own draws and
its own.
"""

import h5py
import numpy as np
import pytest
import torch
import torch.distributed as dist

from haplohyped_tpu.core.config import FastaEncodeConfig as JaxFastaEncodeConfig
from haplohyped_tpu.core.config import SamplerConfig as JaxSamplerConfig
from haplohyped_tpu.data.sampler import DeviceHaplotypeSampler as JaxSampler
from haplohyped_tpu.pipeline.fasta_encoder import encode_fasta as jax_encode_fasta
from haplohyped_tpu.pipeline.vcf_to_h5 import VCFtoHDF5Converter as JaxConverter
from haplohyped_tpu_torch import CohortTensors, DeviceHaplotypeSampler, MeshConfig, SamplerConfig
from haplohyped_tpu_torch.core.config import FastaEncodeConfig
from haplohyped_tpu_torch.models.haploformer import HaploFormerConfig
from haplohyped_tpu_torch.models.train import train_on_sampler
from haplohyped_tpu_torch.parallel import make_mesh
from haplohyped_tpu_torch.parallel.sharded_convert import convert_sharded
from haplohyped_tpu_torch.pipeline import VCFtoHDF5Converter
from haplohyped_tpu_torch.pipeline.fasta_encoder import encode_fasta
from haplohyped_tpu_torch.storage.blosc import read_dataset

from tests.synth import make_corpus
from tests.test_torch_sampler import assert_batch_equal, port_draws_of_jax

SAMPLER = dict(seq_length=256, batch_size=8, seed=0)
MODEL = HaploFormerConfig(d_model=32, num_heads=2, num_layers=1)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(str(tmp_path_factory.mktemp("e2e")), length=30_000, n_variants=400)


def _build(corpus, out, converter_cls, encode, **kw):
    conv = converter_cls(cohort_name="e2e", vcf_dir=corpus["dir"], out_dir=out,
                         sample_list_path=corpus["samples_file"], cores=2, cxx_threads=1,
                         chromosomes=[corpus["chrom_num"]], **kw)
    conv.run()
    ref = encode(corpus["fasta"], out)
    return {"bed_file": corpus["bed"], "cohort_h5": conv.config.final_h5_path,
            "reference_h5": ref, "samples_file": corpus["samples_file"]}


@pytest.fixture(scope="module")
def files(corpus, tmp_path_factory):
    """``{"port": ..., "jax": ...}``: each package's cohort and reference
    files on the same corpus (``from_files`` arguments)."""
    root = tmp_path_factory.mktemp("e2e_art")

    def port_encode(fasta, out):
        return encode_fasta(FastaEncodeConfig(fasta_path=fasta, out_dir=out, cores=1,
                                              chromosomes=(corpus["chrom"],)), device="cpu")

    def jax_encode(fasta, out):
        return jax_encode_fasta(JaxFastaEncodeConfig(fasta_path=fasta, out_dir=out, cores=1,
                                                     chromosomes=(corpus["chrom"],)))

    return {
        "port": _build(corpus, str(root / "port"), VCFtoHDF5Converter, port_encode,
                       device="cpu"),
        "jax": _build(corpus, str(root / "jax"), JaxConverter, jax_encode),
    }


def dataset_facts(path) -> dict:
    """Every dataset: dtype, shape, chunks, filters, each stored chunk's
    bytes, and the values."""
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                chunks = []
                if obj.chunks:
                    for i in range(obj.id.get_num_chunks()):
                        chunks.append(obj.id.read_direct_chunk(obj.id.get_chunk_info(i).chunk_offset)[1])
                out[name] = (obj.dtype, obj.shape, obj.chunks, dict(obj._filters), chunks,
                             np.asarray(read_dataset(obj)).tobytes())
        f.visititems(visit)
    return out


@pytest.mark.parametrize("which", ["cohort_h5", "reference_h5"])
def test_port_files_equal_jax_files(files, which):
    got, want = dataset_facts(files["port"][which]), dataset_facts(files["jax"][which])
    assert sorted(got) == sorted(want) and got
    for name in want:
        for i, what in enumerate(("dtype", "shape", "chunks", "filters", "chunks' bytes", "values")):
            assert got[name][i] == want[name][i], (name, what)


def port_sampler(files, **kw):
    return DeviceHaplotypeSampler.from_files(config=SamplerConfig(**SAMPLER), device="cpu",
                                             **files["port"], **kw)


def test_from_files_on_port_files_equals_jax(files):
    js = JaxSampler.from_files(config=JaxSamplerConfig(window_kernel="baseline", **SAMPLER),
                               **files["jax"])
    ps = port_sampler(files)
    for step in range(3):
        got = ps.windows_from_draws(*port_draws_of_jax(js, SAMPLER["seed"], step))
        want = js.sample()
        assert_batch_equal(got, want)
        assert_batch_equal(ps.sample(), want)  # the port's own draws
    assert int(got.n_variants.sum()) > 0


@pytest.fixture(scope="module")
def unsharded(files):
    return train_on_sampler(port_sampler(files), MODEL, steps=10, log_every=5)


def test_train_on_sampler(unsharded):
    state, losses = unsharded
    assert state.step == 10
    assert len(losses) == 2 and all(np.isfinite(v) for v in losses)


@pytest.fixture
def world1():
    """A gloo group of world size 1 (an in-process store), torn down after."""
    assert not dist.is_initialized()
    mesh = make_mesh(MeshConfig(1, 1), device="cpu")
    yield mesh
    dist.destroy_process_group()


def test_train_on_sampler_with_a_mesh(files, unsharded, world1):
    state, losses = train_on_sampler(port_sampler(files), MODEL, steps=10, log_every=5,
                                     mesh=world1)
    assert state.step == 10
    assert losses == unsharded[1]
    for a, b in zip(state.model.parameters(), unsharded[0].model.parameters()):
        assert torch.equal(a, b)


def test_convert_sharded_equals_the_unsharded_converter(corpus, files, world1):
    got = convert_sharded({corpus["chrom"]: corpus["vcf"]}, corpus["samples"],
                          [corpus["chrom"]], world1, device="cpu")
    want = CohortTensors.from_h5(files["port"]["cohort_h5"], donors=corpus["samples"])
    assert got.donors == want.donors and got.chrom_names == want.chrom_names
    assert int(want.counts.sum()) > 0
    for name in ("counts", "pos", "ref_code", "alt_code", "phase1", "phase2"):
        g, w = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        if g.ndim == 3:  # V differs by padding only
            n = min(g.shape[2], w.shape[2])
            assert int(want.counts.max()) <= n
            g, w = g[..., :n], w[..., :n]
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_sample_chain_on_the_port_written_sampler(files):
    ps = port_sampler(files)
    twin = DeviceHaplotypeSampler.from_files(config=SamplerConfig(**SAMPLER), device="cpu",
                                             **files["jax"])
    run = ps.chain_run(3, 2, key=7)
    assert int(run.digest) == int(twin.sample_chain(3, 2, key=7))
    assert int(run.last.n_variants.sum()) > 0
    assert int(ps.sample_chain(3, 2)) != int(ps.sample_chain(3, 2)) and ps._step == 12
