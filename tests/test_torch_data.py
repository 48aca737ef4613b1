"""Data layer of the PyTorch port against the JAX package.

Containers, the BED loader and the state carry-across must give arrays equal
(bit for bit; tolerance 0) to the JAX package's, from the same structs and
from the HDF5 files the JAX converter and FASTA encoder write.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from haplohyped_tpu.core import constants as jax_constants
from haplohyped_tpu.core.config import FastaEncodeConfig
from haplohyped_tpu.data.cohort import CohortTensors as JaxCohortTensors
from haplohyped_tpu.data.genome import GenomeTensors as JaxGenomeTensors
from haplohyped_tpu.data.regions import calculate_midpoint_region as jax_midpoint
from haplohyped_tpu.data.regions import load_bed_regions as jax_load_bed_regions
from haplohyped_tpu.pipeline.fasta_encoder import encode_fasta
from haplohyped_tpu.pipeline.vcf_to_h5 import VCFtoHDF5Converter
from haplohyped_tpu_torch import convert
from haplohyped_tpu_torch.core import constants
from haplohyped_tpu_torch.data.cohort import CohortTensors
from haplohyped_tpu_torch.data.genome import GenomeTensors
from haplohyped_tpu_torch.data.regions import calculate_midpoint_region, load_bed_regions
from haplohyped_tpu_torch.storage.blosc import needs_blosc

from tests.synth import make_corpus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GENOME_FIELDS = ("chrom_names", "codes_flat", "offsets", "lengths")
COHORT_FIELDS = (
    "donors", "chrom_names", "pos", "ref_code", "alt_code", "phase1", "phase2", "counts",
)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(str(tmp_path_factory.mktemp("synth")))


@pytest.fixture(scope="module")
def artifacts(corpus, tmp_path_factory):
    """Cohort + reference HDF5 written by the JAX package's converters."""
    outdir = str(tmp_path_factory.mktemp("artifacts"))
    conv = VCFtoHDF5Converter(
        cohort_name="synth", vcf_dir=corpus["dir"], out_dir=outdir,
        sample_list_path=corpus["samples_file"], cores=2, cxx_threads=1,
        chromosomes=[corpus["chrom_num"]],
    )
    conv.run()
    ref_h5 = encode_fasta(
        FastaEncodeConfig(
            fasta_path=corpus["fasta"], out_dir=outdir, cores=1,
            chromosomes=(corpus["chrom"],),
        )
    )
    return {"cohort": conv.config.final_h5_path, "reference": ref_h5}


def assert_fields_equal(got, want, fields):
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            assert g == w, f


def snp_tables(seed=3):
    rng = np.random.default_rng(seed)
    tables = {}
    for d in ("d0", "d1"):
        for c, n in (("chr2", 37), ("chr10", 0), ("chr1", 200)):
            t = np.zeros(n, dtype=constants.SNP_STRUCT_DTYPE)
            t["chrom"] = c.encode()
            t["start"] = rng.integers(0, 5000, n)  # unsorted, with repeats
            t["stop"] = t["start"] + 1
            t["ref"] = rng.choice([b"A", b"c", b"G", b"T", b"N", b"AT"], n)
            t["alt"] = rng.choice([b"A", b"C", b"g", b"T", b"*"], n)
            t["phase1"] = rng.integers(0, 2, n)
            t["phase2"] = rng.integers(0, 2, n)
            tables[(d, c)] = t
    return tables


def test_constants_match_jax():
    np.testing.assert_array_equal(constants.BASE_LUT, jax_constants.BASE_LUT)
    for name in (
        "N_CODE", "NUM_CHANNELS", "SNP_STRUCT_DTYPE", "SNP_DATASET_NAME",
        "SEQUENCE_DATASET_NAME", "CODES_DATASET_NAME", "BLOSC_FILTER_ID",
        "DEFAULT_SEQ_LENGTH",
    ):
        assert getattr(constants, name) == getattr(jax_constants, name), name
    assert constants.cohort_group_path("x", 7) == jax_constants.cohort_group_path("x", 7)
    assert constants.INT32_MAX == np.iinfo(np.int32).max


@pytest.mark.parametrize("pad_to", [None, 300])
def test_cohort_from_structs_matches_jax(pad_to):
    tables = snp_tables()
    args = (tables, ["d0", "d1"], ["chr1", "chr2", "chr10"], pad_to)
    got = CohortTensors.from_structs(*args)
    assert_fields_equal(got, JaxCohortTensors.from_structs(*args), COHORT_FIELDS)
    assert got.pos.shape[2] % 128 == 0


def test_genome_from_code_arrays_matches_jax():
    rng = np.random.default_rng(4)
    chroms = {"chrA": rng.integers(0, 5, 1000), "chrB": rng.integers(0, 5, 128),
              "chrC": rng.integers(0, 5, 3)}
    got = GenomeTensors.from_code_arrays(chroms)
    assert_fields_equal(got, JaxGenomeTensors.from_code_arrays(chroms), GENOME_FIELDS)


def test_containers_from_h5_match_jax(corpus, artifacts):
    genome = GenomeTensors.from_h5(artifacts["reference"])
    assert_fields_equal(genome, JaxGenomeTensors.from_h5(artifacts["reference"]), GENOME_FIELDS)
    assert genome.lengths[0] == corpus["length"]
    with open(corpus["samples_file"]) as f:
        donors = [line.strip() for line in f if line.strip()]
    for kw in ({}, {"donors": donors, "chrom_names": genome.chrom_names}):
        got = CohortTensors.from_h5(artifacts["cohort"], **kw)
        assert_fields_equal(got, JaxCohortTensors.from_h5(artifacts["cohort"], **kw), COHORT_FIELDS)
    assert got.counts.sum() > 0


def test_device_arrays_are_tensors_on_the_device():
    g = GenomeTensors.from_code_arrays({"chr1": np.arange(300) % 5})
    flat, offsets, lengths = g.device_arrays("cpu")
    assert flat.dtype == torch.int8 and offsets.dtype == torch.int32
    np.testing.assert_array_equal(flat.numpy(), g.codes_flat)
    c = CohortTensors.from_structs(snp_tables(), ["d0", "d1"], ["chr1", "chr2", "chr10"])
    arrs = c.device_arrays("cpu")
    for t, name in zip(arrs, ("pos", "ref_code", "alt_code", "phase1", "phase2", "counts")):
        np.testing.assert_array_equal(t.numpy(), getattr(c, name), err_msg=name)


def test_device_arrays_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    g = GenomeTensors.from_code_arrays({"chr1": np.zeros(10)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        g.device_arrays()


def test_load_bed_regions_matches_jax(corpus, tmp_path):
    bed = tmp_path / "mixed.bed"
    bed.write_text(
        "track name=x\n# comment\nchr2\t10\t20\n\nchr10 5 9\nchr1\t0\t1000\tname\n"
    )
    for path in (corpus["bed"], str(bed)):
        got, want = load_bed_regions(path), jax_load_bed_regions(path)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1].dtype == want[1].dtype
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
    for s, e, L in ((0, 10, 1000), (5000, 7001, 1000), (3, 4, 7)):
        assert calculate_midpoint_region(s, e, L) == jax_midpoint(s, e, L)


def test_convert_round_trips_jax_state(artifacts):
    jg = JaxGenomeTensors.from_h5(artifacts["reference"])
    jc = JaxCohortTensors.from_h5(artifacts["cohort"])
    g_state = {f: getattr(jg, f) for f in GENOME_FIELDS}
    c_state = {f: getattr(jc, f) for f in COHORT_FIELDS}
    g = convert.genome_from_state(g_state)
    c = convert.cohort_from_state(c_state)
    assert_fields_equal(g, jg, GENOME_FIELDS)
    assert_fields_equal(c, jc, COHORT_FIELDS)
    back_g, back_c = convert.genome_state(g), convert.cohort_state(c)
    for f in GENOME_FIELDS:
        np.testing.assert_array_equal(back_g[f], g_state[f], err_msg=f)
    for f in COHORT_FIELDS:
        np.testing.assert_array_equal(back_c[f], c_state[f], err_msg=f)


def test_convert_rejects_inexact_state():
    c = JaxCohortTensors.from_structs(snp_tables(), ["d0", "d1"], ["chr1", "chr2", "chr10"])
    state = {f: getattr(c, f) for f in COHORT_FIELDS}
    with pytest.raises(TypeError, match="pos"):
        convert.cohort_from_state(state | {"pos": state["pos"].astype(np.int64)})
    with pytest.raises(ValueError, match="counts"):
        convert.cohort_from_state(state | {"counts": state["counts"][:1]})
    with pytest.raises(ValueError, match="pos shape"):
        convert.cohort_from_state(state | {"donors": ["d0"]})


def _run_port_only(code: str) -> subprocess.CompletedProcess:
    """Run ``code`` in a fresh process that imports only the port."""
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)],
        cwd=ROOT, capture_output=True, text=True, timeout=240,
    )


def test_blosc_read_builds_the_ports_own_plugin(artifacts):
    """The JAX converter writes Blosc datasets here; a process holding only
    the port builds and registers its own plugin to read them."""
    import h5py

    with h5py.File(artifacts["cohort"], "r") as f:
        donor = next(k for k in f if k.startswith("donor_"))
        chrom = next(iter(f[donor]))
        if not needs_blosc(f[donor][chrom]["snp_data"]):
            pytest.skip("the JAX converter wrote no Blosc dataset on this machine")
    want = JaxCohortTensors.from_h5(artifacts["cohort"])
    out = _run_port_only(f"""
        import sys
        import h5py
        import haplohyped_tpu_torch.storage.blosc as blosc
        from haplohyped_tpu_torch.data.cohort import CohortTensors
        preinstalled = h5py.h5z.filter_avail(32001)
        c = CohortTensors.from_h5({artifacts['cohort']!r})
        assert preinstalled or blosc._plugin_handle is not None
        assert not any(m == "jax" or m.startswith(("jax.", "haplohyped_tpu."))
                       for m in sys.modules)
        print(int(c.counts.sum()), int(c.pos[c.pos < 2**31 - 1].sum()))
    """)
    assert out.returncode == 0, out.stderr
    valid = want.pos[want.pos < np.iinfo(np.int32).max]
    assert out.stdout.split() == [str(int(want.counts.sum())), str(int(valid.sum()))]


def test_blosc_missing_plugin_raises_and_gzip_still_reads(artifacts, tmp_path):
    """Without a buildable plugin, a Blosc dataset raises a clear error and a
    gzip one reads as before."""
    import h5py

    gz = str(tmp_path / "gz.h5")
    with h5py.File(gz, "w") as f:
        f.create_dataset("chr1/sequence", data=np.eye(5, dtype=np.int8)[[0, 1, 2, 3, 4, 0]],
                         compression="gzip")
    out = _run_port_only(f"""
        from pathlib import Path
        import haplohyped_tpu_torch.storage.blosc as blosc
        from haplohyped_tpu_torch.data.genome import GenomeTensors
        from haplohyped_tpu_torch.data.cohort import CohortTensors
        blosc.PLUGIN_SOURCE = Path("no-such-dir/blosc_h5_filter.c")
        g = GenomeTensors.from_h5({gz!r})
        print(g.codes_flat[:6].tolist())
        try:
            CohortTensors.from_h5({artifacts['cohort']!r})
        except RuntimeError as exc:
            print("raised:", exc)
    """)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "[0, 1, 2, 3, 4, 0]"
    with h5py.File(artifacts["cohort"], "r") as f:
        donor = next(k for k in f if k.startswith("donor_"))
        blosc_written = needs_blosc(f[donor][next(iter(f[donor]))]["snp_data"])
    if blosc_written:
        assert lines[1].startswith("raised: Blosc filter 32001 needed"), lines
