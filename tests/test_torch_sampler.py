"""Sampler of the PyTorch port against the JAX package.

Both packages draw the same ``jax.random`` stream, so for one seed and state
the port's ``sample()``, ``sample_many(n)``, ``sample(key=)`` and
``sample_many(n, key=)`` must be bit-equal (tolerance 0) to the JAX
sampler's, through the port's own ``draw_indices``.  Other tests recompute the
JAX sampler's draws (``fold_in(PRNGKey(seed), step)``, ``split(key, 3)``,
``randint``, as ``haplohyped_tpu/data/sampler.py`` does) and feed them to the
port's ``windows_from_draws``, which holds the encode alone against JAX.
"""

import numpy as np
import pytest
import torch

import jax

from haplohyped_tpu.core.config import FastaEncodeConfig
from haplohyped_tpu.core.config import SamplerConfig as JaxSamplerConfig
from haplohyped_tpu.data.cohort import CohortTensors as JaxCohortTensors
from haplohyped_tpu.data.genome import GenomeTensors as JaxGenomeTensors
from haplohyped_tpu.data.sampler import DeviceHaplotypeSampler as JaxSampler
from haplohyped_tpu.pipeline.fasta_encoder import encode_fasta
from haplohyped_tpu.pipeline.vcf_to_h5 import VCFtoHDF5Converter
from haplohyped_tpu_torch import (
    DeviceHaplotypeSampler,
    SamplerConfig,
    convert,
)
from haplohyped_tpu_torch.core.constants import SNP_STRUCT_DTYPE
from haplohyped_tpu_torch.ops.window_kernel import encode_windows_kernel

from tests.synth import make_corpus

GENOME_FIELDS = ("chrom_names", "codes_flat", "offsets", "lengths")
COHORT_FIELDS = (
    "donors", "chrom_names", "pos", "ref_code", "alt_code", "phase1", "phase2", "counts",
)
BATCH_FIELDS = ("hap1", "hap2", "hap1_codes", "hap2_codes", "n_variants", "overflow")


def jax_draws(seed, step, R, D, C, B):
    """The JAX sampler's (region, donor, chrom) draws of one step."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    kr, kd, kc = jax.random.split(key, 3)
    return tuple(
        torch.from_numpy(np.array(jax.random.randint(k, (B,), 0, n), dtype=np.int32))
        for k, n in ((kr, R), (kd, D), (kc, C))
    )


def snp_table(rng, n, length):
    t = np.zeros(n, dtype=SNP_STRUCT_DTYPE)
    t["start"] = np.sort(rng.choice(length - 10, size=n, replace=False))
    t["stop"] = t["start"] + 1
    t["ref"] = rng.choice([b"A", b"C", b"G", b"T"], n)
    t["alt"] = rng.choice([b"A", b"C", b"G", b"T"], n)
    t["phase1"] = rng.integers(0, 2, n)
    t["phase2"] = rng.integers(0, 2, n)
    return t


def jax_state(chrom_order=("chr1", "chr2")):
    """JAX containers: two chromosomes (one shorter than the window), three
    donors; the cohort's chrom axis may list chromosomes in another order."""
    rng = np.random.default_rng(5)
    lengths = {"chr1": 20_000, "chr2": 150}
    genome = JaxGenomeTensors.from_code_arrays(
        {c: rng.integers(0, 5, size=n).astype(np.int8) for c, n in lengths.items()}
    )
    donors = ["d0", "d1", "d2"]
    tables = {
        (d, c): snp_table(rng, 400 if c == "chr1" else 20, lengths.get(c, 5000))
        for d in donors for c in chrom_order
    }
    cohort = JaxCohortTensors.from_structs(tables, donors, list(chrom_order))
    spans = np.stack([(s := rng.integers(0, 19_000, 64)), s + 1200], axis=1)
    return genome, cohort, spans


def both_samplers(config_kw, chrom_order=("chr1", "chr2"), port_kernel="auto", **kw):
    genome, cohort, spans = jax_state(chrom_order)
    jax_sampler = JaxSampler(
        genome, cohort, spans, JaxSamplerConfig(window_kernel="baseline", **config_kw),
        onehot_dtype=jax.numpy.float32, **kw,
    )
    port_sampler = DeviceHaplotypeSampler(
        convert.genome_from_state({f: getattr(genome, f) for f in GENOME_FIELDS}),
        convert.cohort_from_state({f: getattr(cohort, f) for f in COHORT_FIELDS}),
        spans, SamplerConfig(window_kernel=port_kernel, **config_kw), device="cpu", **kw,
    )
    return jax_sampler, port_sampler


def assert_batch_equal(got, want, fields=BATCH_FIELDS):
    for name in fields:
        g = getattr(got, name).numpy()
        w = np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def port_draws_of_jax(jax_sampler, seed, step):
    B = jax_sampler.config.batch_size
    R = jax_sampler._regions_dev.shape[0]
    return jax_draws(seed, step, R, jax_sampler.cohort.num_donors,
                     len(jax_sampler.genome.chrom_names), B)


@pytest.mark.parametrize("kernel", ["baseline", "kernel"])
@pytest.mark.parametrize("L,K", [(256, 64), (1000, 8)])
def test_batch_bit_equal_to_jax_on_jax_draws(kernel, L, K):
    """On the CPU the "kernel" choice reaches the wrapper, which runs the plain
    version for CPU tensors."""
    cfg = dict(seq_length=L, batch_size=16, seed=3, max_variants_per_window=K)
    js, ps = both_samplers(cfg, port_kernel=kernel)
    assert ps.kernel == kernel
    for step in range(2):
        want = js.sample()
        got = ps.windows_from_draws(*port_draws_of_jax(js, 3, step))
        assert_batch_equal(got, want)
    assert (got.n_variants > 0).any()


def test_chrom_reorder_matches_jax():
    js, ps = both_samplers(
        dict(seq_length=128, batch_size=16, seed=0, max_variants_per_window=64),
        chrom_order=("chrZ", "chr2", "chr1"),
    )
    assert ps.cohort.chrom_names == ps.genome.chrom_names == ["chr1", "chr2"]
    assert_batch_equal(ps.windows_from_draws(*port_draws_of_jax(js, 0, 0)), js.sample())


def test_missing_chrom_raises():
    genome, cohort, spans = jax_state()
    cstate = {f: getattr(cohort, f) for f in COHORT_FIELDS}
    cstate["chrom_names"] = ["chr1", "chrQ"]
    with pytest.raises(ValueError, match="lacks chromosomes"):
        DeviceHaplotypeSampler(
            convert.genome_from_state({f: getattr(genome, f) for f in GENOME_FIELDS}),
            convert.cohort_from_state(cstate), spans, device="cpu",
        )


def test_emit_onehot_matches_jax():
    js, ps = both_samplers(
        dict(seq_length=200, batch_size=8, seed=1, max_variants_per_window=32),
        emit_onehot=True,
    )
    got = ps.windows_from_draws(*port_draws_of_jax(js, 1, 0))
    assert got.hap1.shape == (8, 200, 5) and got.hap1.dtype == torch.float32
    assert_batch_equal(got, js.sample())


def test_codes_mode_aliases_and_shapes():
    _, ps = both_samplers(dict(seq_length=256, batch_size=4, seed=9))
    b = ps.sample()
    assert b.hap1 is b.hap1_codes and b.hap2 is b.hap2_codes
    assert b.hap1.shape == (4, 256) and b.hap1.dtype == torch.int8
    assert b.n_variants.dtype == torch.int32
    torch.testing.assert_close(b.overflow, (b.n_variants - 128).clamp(min=0), rtol=0, atol=0)


@pytest.mark.parametrize("emit_onehot", [False, True])
def test_sample_many_equals_successive_samples(emit_onehot):
    cfg = dict(seq_length=128, batch_size=5, seed=7, max_variants_per_window=16)
    _, seq = both_samplers(cfg, emit_onehot=emit_onehot)
    _, fused = both_samplers(cfg, emit_onehot=emit_onehot)
    singles = [seq.sample() for _ in range(4)]
    many = fused.sample_many(4)
    assert many.hap1_codes.shape == (4, 5, 128)
    assert (many.hap1 is many.hap1_codes) == (not emit_onehot)
    for i, b in enumerate(singles):
        for name in BATCH_FIELDS:
            assert torch.equal(getattr(many, name)[i], getattr(b, name)), (i, name)
    # both advanced four steps: the next draws agree too
    assert torch.equal(fused.sample().hap1_codes, seq.sample().hap1_codes)
    assert torch.equal(next(iter(fused)).hap2_codes, next(iter(seq)).hap2_codes)


def test_draws_depend_on_seed_and_step_only():
    _, a = both_samplers(dict(seq_length=64, batch_size=32, seed=11))
    _, b = both_samplers(dict(seq_length=64, batch_size=32, seed=11))
    _, c = both_samplers(dict(seq_length=64, batch_size=32, seed=12))
    b.sample()  # b's own step counter moves; draw_indices(step) does not care
    for step in (0, 5):
        da, db, dc = a.draw_indices(step), b.draw_indices(step), c.draw_indices(step)
        assert all(torch.equal(x, y) for x, y in zip(da, db))
        assert not all(torch.equal(x, y) for x, y in zip(da, dc))
        r, d, ch = da
        assert r.dtype == torch.int32 and 0 <= int(r.min()) and int(r.max()) < 64
        assert 0 <= int(d.min()) and int(d.max()) < 3
        assert 0 <= int(ch.min()) and int(ch.max()) < 2
    assert not all(torch.equal(x, y) for x, y in zip(a.draw_indices(0), a.draw_indices(1)))


def test_window_kernel_choices():
    assert SamplerConfig().resolved_kernel(torch.device("cpu")) == "baseline"
    assert SamplerConfig().resolved_kernel(torch.device("cuda")) == "kernel"
    with pytest.raises(ValueError, match="counterpart here is window_kernel='kernel'"):
        SamplerConfig(window_kernel="pallas")
    with pytest.raises(ValueError, match="not ported"):
        SamplerConfig(window_kernel="fast")
    with pytest.raises(ValueError, match="unknown window_kernel"):
        SamplerConfig(window_kernel="xla")
    _, ps = both_samplers(dict(seq_length=64, batch_size=2))
    assert ps.kernel == "baseline"


def test_default_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    genome, cohort, spans = jax_state()
    g = convert.genome_from_state({f: getattr(genome, f) for f in GENOME_FIELDS})
    c = convert.cohort_from_state({f: getattr(cohort, f) for f in COHORT_FIELDS})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceHaplotypeSampler(g, c, spans)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceHaplotypeSampler.from_files("no.bed", "no.h5", "no.h5")


def test_from_files_matches_jax(tmp_path):
    corpus = make_corpus(str(tmp_path / "synth"))
    outdir = str(tmp_path / "out")
    conv = VCFtoHDF5Converter(
        cohort_name="synth", vcf_dir=corpus["dir"], out_dir=outdir,
        sample_list_path=corpus["samples_file"], cores=2, cxx_threads=1,
        chromosomes=[corpus["chrom_num"]],
    )
    conv.run()
    ref_h5 = encode_fasta(
        FastaEncodeConfig(fasta_path=corpus["fasta"], out_dir=outdir, cores=1,
                          chromosomes=(corpus["chrom"],))
    )
    files = dict(bed_file=corpus["bed"], cohort_h5=conv.config.final_h5_path,
                 reference_h5=ref_h5, samples_file=corpus["samples_file"])
    cfg = dict(seq_length=512, batch_size=8, seed=0, max_variants_per_window=64)
    js = JaxSampler.from_files(config=JaxSamplerConfig(window_kernel="baseline", **cfg), **files)
    before = encode_windows_kernel.launches
    ps = DeviceHaplotypeSampler.from_files(config=SamplerConfig(**cfg), device="cpu", **files)
    got = ps.windows_from_draws(*port_draws_of_jax(js, 0, 0))
    assert_batch_equal(got, js.sample())
    assert int(got.n_variants.sum()) > 0
    assert encode_windows_kernel.launches == before


# ---------------------------------------------------------------------------
# the port's own draws against the JAX sampler's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["baseline", "kernel"])
@pytest.mark.parametrize("emit_onehot", [False, True])
def test_samples_bit_equal_to_jax(kernel, emit_onehot):
    """Three ``sample()`` calls, then ``sample_many(4)`` (steps 3-6)."""
    cfg = dict(seq_length=256, batch_size=8, seed=5, max_variants_per_window=32)
    js, ps = both_samplers(cfg, port_kernel=kernel, emit_onehot=emit_onehot)
    for _ in range(3):
        assert_batch_equal(ps.sample(), js.sample())
    assert_batch_equal(ps.sample_many(4), js.sample_many(4))
    assert ps._step == js._step == 7


@pytest.mark.parametrize("as_key", ["int", "jax", "tensor", "list"])
def test_keyed_samples_bit_equal_to_jax(as_key):
    """``sample(key=)`` and ``sample_many(n, key=)``: step 0 on of the key,
    the counter left alone.  An int is ``PRNGKey(int)``; a JAX key's two
    words may come as its array, a tensor or a list."""
    cfg = dict(seq_length=128, batch_size=6, seed=2, max_variants_per_window=16)
    js, ps = both_samplers(cfg)
    jkey = jax.random.fold_in(jax.random.PRNGKey(77), 3)
    words = np.asarray(jkey)
    key = {"int": 77, "jax": jkey, "tensor": torch.from_numpy(words.astype(np.int64)),
           "list": words.tolist()}[as_key]
    want_key = jax.random.PRNGKey(77) if as_key == "int" else jkey
    assert_batch_equal(ps.sample(key=key), js.sample(key=want_key))
    assert_batch_equal(ps.sample_many(3, key=key), js.sample_many(3, key=want_key))
    assert ps._step == js._step == 0


@pytest.mark.parametrize("kernel", [None, "baseline", "kernel"])
def test_batch_at_bit_equal_to_jax(kernel):
    """``batch_at(s)``, the batch ``sample()`` and the fused step build at
    step ``s``, leaves the counter alone; with a key it is step ``s`` of
    that key."""
    cfg = dict(seq_length=128, batch_size=6, seed=4, max_variants_per_window=16)
    js, ps = both_samplers(cfg)
    for step in range(3):
        assert_batch_equal(ps.batch_at(step, kernel=kernel), js.sample())
    assert_batch_equal(ps.batch_at(0, key=77, kernel=kernel),
                       js.sample(key=jax.random.PRNGKey(77)))
    assert ps._step == 0


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, 2**32 + 5, -3])
def test_draw_indices_equal_jax_draws(seed):
    """Seeds outside int32 follow ``PRNGKey``: JAX keeps the low 32 bits."""
    cfg = dict(seq_length=64, batch_size=32, seed=seed)
    js, ps = both_samplers(cfg)
    for step in (0, 9, 2**31 - 1):
        got = ps.draw_indices(step)
        want = port_draws_of_jax(js, seed, step)
        assert all(g.dtype == torch.int32 for g in got)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), step


def test_bad_keys_raise():
    _, ps = both_samplers(dict(seq_length=64, batch_size=2))
    for key in ([1, 2, 3], np.zeros((2, 2), np.uint32), torch.zeros(2), [1.5, 2.0]):
        with pytest.raises(ValueError, match="key"):
            ps.sample(key=key)
    with pytest.raises(OverflowError, match="int64"):
        ps.sample(key=2**64)
    with pytest.raises(OverflowError, match="int32"):
        ps.draw_indices(2**31)
