"""The port's v2 framers against the JAX package's, field by field.

``VCFSource.frame_v2`` (native ``hh_vcf_frame_v2``) and ``frame_v2_py`` of
the port must give the JAX package's ``FrameV2`` exactly: the fixed records,
the GT matrix, the escape and run arrays with their dtypes, the chrom table,
the sample order and the counts; for no samples, one name, a list and
``"*"``, with and without a region, on the ``tests/data`` corpus and the edge
VCFs (chrom changes, gaps over 65,535, backward and malformed POS, GT as a
later FORMAT subfield, no GT).
"""

import dataclasses
import gzip

import numpy as np
import pytest

from haplohyped_tpu.hostio import VCFSource as JaxVCFSource
from haplohyped_tpu.hostio import frame_format as jax_ff

from haplohyped_tpu_torch.hostio import frame_format, native
from haplohyped_tpu_torch.hostio.vcf import VCFSource

from chip_smoke import DECODE_EDGE_VCF
from tests.test_frame_v2 import EDGE_VCF
from tests.test_torch_hostio import many_contigs_vcf
from tests.test_vcf_decode import corpus_samples

FIELDS = [f.name for f in dataclasses.fields(jax_ff.FrameV2)]


@pytest.fixture(scope="module")
def vcfs(test_data_dir, tmp_path_factory):
    """``{name: (path, samples)}``: the corpus and the two edge VCFs."""
    d = tmp_path_factory.mktemp("v2")
    out = {"corpus": (str(test_data_dir / "chr22.filtered.vcf.gz"),
                      corpus_samples(test_data_dir))}
    for name, text in (("edge", EDGE_VCF), ("decode_edge", DECODE_EDGE_VCF)):
        path = d / f"{name}.vcf.gz"
        with gzip.open(path, "wt") as f:
            f.write(text)
        out[name] = (str(path), ["s1", "s2"])
    return out


def assert_frames_equal(got, want, what=""):
    assert [f.name for f in dataclasses.fields(got)] == FIELDS
    for name in FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, f"{what}: {name}"
            np.testing.assert_array_equal(g, w, err_msg=f"{what}: {name}")
        else:
            assert g == w, f"{what}: {name}"
    assert (got.n, got.n_samples, got.wire_bytes()) == (want.n, want.n_samples,
                                                         want.wire_bytes())


def sample_sets(samples):
    return {"none": None, "one": samples[-1], "list": samples[::-1], "all": "*"}


SAMPLE_SETS = ["none", "one", "list", "all"]
REGIONS = [None, "chr22", "chr1", "chr2", "chr1:150-500000", "chr22:16050000-16100000"]


@pytest.mark.parametrize("region", REGIONS)
@pytest.mark.parametrize("which", SAMPLE_SETS)
@pytest.mark.parametrize("name", ["corpus", "edge", "decode_edge"])
def test_native_frame_v2_matches_jax(vcfs, name, which, region):
    path, samples = vcfs[name]
    s = sample_sets(samples)[which]
    got = VCFSource(path, threads=2).frame_v2(samples=s, region=region)
    want = JaxVCFSource(path, threads=2).frame_v2(samples=s, region=region)
    assert_frames_equal(got, want, f"{name} {which} {region}")


@pytest.mark.parametrize("region", [None, "chr1", "chr22", "chr1:150-500000"])
@pytest.mark.parametrize("which", SAMPLE_SETS)
@pytest.mark.parametrize("name", ["corpus", "edge", "decode_edge"])
def test_python_frame_v2_matches_jax_and_native(vcfs, name, which, region):
    path, samples = vcfs[name]
    s = sample_sets(samples)[which]
    arg = None if s is None else ([s] if isinstance(s, str) else s)
    with gzip.open(path, "rb") as f:
        text = f.read()
    got = frame_format.frame_v2_py(text, arg, region)
    assert_frames_equal(got, jax_ff.frame_v2_py(text, arg, region), f"{name} {which}")
    assert_frames_equal(got, VCFSource(path, use_native=False).frame_v2(s, region), "py src")
    nat = VCFSource(path).frame_v2(s, region)
    for name_ in FIELDS:
        if name_ != "blocks_decoded":  # -1 either way: neither inflated a range
            w = getattr(nat, name_)
            g = getattr(got, name_)
            assert (np.array_equal(g, w) if isinstance(w, np.ndarray) else g == w), name_


def test_escapes(vcfs):
    """Escaped records: the first, a gap over 65,535, a backward POS, two
    malformed POS (letters, 11 digits), the record after them, and a chrom
    change; each escape carries its absolute POS (0 where malformed)."""
    fv = VCFSource(vcfs["edge"][0]).frame_v2(samples=["s1", "s2"])
    esc = (fv.fixed[:, frame_format.V2_FLAGS_OFF] & frame_format.V2F_POS_ESCAPE) != 0
    np.testing.assert_array_equal(esc, [1, 0, 0, 0, 1, 1, 1, 1, 1, 1, 0])
    np.testing.assert_array_equal(fv.exc_idx, np.flatnonzero(esc))
    np.testing.assert_array_equal(fv.exc_pos, [100, 500000, 150, 0, 0, 600001, 500])
    well = (fv.fixed[:, frame_format.V2_FLAGS_OFF] & frame_format.V2F_WELL_FORMED) != 0
    assert not well[6] and not well[7] and well[8]
    np.testing.assert_array_equal(fv.run_counts, [9, 2])
    assert fv.chroms == ["chr1", "chr2"] and fv.total_seen == 12
    delta = fv.fixed[:, 0].astype(np.int64) | (fv.fixed[:, 1].astype(np.int64) << 8)
    np.testing.assert_array_equal(delta[[1, 2, 3, 10]], [100, 100, 100, 1])


@pytest.mark.parametrize("use_native", [True, False])
def test_more_than_255_contigs_raise(tmp_path, use_native):
    path = many_contigs_vcf(tmp_path / "ctg300.vcf.gz")
    src = VCFSource(path, use_native=use_native)
    with pytest.raises(ValueError, match="255"):
        src.frame_v2(samples="s1")
    with pytest.raises(ValueError, match="255"):
        JaxVCFSource(path, use_native=use_native).frame_v2(samples="s1")
    one = src.frame_v2(samples="s1", region="ctg7")  # one contig is fine
    assert one.n == 1 and one.chroms == ["ctg7"]


def test_unknown_sample_raises(vcfs):
    for use_native in (True, False):
        with pytest.raises(RuntimeError, match="sample not found"):
            VCFSource(vcfs["edge"][0], use_native=use_native).frame_v2(samples=["nope"])


def test_thread_chunks_match_jax(tmp_path):
    """Framing on 4 threads re-anchors POS at every chunk start and joins
    the chrom runs across chunks, as the JAX package's framer does."""
    rng = np.random.default_rng(3)
    n = 40_000
    pos = np.cumsum(rng.integers(1, 120_000, size=n)) + 1
    gts = np.array(["0|0", "0|1", "1|0", "1|1", "./."])[rng.integers(0, 5, size=n)]
    rows = ["##fileformat=VCFv4.2", "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ts1"]
    rows += [f"chr9\t{pos[i]}\t.\tA\tG\t.\tPASS\t.\tGT\t{gts[i]}" for i in range(n)]
    path = tmp_path / "big.vcf"
    path.write_text("\n".join(rows) + "\n")
    got = VCFSource(str(path), threads=4).frame_v2(samples=["s1"])
    assert got.exc_idx.shape[0] >= 3 and int(got.run_counts.sum()) == n
    assert_frames_equal(got, JaxVCFSource(str(path), threads=4).frame_v2(samples=["s1"]))


def test_framings_count_decompressions(vcfs):
    path = vcfs["corpus"][0]
    before = native.DECOMPRESS_COUNT
    src = VCFSource(path)
    src.frame_v2("*", "chr22")
    src.frame12(vcfs["corpus"][1][0], "chr22")
    src.frame(None, "chr22")
    src.samples()  # the header read is not a framing
    assert native.DECOMPRESS_COUNT - before == 3
