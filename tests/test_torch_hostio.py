"""The port's VCF framer against the JAX package's.

The port builds the native framer from ``cpp/`` into its own build
directory; its ``VCFSource.samples/seqnames/frame/frame12`` must give the
JAX package's ``VCFSource`` results byte for byte on the ``tests/data``
corpus and the edge VCFs, and its pure-Python framer (``use_native=False``)
the same frames.
"""

import gzip

import numpy as np
import pytest

from haplohyped_tpu.hostio import VCFSource as JaxVCFSource
from haplohyped_tpu.hostio import native as jax_native
from haplohyped_tpu.hostio.frame_format import frames12_from_frames64 as jax_12_from_64
from haplohyped_tpu.hostio.frame_format import frames12_to_fields as jax_12_fields

from haplohyped_tpu_torch.hostio import native
from haplohyped_tpu_torch.hostio.frame_format import frames12_from_frames64, frames12_to_fields
from haplohyped_tpu_torch.hostio.bcf import is_bcf
from haplohyped_tpu_torch.hostio.vcf import VCFSource
from haplohyped_tpu_torch.ops import _build

from chip_smoke import DECODE_EDGE_VCF
from tests.test_frame12 import EDGE_VCF
from tests.test_vcf_decode import corpus_samples


@pytest.fixture(scope="module")
def vcfs(test_data_dir, tmp_path_factory):
    """``{name: (path, samples)}``: the corpus and the two edge VCFs."""
    d = tmp_path_factory.mktemp("hostio")
    out = {"corpus": (str(test_data_dir / "chr22.filtered.vcf.gz"),
                      corpus_samples(test_data_dir))}
    for name, text in (("edge", EDGE_VCF), ("decode_edge", DECODE_EDGE_VCF)):
        path = d / f"{name}.vcf"
        path.write_text(text)
        out[name] = (str(path), ["s1", "s2"])
    gz = d / "decode_edge.vcf.gz"
    with gzip.open(gz, "wt") as f:
        f.write(DECODE_EDGE_VCF)
    out["decode_edge_gz"] = (str(gz), ["s1", "s2"])
    return out


def many_contigs_vcf(path, n_contigs: int = 300) -> str:
    """One SNP on each of ``n_contigs`` contigs: more than the 12-byte
    layout's 255-entry chrom table."""
    rows = ["##fileformat=VCFv4.2",
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ts1"]
    rows += [f"ctg{i}\t{100 + i}\t.\tA\tG\t.\tPASS\t.\tGT\t0|1" for i in range(n_contigs)]
    with gzip.open(path, "wt") as f:
        f.write("\n".join(rows) + "\n")
    return str(path)


NAMES = ["corpus", "edge", "decode_edge", "decode_edge_gz"]
REGIONS = [None, "chr22", "chr1", "chr2", "chr1:150-350", "chr22:16050000-16100000"]


def test_native_library_lives_in_the_ports_build_dir():
    lib = native._load()
    path = _build.BUILD_DIR / next(p.name for p in _build.BUILD_DIR.glob("libhh_hostio-*.so"))
    assert path.exists()
    assert lib._name.startswith(str(_build.BUILD_DIR))
    assert "haplohyped_tpu/_native" not in lib._name


@pytest.mark.parametrize("name", NAMES)
def test_samples_and_seqnames_match_jax(vcfs, name):
    path, samples = vcfs[name]
    src, ref = VCFSource(path), JaxVCFSource(path)
    assert src.samples() == ref.samples() == samples
    assert VCFSource(path, use_native=False).samples() == samples
    assert src.seqnames() == ref.seqnames()


@pytest.mark.parametrize("region", REGIONS)
@pytest.mark.parametrize("name", NAMES)
def test_frames_match_jax(vcfs, name, region):
    path, samples = vcfs[name]
    src, ref = VCFSource(path, threads=2), JaxVCFSource(path, threads=2)
    for sample in samples + [None]:
        got, want = src.frame(sample, region), ref.frame(sample, region)
        np.testing.assert_array_equal(got.records, want.records)
        assert got.total_seen == want.total_seen and got.n == want.n
        got12, want12 = src.frame12(sample, region), ref.frame12(sample, region)
        np.testing.assert_array_equal(got12[0], want12[0])
        assert got12[1:] == want12[1:]


@pytest.mark.parametrize("name", ["corpus", "edge"])
def test_python_framer_matches_native(vcfs, name):
    path, samples = vcfs[name]
    native_src, py_src = VCFSource(path), VCFSource(path, use_native=False)
    for sample in samples:
        a, b = native_src.frame(sample), py_src.frame(sample)
        np.testing.assert_array_equal(a.records, b.records)
        assert a.total_seen == b.total_seen
        a12, b12 = native_src.frame12(sample), py_src.frame12(sample)
        np.testing.assert_array_equal(a12[0], b12[0])
        assert a12[1:] == b12[1:]


@pytest.mark.parametrize("name", NAMES)
def test_python_framer_matches_jax_python_framer(vcfs, name):
    path, samples = vcfs[name]
    src = VCFSource(path, use_native=False)
    ref = JaxVCFSource(path, use_native=False)
    for sample in samples:
        np.testing.assert_array_equal(src.frame(sample).records, ref.frame(sample).records)
        got12, want12 = src.frame12(sample), ref.frame12(sample)
        np.testing.assert_array_equal(got12[0], want12[0])
        assert got12[1:] == want12[1:]
        np.testing.assert_array_equal(frames12_from_frames64(src.frame(sample).records)[0],
                                      jax_12_from_64(src.frame(sample).records)[0])
        got, want = frames12_to_fields(got12[0]), jax_12_fields(want12[0])
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("use_native", [True, False])
def test_frame12_refuses_more_than_255_contigs(tmp_path, use_native):
    path = many_contigs_vcf(tmp_path / "ctg300.vcf.gz")
    src = VCFSource(path, use_native=use_native)
    with pytest.raises(ValueError, match="255"):
        src.frame12(sample="s1")
    framed = src.frame(sample="s1")
    assert framed.n == 300
    np.testing.assert_array_equal(framed.records, JaxVCFSource(path).frame(sample="s1").records)


def test_sample_missing_from_header_raises(vcfs):
    path, _ = vcfs["edge"]
    for use_native in (True, False):
        with pytest.raises(RuntimeError, match="sample not found"):
            VCFSource(path, use_native=use_native).frame12(sample="nobody")


def test_is_bcf(vcfs, test_data_dir, tmp_path):
    from tests.bcf_writer import vcf_text_to_bcf

    vcf = str(test_data_dir / "chr22.filtered.vcf.gz")
    bcf = vcf_text_to_bcf(vcf, str(tmp_path / "chr22.bcf"))
    plain = tmp_path / "plain.bcf"
    plain.write_bytes(b"BCF\x02\x02" + b"\0" * 32)
    for path in (bcf, str(plain)):
        assert is_bcf(path) and jax_native.is_bcf(path)
    for path in (vcf, vcfs["edge"][0]):
        assert not is_bcf(path) and not jax_native.is_bcf(path)


@pytest.mark.parametrize("name", NAMES)
def test_frames_to_fields_matches_jax(vcfs, name):
    from haplohyped_tpu.hostio.frame_format import frames_to_fields as jax_fields

    from haplohyped_tpu_torch.hostio.frame_format import frames_to_fields

    path, samples = vcfs[name]
    records = VCFSource(path).frame(samples[-1]).records
    got, want = frames_to_fields(records), jax_fields(records)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("region", REGIONS)
@pytest.mark.parametrize("name", NAMES)
def test_count_variants_matches_jax(vcfs, name, region):
    path, _ = vcfs[name]
    got = VCFSource(path).count_variants(region)
    assert got == JaxVCFSource(path).count_variants(region)
    assert got == VCFSource(path, use_native=False).count_variants(region)


def test_vcf_text_and_index_match_jax(vcfs):
    """The native text and index bindings: the same bytes, offsets, tab
    bounds and POS as the JAX package's, and nothing left after close()."""
    for name in NAMES:
        path, samples = vcfs[name]
        got, want = native.vcf_index(path, threads=2), jax_native.vcf_index(path, threads=2)
        try:
            assert got.samples == want.samples == samples and got.n_lines == want.n_lines
            for k in ("text", "line_offsets", "line_lengths", "bounds", "pos"):
                g, w = getattr(got, k), getattr(want, k)
                assert g.dtype == w.dtype and np.array_equal(g, w), k
        finally:
            got.close()
            want.close()
        assert got.text is None and got.bounds is None
        jax_text = jax_native.vcf_text(path)
        with native.vcf_text(path) as text:
            np.testing.assert_array_equal(text.line_offsets, jax_text.line_offsets)
        jax_text.close()
    assert native.native_available()
    with pytest.raises(RuntimeError):
        native.vcf_text(str(vcfs["edge"][0]) + ".missing")
