"""The port's VCF decode against the JAX package, bit for bit.

The port's plain PyTorch ``decode_frames12_packed`` (unpacked on the host)
and ``decode_frames``/``decode_frames_packed`` must equal, column by column,
the JAX package's XLA decode, its Pallas kernels in interpret mode and its
numpy twins.  Frames come from the JAX framer on the ``tests/data`` corpus,
on the edge VCF of ``tests/test_frame12.py`` and on ``chip_smoke.py``'s
decode edge VCF, and from seeded random bytes at N that is no multiple of
the Pallas blocks (1024 and 2048); every case runs with and without a
sample.  The Hopper kernels themselves run only on a card
(``test_kernels_match_plain_on_card``, marked ``cuda``; ``chip_smoke.py``
makes the same checks at full size there).
"""

import numpy as np
import pytest
import torch

from haplohyped_tpu.hostio import VCFSource as JaxVCFSource
from haplohyped_tpu.ops import vcf_decode as jax_decode
from haplohyped_tpu.ops.pallas_decode import decode_frames12_pallas, decode_frames_pallas

from haplohyped_tpu_torch.ops import vcf_decode
from haplohyped_tpu_torch.ops.decode_kernel import (
    decode_frames12_kernel,
    decode_frames_kernel,
)

from chip_smoke import DECODE_EDGE_VCF
from tests.test_frame12 import EDGE_VCF
from tests.test_vcf_decode import corpus_samples

RANDOM_N = (1, 1023, 1025, 2049)
SOURCES = [f"corpus-{i}" for i in range(3)] + ["edge-s1", "edge-s2", "decode_edge-s1",
                                               "decode_edge-s2"] + [f"random-{n}" for n in RANDOM_N]
COLUMNS64 = ("start", "stop", "ref_char", "alt_char", "ref_code", "alt_code", "phase1",
             "phase2", "phased", "missing", "snp_mask", "valid")


@pytest.fixture(scope="module")
def frames(test_data_dir, tmp_path_factory):
    """``{source: (frames64, frames12)}`` as uint8 numpy arrays."""
    out = {}
    vcf = str(test_data_dir / "chr22.filtered.vcf.gz")
    src = JaxVCFSource(vcf)
    for i, sample in enumerate(corpus_samples(test_data_dir)):
        out[f"corpus-{i}"] = (src.frame(sample=sample).records,
                              src.frame12(sample=sample)[0])
    d = tmp_path_factory.mktemp("decode_edges")
    for name, text in (("edge", EDGE_VCF), ("decode_edge", DECODE_EDGE_VCF)):
        path = d / f"{name}.vcf"
        path.write_text(text)
        src = JaxVCFSource(str(path))
        for sample in ("s1", "s2"):
            out[f"{name}-{sample}"] = (src.frame(sample=sample).records,
                                       src.frame12(sample=sample)[0])
    rng = np.random.default_rng(2024)
    for n in RANDOM_N:
        out[f"random-{n}"] = (rng.integers(0, 256, (n, 64), dtype=np.uint8),
                              rng.integers(0, 256, (n, 12), dtype=np.uint8))
    return out


def assert_columns_equal(got: dict, want: dict, what: str):
    assert set(want) <= set(got), what
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, f"{what}: {k} {g.dtype} {w.dtype}"
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {k}")


def port12(f12: np.ndarray, with_sample: bool) -> dict:
    packed = vcf_decode.decode_frames12_packed(torch.from_numpy(f12), with_sample)
    return vcf_decode.unpack12_columns(*(t.numpy() for t in packed))


def port64(f64: np.ndarray, with_sample: bool) -> dict:
    packed = vcf_decode.decode_frames_packed(torch.from_numpy(f64), with_sample)
    return vcf_decode.unpack64_columns(*(t.numpy() for t in packed))


@pytest.mark.parametrize("with_sample", [True, False])
@pytest.mark.parametrize("source", SOURCES)
def test_decode12_matches_jax(frames, source, with_sample):
    f12 = frames[source][1]
    assert f12.shape[0] > 0
    got = port12(f12, with_sample)
    jp = jax_decode.decode_frames12_packed(f12, with_sample)
    packed = vcf_decode.decode_frames12_packed(torch.from_numpy(f12), with_sample)
    for name, g, w in zip(("start", "meta", "ref_len"), packed, jp):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"packed {name}")
    assert_columns_equal(got, jax_decode.unpack12_columns(*(np.asarray(x) for x in jp)), "xla")
    assert_columns_equal(got, decode_frames12_pallas(f12, with_sample, interpret=True),
                         "pallas")
    assert_columns_equal(got, jax_decode.decode_frames12_numpy(f12, with_sample), "numpy")
    dict12 = vcf_decode.decoded_to_numpy(vcf_decode.decode_frames12(torch.from_numpy(f12),
                                                                    with_sample))
    assert_columns_equal(dict12, jax_decode.decode_frames12_numpy(f12, with_sample), "dict")


@pytest.mark.parametrize("with_sample", [True, False])
@pytest.mark.parametrize("source", SOURCES)
def test_decode64_matches_jax(frames, source, with_sample):
    f64 = frames[source][0]
    assert f64.shape[0] > 0
    got = vcf_decode.decoded_to_numpy(vcf_decode.decode_frames(torch.from_numpy(f64),
                                                               with_sample))
    want = jax_decode.decoded_to_numpy(jax_decode.decode_frames(f64, with_sample))
    assert_columns_equal(got, want, "xla")
    assert_columns_equal(got, jax_decode.decode_frames_numpy(f64, with_sample), "numpy")
    assert_columns_equal(port64(f64, with_sample), {k: want[k] for k in COLUMNS64}, "packed")
    assert_columns_equal(port64(f64, with_sample),
                         decode_frames_pallas(f64, with_sample, interpret=True), "pallas")


def test_port_numpy_twins_are_the_jax_ones(frames):
    for source in SOURCES:
        f64, f12 = frames[source]
        for ws in (True, False):
            assert_columns_equal(vcf_decode.decode_frames12_numpy(f12, ws),
                                 jax_decode.decode_frames12_numpy(f12, ws), source)
            assert_columns_equal(vcf_decode.decode_frames_numpy(f64, ws),
                                 jax_decode.decode_frames_numpy(f64, ws), source)


def test_edge_semantics(frames):
    """What the decode edge VCF pins: POS 0 wraps start to 0xFFFFFFFF,
    missing genotypes code (1, 0), haploid and overlong-POS records are
    invalid, lowercase and '*' ALTs are no SNP."""
    f64, f12 = frames["decode_edge-s1"]
    d = port12(f12, True)
    assert len(d["start"]) == f64.shape[0]
    by_pos = {bytes(r[9:9 + r[21]]).decode(): i for i, r in enumerate(f64)}
    assert d["start"][by_pos["0"]] == 0xFFFFFFFF
    for pos in ("200", "250"):  # './.' and '1|.'
        i = by_pos[pos]
        assert d["missing"][i] and (d["phase1"][i], d["phase2"][i]) == (1, 0)
    assert not d["valid"][by_pos["300"]]  # haploid
    assert not d["valid"][by_pos["12345678901"]]  # 11 digits
    assert not d["snp_mask"][by_pos["500"]]  # lowercase ALT
    assert not d["snp_mask"][by_pos["600"]]  # '*' ALT
    assert d["phase1"][by_pos["800"]] == 1  # 0xB nibble: allele present


def test_wrappers_run_plain_versions_on_cpu_tensors(frames):
    f64, f12 = frames["random-1025"]
    before = (decode_frames12_kernel.launches, decode_frames_kernel.launches)
    got12 = decode_frames12_kernel(torch.from_numpy(f12))
    got64 = decode_frames_kernel(torch.from_numpy(f64))
    assert (decode_frames12_kernel.launches, decode_frames_kernel.launches) == before
    for g, w in zip(got12, vcf_decode.decode_frames12_packed(torch.from_numpy(f12))):
        assert torch.equal(g, w)
    for g, w in zip(got64, vcf_decode.decode_frames_packed(torch.from_numpy(f64))):
        assert torch.equal(g, w)
    assert [t.dtype for t in got12 + got64] == [torch.int32] * 10


def test_wrappers_refuse_other_devices_and_shapes():
    meta12 = torch.empty((4, 12), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no decode12 kernel"):
        decode_frames12_kernel(meta12)
    with pytest.raises(ValueError, match="no decode64 kernel"):
        decode_frames_kernel(torch.empty((4, 64), dtype=torch.uint8, device="meta"))
    with pytest.raises(ValueError, match=r"\(N, 12\) uint8"):
        decode_frames12_kernel(torch.zeros((4, 64), dtype=torch.uint8))
    with pytest.raises(ValueError, match=r"\(N, 64\) uint8"):
        decode_frames_kernel(torch.zeros((4, 64), dtype=torch.int32))


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_on_card(frames, card):
    for source in SOURCES:
        f64, f12 = frames[source]
        for ws in (True, False):
            t12, t64 = torch.from_numpy(f12).to(card), torch.from_numpy(f64).to(card)
            pairs = list(zip(decode_frames12_kernel(t12, ws),
                             vcf_decode.decode_frames12_packed(t12, ws)))
            pairs += zip(decode_frames_kernel(t64, ws), vcf_decode.decode_frames_packed(t64, ws))
            torch.cuda.synchronize()
            for g, w in pairs:
                assert torch.equal(g.cpu(), w.cpu()), source
