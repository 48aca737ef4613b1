"""The port's v2 decode and ``decode_planes12`` against the JAX package.

``decode_frames_v2`` (torch, on the CPU) must equal, column by column with
the JAX package's dtypes, the JAX package's XLA ``decode_frames_v2`` and the
numpy twins of both packages: on frames of the framer (the ``tests/data``
corpus, the edge VCFs) and on seeded random ``(N, 5)``/``(N, S)`` bytes with
random escapes, POS anchors that wrap uint32 and zero-width runs, for N in
{0, 1, 4097} and S in {0, 1, 7}; with the side arrays as framed and padded
by ``pad_v2_sides``.  At N = 0 the JAX package's XLA decode refuses the
frame (its converter decodes an empty frame with numpy), so only the twins
are compared there.  The converter's blocked decode to the host must not
depend on the sample block.
"""

import gzip

import numpy as np
import pytest
import torch

from haplohyped_tpu.hostio import VCFSource as JaxVCFSource
from haplohyped_tpu.hostio import frame_format as jax_ff
from haplohyped_tpu.ops import vcf_decode as jax_decode

from haplohyped_tpu_torch.hostio.frame_format import (
    V2F_POS_ESCAPE,
    V2F_REF1,
    V2F_WELL_FORMED,
    V2_STOP_SENTINEL,
    FrameV2,
)
from haplohyped_tpu_torch.ops import vcf_decode
from haplohyped_tpu_torch.pipeline import vcf_to_h5

from chip_smoke import DECODE_EDGE_VCF
from tests.test_frame_v2 import EDGE_VCF
from tests.test_torch_decode import assert_columns_equal

RANDOM = [(n, s) for n in (0, 1, 4097) for s in (0, 1, 7)]


def random_frame(n: int, s: int, seed: int) -> FrameV2:
    """Random fixed and GT bytes; escapes where the flag says so, anchored
    anywhere in uint32 (so re-anchors wrap); runs with zero-width ones."""
    rng = np.random.default_rng(seed)
    fixed = rng.integers(0, 256, (n, 5), dtype=np.uint8)
    if n:
        fixed[0, 4] |= V2F_POS_ESCAPE
    exc_idx = np.flatnonzero(fixed[:, 4] & V2F_POS_ESCAPE).astype(np.int64)
    exc_pos = rng.integers(0, 2**32, exc_idx.shape[0], dtype=np.uint64).astype(np.uint32)
    cuts = np.sort(rng.integers(0, n + 1, 5))
    counts = np.diff(np.concatenate([[0], cuts, [n]])).astype(np.int64)  # zeros included
    return FrameV2(fixed=fixed, gt=rng.integers(0, 256, (n, s), dtype=np.uint8),
                   exc_idx=exc_idx, exc_pos=exc_pos, run_counts=counts,
                   run_ids=rng.integers(0, 256, counts.shape[0], dtype=np.uint8),
                   chroms=[], samples=[], total_seen=n)


@pytest.fixture(scope="module")
def frames(test_data_dir, tmp_path_factory):
    """``{source: FrameV2}`` from the JAX framer and from seeded bytes."""
    out = {}
    src = JaxVCFSource(str(test_data_dir / "chr22.filtered.vcf.gz"), threads=2)
    out["corpus"] = src.frame_v2(samples="*")
    out["corpus-none"] = src.frame_v2(samples=None)
    d = tmp_path_factory.mktemp("dv2")
    for name, text in (("edge", EDGE_VCF), ("decode_edge", DECODE_EDGE_VCF)):
        path = d / f"{name}.vcf.gz"
        with gzip.open(path, "wt") as f:
            f.write(text)
        out[name] = JaxVCFSource(str(path)).frame_v2(samples=["s1", "s2"])
    for i, (n, s) in enumerate(RANDOM):
        out[f"random-{n}x{s}"] = random_frame(n, s, seed=100 + i)
    return out


def sides(frame, padded: bool):
    if padded:
        return vcf_decode.pad_v2_sides(frame)
    return frame.exc_idx, frame.exc_pos, frame.run_counts, frame.run_ids


def port_v2(fixed, gt, exc_idx, exc_pos, run_counts, run_ids) -> dict:
    t = [torch.from_numpy(a) for a in (fixed, gt, exc_idx, exc_pos.astype(np.int64),
                                       run_counts, run_ids)]
    return vcf_decode.decoded_to_numpy(vcf_decode.decode_frames_v2(*t))


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("source", ["corpus", "corpus-none", "edge", "decode_edge"]
                         + [f"random-{n}x{s}" for n, s in RANDOM])
def test_decode_v2_matches_jax(frames, source, padded):
    fv = frames[source]
    args = (fv.fixed, fv.gt, *sides(fv, padded))
    got = port_v2(*args)
    want = jax_decode.decode_frames_v2_numpy(*args)
    assert list(got) == list(want)
    assert_columns_equal(got, want, "jax numpy twin")
    assert_columns_equal(vcf_decode.decode_frames_v2_numpy(*args), want, "port numpy twin")
    if fv.n:
        xla = {k: np.asarray(v) for k, v in jax_decode.decode_frames_v2(*args).items()}
        assert_columns_equal(got, xla, "xla")
    assert got["phase1"].shape == (fv.n, fv.gt.shape[1])


def test_pads_are_inert(frames):
    for source, fv in frames.items():
        plain = port_v2(fv.fixed, fv.gt, *sides(fv, False))
        assert_columns_equal(port_v2(fv.fixed, fv.gt, *sides(fv, True)), plain, source)
    ei, ep, rc, ri = vcf_decode.pad_v2_sides(frames["edge"])
    want = jax_decode.pad_v2_sides(frames["edge"])
    for g, w in zip((ei, ep, rc, ri), want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert ei.shape == (8,) and (ei[frames["edge"].exc_idx.shape[0]:] == frames["edge"].n).all()


def test_reanchors_wrap_uint32():
    """A chain anchored at 0xFFFFFFF0 that walks past 2^32 wraps; a later
    anchor below the chain's value is a "negative" correction; POS 0 gives
    start 0xFFFFFFFF; a multi-base REF gets the stop sentinel."""
    flags = V2F_WELL_FORMED | V2F_REF1
    deltas = [0, 5, 65535, 7, 0, 3, 0]
    fixed = np.zeros((7, 5), np.uint8)
    fixed[:, 0] = [d & 0xFF for d in deltas]
    fixed[:, 1] = [d >> 8 for d in deltas]
    fixed[:, 2:4] = ord("A"), ord("C")
    fixed[:, 4] = flags
    fixed[[0, 4, 6], 4] |= V2F_POS_ESCAPE
    fixed[5, 4] &= ~V2F_REF1 & 0xFF
    exc_idx = np.array([0, 4, 6], np.int64)
    exc_pos = np.array([0xFFFFFFF0, 1000, 0], np.uint32)
    args = (fixed, np.zeros((7, 0), np.uint8), exc_idx, exc_pos,
            np.array([7], np.int64), np.array([0], np.uint8))
    got = port_v2(*args)
    pos = np.array([0xFFFFFFF0, 0xFFFFFFF5, 0xFFFFFFF5 + 65535, 0xFFFFFFF5 + 65542,
                    1000, 1003, 0]) & 0xFFFFFFFF
    np.testing.assert_array_equal(got["start"], (pos - 1) & 0xFFFFFFFF)
    assert got["start"][6] == 0xFFFFFFFF and got["stop"][5] == V2_STOP_SENTINEL
    assert_columns_equal(got, jax_decode.decode_frames_v2_numpy(*args), "numpy")
    assert_columns_equal(got, {k: np.asarray(v) for k, v in
                               jax_decode.decode_frames_v2(*args).items()}, "xla")


@pytest.mark.parametrize("block", [1, 7, 4097 * 3, 1 << 30])
def test_blocked_decode_to_host_is_the_decode(frames, monkeypatch, block):
    """The converter's decode (genotype columns a sample block at a time,
    transposed to (S, N) on the device) equals the unblocked decode for
    every block size: 1 byte (one sample a block), blocks that do not
    divide S, and one block."""
    monkeypatch.setattr(vcf_to_h5, "GT_BLOCK_BYTES", block)
    for source in ("corpus", "edge", "random-4097x7", "random-1x7", "random-4097x0"):
        fv = frames[source]
        got = vcf_to_h5.decode_v2_to_host(*vcf_to_h5.upload_v2(fv, torch.device("cpu")))
        want = port_v2(fv.fixed, fv.gt, *sides(fv, False))
        assert set(got) == set(vcf_to_h5.V2_RECORD_COLUMNS) | set(vcf_to_h5.V2_GENOTYPE_COLUMNS)
        assert_columns_equal(got, {k: want[k] for k in got}, f"{source} block {block}")
        assert got["phase1"].base is not None and got["phase1"].T.flags.c_contiguous


def test_empty_frame_decodes_with_numpy(frames, monkeypatch):
    monkeypatch.setattr(vcf_to_h5, "decode_v2_to_host",
                        lambda *a: pytest.fail("an empty frame reached the device path"))
    fv = frames["random-0x7"]
    got = vcf_to_h5._decode_v2(fv, torch.device("cpu"))
    assert got["phase1"].shape == (0, 7) and got["start"].dtype == np.uint32


@pytest.mark.parametrize("with_sample", [True, False])
@pytest.mark.parametrize("source", ["corpus", "random"])
def test_decode_planes12_matches_jax(test_data_dir, source, with_sample):
    if source == "corpus":
        f12 = JaxVCFSource(str(test_data_dir / "chr22.filtered.vcf.gz")).frame12(
            "1b7d7ba3-0826-468c-a375-14ef387ca525")[0]
    else:
        f12 = np.random.default_rng(12).integers(0, 256, (2049, 12), dtype=np.uint8)
    planes = np.ascontiguousarray(f12.T)
    got = vcf_decode.decoded_to_numpy(vcf_decode.decode_planes12(torch.from_numpy(planes),
                                                                 with_sample))
    want = {k: np.asarray(v) for k, v in jax_decode.decode_planes12(planes, with_sample).items()}
    assert sorted(got) == sorted(want)  # jit returns its dict with sorted keys
    assert_columns_equal(got, want, "planes")
    assert_columns_equal(got, jax_decode.decode_frames12_numpy(f12, with_sample), "numpy")
    with pytest.raises(ValueError, match=r"\(12, N\)"):
        vcf_decode.decode_planes12(torch.from_numpy(f12))


def test_v2_constants_match_jax():
    from haplohyped_tpu_torch.hostio import frame_format

    names = [n for n in dir(jax_ff) if n.startswith(("V2_", "V2F_", "V2G_"))]
    assert len(names) > 15
    for n in names:
        assert getattr(frame_format, n) == getattr(jax_ff, n), n
