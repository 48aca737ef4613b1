"""The port's tabix/CSI indexes and indexed v2 framing against the JAX package.

``build_index`` must write the JAX package's ``.tbi`` and ``.csi`` byte for
byte (the gzip header's timestamp aside), the readers must load the same
bins, and ``region_block_range``/``region_virtual_offset`` must give the
same spans on a multi-contig BGZF file.  ``frame_v2(use_index=True)`` of a
region must equal the same framing of the whole file while inflating fewer
blocks.
"""

import gzip
import shutil

import numpy as np
import pytest

from haplohyped_tpu.hostio import VCFSource as JaxVCFSource
from haplohyped_tpu.hostio import tabix as jax_tabix
from haplohyped_tpu.hostio.bgzf import bgzf_write

from haplohyped_tpu_torch.hostio import native, tabix
from haplohyped_tpu_torch.hostio.vcf import VCFSource

from tests.test_torch_frame_v2 import assert_frames_equal

CHROMS = ("chr1", "chr2", "chr3")


@pytest.fixture(scope="module")
def multichrom(tmp_path_factory):
    """Three contigs x 20,000 records in one BGZF file (many blocks), in a
    directory of its own for each package's indexes."""
    rng = np.random.default_rng(5)
    rows = ["##fileformat=VCFv4.2", "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ts1\ts2"]
    gts = np.array(["0|0", "0|1", "1|0", "1|1", "./."])
    for chrom in CHROMS:
        pos = np.cumsum(rng.integers(10, 500, size=20_000)) + 1
        g = gts[rng.integers(0, 5, size=(20_000, 2))]
        rows += [f"{chrom}\t{pos[i]}\t.\tA\tG\t.\tPASS\t.\tGT\t{g[i, 0]}\t{g[i, 1]}"
                 for i in range(20_000)]
    d = tmp_path_factory.mktemp("tabix")
    paths = {}
    for who in ("port", "jax", "plain"):
        (d / who).mkdir()
        paths[who] = str(d / who / "multi.vcf.gz")
    bgzf_write(paths["plain"], ("\n".join(rows) + "\n").encode(), level=1)
    for who in ("port", "jax"):
        shutil.copy(paths["plain"], paths[who])
    return paths


def _stamp_free(path: str) -> bytes:
    """The file's bytes with the gzip header's mtime zeroed."""
    raw = bytearray(open(path, "rb").read())
    raw[4:8] = b"\0\0\0\0"
    return bytes(raw)


@pytest.mark.parametrize("fmt", ["tbi", "csi"])
def test_build_index_is_byte_equal_to_jax(multichrom, fmt):
    got = tabix.build_index(multichrom["port"], fmt=fmt)
    want = jax_tabix.build_index(multichrom["jax"], fmt=fmt)
    assert got.endswith("." + fmt) and got.split("/")[-1] == want.split("/")[-1]
    assert _stamp_free(got) == _stamp_free(want)
    assert gzip.decompress(open(got, "rb").read()) == gzip.decompress(open(want, "rb").read())


def test_index_readers_match_jax(multichrom):
    tabix.build_index(multichrom["port"], fmt="tbi")
    tabix.build_index(multichrom["port"], fmt="csi")
    t, jt = (m.TabixIndex.load(multichrom["port"] + ".tbi") for m in (tabix, jax_tabix))
    assert t.names == jt.names == list(CHROMS)
    assert [(r.bins, r.linear) for r in t.refs] == [(r.bins, r.linear) for r in jt.refs]
    c, jc = (m.CSIIndex.load(multichrom["port"] + ".csi") for m in (tabix, jax_tabix))
    assert (c.names, c.min_shift, c.depth, c.refs) == (jc.names, jc.min_shift, jc.depth, jc.refs)
    for chrom in CHROMS + ("chrX",):
        for beg in (0, 5_000, 1_000_000, 4_000_000, 20_000_000):
            assert t.min_offset(chrom, beg) == jt.min_offset(chrom, beg)
            assert c.min_offset(chrom, beg) == jc.min_offset(chrom, beg)
            assert t.query_chunks(chrom, beg, beg + 300_000) == jt.query_chunks(
                chrom, beg, beg + 300_000)


def test_binning_matches_jax():
    rng = np.random.default_rng(1)
    for beg in [0, 1, (1 << 14) - 1, 1 << 14, 1 << 26] + rng.integers(0, 1 << 29, 300).tolist():
        for span in (1, 100, 1 << 14, 1 << 17, 1 << 21, 1 << 27):
            assert tabix.reg2bin(beg, beg + span) == jax_tabix.reg2bin(beg, beg + span)
            assert tabix.reg2bins(beg, beg + span) == jax_tabix.reg2bins(beg, beg + span)
            assert tabix.reg2bin_csi(beg, beg + span) == jax_tabix.reg2bin_csi(beg, beg + span)


REGIONS = [("chr1", -1, -1), ("chr2", -1, -1), ("chr3", -1, -1), ("chr2", 100_000, 200_000),
           ("chr3", 0, 50_000), ("chrX", -1, -1)]


@pytest.mark.parametrize("fmt", ["tbi", "csi"])
def test_region_spans_match_jax(multichrom, tmp_path, fmt):
    vcf = str(tmp_path / "m.vcf.gz")
    shutil.copy(multichrom["plain"], vcf)
    assert tabix.region_block_range(vcf, "chr2") is None  # no index yet
    tabix.build_index(vcf, fmt=fmt)
    for chrom, beg, end in REGIONS:
        got = tabix.region_block_range(vcf, chrom, beg, end)
        assert got == jax_tabix.region_block_range(vcf, chrom, beg, end), (chrom, beg, end)
        assert (got is None) == (chrom == "chrX")
        assert tabix.region_virtual_offset(vcf, chrom, max(beg, 0)) == \
            jax_tabix.region_virtual_offset(vcf, chrom, max(beg, 0))


@pytest.mark.parametrize("fmt", ["tbi", "csi"])
@pytest.mark.parametrize("region", ["chr1", "chr2", "chr3", "chr3:100000-200000"])
def test_indexed_frame_v2_equals_full_scan(multichrom, tmp_path, fmt, region):
    vcf = str(tmp_path / "m.vcf.gz")
    shutil.copy(multichrom["plain"], vcf)
    full = VCFSource(vcf, threads=2).frame_v2(samples="*", region=region, use_index=False)
    assert full.blocks_decoded == -1
    tabix.build_index(vcf, fmt=fmt)
    with native.BgzfRangeReader(vcf) as reader:
        n_blocks = reader.n_blocks
    before = native.DECOMPRESS_COUNT
    indexed = VCFSource(vcf, threads=2).frame_v2(samples="*", region=region)
    assert native.DECOMPRESS_COUNT - before == 1
    assert 0 < indexed.blocks_decoded < n_blocks
    assert indexed.n == full.n > 0 and indexed.chroms == [region.split(":")[0]]
    for name in ("gt", "run_counts", "run_ids", "samples"):
        got, want = getattr(indexed, name), getattr(full, name)
        assert (np.array_equal(got, want) if isinstance(want, np.ndarray) else got == want), name
    # both framings decode to the same records (the deltas and escapes may
    # differ: the framer's threads split a range where they split the file)
    from haplohyped_tpu_torch.ops.vcf_decode import decode_frames_v2_numpy as dec

    a = dec(indexed.fixed, indexed.gt, indexed.exc_idx, indexed.exc_pos, indexed.run_counts,
            indexed.run_ids)
    b = dec(full.fixed, full.gt, full.exc_idx, full.exc_pos, full.run_counts, full.run_ids)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    jax_indexed = JaxVCFSource(vcf, threads=2).frame_v2(samples="*", region=region)
    assert_frames_equal(indexed, jax_indexed, f"{fmt} {region}")


def test_bgzf_reader(multichrom):
    with native.BgzfRangeReader(multichrom["plain"]) as r:
        assert r.n_blocks > 10
        assert r.uoffset(0) == 0 and r.uoffset(r.n_blocks) == r.total_usize
        buf = np.empty(r.total_usize, np.uint8)
        nl = r.decode_range(0, r.n_blocks, 2, buf)
        assert r.block_at(r.coffset(3)) == 3
        with pytest.raises(ValueError, match="buffer holds"):
            r.decode_range(0, r.n_blocks, 1, np.empty(10, np.uint8))
    text = gzip.decompress(open(multichrom["plain"], "rb").read())
    assert buf.tobytes() == text
    np.testing.assert_array_equal(nl, np.flatnonzero(np.frombuffer(text, np.uint8) == 10))
    with pytest.raises(RuntimeError):
        native.BgzfRangeReader(multichrom["plain"] + ".missing")
