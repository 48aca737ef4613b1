"""The port's FASTA encoder against the JAX package's.

The one-hot and codes (torch ops, on the CPU here) must equal JAX
``ascii_to_codes``/``codes_to_onehot`` for every byte value, and
``encode_fasta`` must write a ``reference_genome.h5`` equal to the JAX
encoder's dataset by dataset: names, dtype, shape, chunks, filter id and
options, values.  The card's encode is held to ``encode_host`` by the
``cuda``-marked test here and by ``chip_smoke.py`` phase 15.
"""

import os
import shutil

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haplohyped_tpu.core.config import FastaEncodeConfig as JaxFastaEncodeConfig
from haplohyped_tpu.data.genome import GenomeTensors as JaxGenomeTensors
from haplohyped_tpu.ops.onehot import ascii_to_codes as jax_ascii_to_codes
from haplohyped_tpu.ops.onehot import codes_to_onehot as jax_codes_to_onehot
from haplohyped_tpu.ops.onehot import encode_ascii_onehot as jax_encode_ascii_onehot
from haplohyped_tpu.pipeline.fasta_encoder import HDF5Handler as JaxHDF5Handler
from haplohyped_tpu.pipeline.fasta_encoder import ReferenceGenome as JaxReferenceGenome
from haplohyped_tpu.pipeline.fasta_encoder import encode_fasta as jax_encode_fasta
from haplohyped_tpu_torch.core.config import FastaEncodeConfig
from haplohyped_tpu_torch.data.genome import GenomeTensors
from haplohyped_tpu_torch.ops.onehot import codes_to_onehot, encode_ascii_onehot
from haplohyped_tpu_torch.pipeline import main as cli
from haplohyped_tpu_torch.pipeline.fasta_encoder import (
    HDF5Handler,
    ReferenceGenome,
    encode_fasta,
    encode_host,
    encode_onehot_and_codes,
)
from haplohyped_tpu_torch.storage.blosc import needs_blosc, read_dataset

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def all_bytes(seed: int = 0) -> bytes:
    """Every byte value, then 4,096 random ones."""
    rng = np.random.default_rng(seed)
    return bytes(range(256)) + rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()


def test_encode_every_byte_value_matches_jax():
    raw = all_bytes()
    onehot, codes = encode_onehot_and_codes(raw, device="cpu")
    arr = jnp.asarray(np.frombuffer(raw, np.uint8))
    jax_codes = jax_ascii_to_codes(arr)
    assert codes.dtype == np.int8 and onehot.dtype == np.uint8
    assert onehot.shape == (len(raw), 5)
    np.testing.assert_array_equal(codes, np.asarray(jax_codes))
    np.testing.assert_array_equal(onehot, np.asarray(jax_codes_to_onehot(jax_codes)))
    host_onehot, host_codes = encode_host(np.frombuffer(raw, np.uint8))
    np.testing.assert_array_equal(onehot, host_onehot)
    np.testing.assert_array_equal(codes, host_codes)
    t = torch.from_numpy(np.frombuffer(raw, np.uint8).copy())
    np.testing.assert_array_equal(encode_ascii_onehot(t, dtype=torch.float32).numpy(),
                                  np.asarray(jax_encode_ascii_onehot(arr, dtype=jnp.float32)))


@pytest.mark.parametrize("num_channels", [3, 5, 8])
def test_codes_to_onehot_out_of_range_rows_match_jax(num_channels):
    codes = np.arange(-2, 10, dtype=np.int8)
    got = codes_to_onehot(torch.from_numpy(codes), num_channels=num_channels)
    want = jax_codes_to_onehot(jnp.asarray(codes), num_channels=num_channels)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.uint8 and int(got[codes >= num_channels].sum()) == 0


def test_encode_accepts_a_numpy_array_and_an_empty_input():
    arr = np.frombuffer(b"acgtNx", np.uint8)
    onehot, codes = encode_onehot_and_codes(arr, device="cpu")
    np.testing.assert_array_equal(codes, [0, 1, 2, 3, 4, 4])
    onehot, codes = encode_onehot_and_codes(b"", device="cpu")
    assert onehot.shape == (0, 5) and codes.shape == (0,)


def test_default_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        encode_onehot_and_codes(b"ACGT")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        encode_fasta(FastaEncodeConfig(fasta_path="none.fa", out_dir="none"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ReferenceGenome()


@pytest.mark.cuda
def test_card_encode_matches_host():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    raw = all_bytes(1) * 1000
    onehot, codes = encode_onehot_and_codes(raw, device="cuda")
    host_onehot, host_codes = encode_host(np.frombuffer(raw, np.uint8))
    np.testing.assert_array_equal(onehot, host_onehot)
    np.testing.assert_array_equal(codes, host_codes)


def _dataset_facts(path):
    """Every dataset of an HDF5 file: dtype, shape, chunks, filters, values."""
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                plist = obj.id.get_create_plist()
                filters = [plist.get_filter(i)[:3] for i in range(plist.get_nfilters())]
                out[name] = (obj.dtype, obj.shape, obj.chunks, filters, read_dataset(obj))
        f.visititems(visit)
    return out


@pytest.fixture(scope="module")
def encoded(tmp_path_factory):
    """``reference_genome.h5`` from both encoders on the bundled chr22."""
    out = tmp_path_factory.mktemp("enc")
    fasta = str(out / "chr22.fasta")
    shutil.copy(os.path.join(DATA, "chr22.fasta"), fasta)
    port = encode_fasta(FastaEncodeConfig(fasta_path=fasta, out_dir=str(out / "port"), cores=2,
                                          chromosomes=("chr22", "chrX")), device="cpu")
    jax = jax_encode_fasta(JaxFastaEncodeConfig(fasta_path=fasta, out_dir=str(out / "jax"),
                                                cores=2, chromosomes=("chr22", "chrX")))
    return port, jax, fasta


def test_encode_fasta_file_equal_to_jax(encoded):
    port, jax, _ = encoded
    got, want = _dataset_facts(port), _dataset_facts(jax)
    assert sorted(got) == sorted(want) == ["chr22/codes", "chr22/sequence"]
    for name in want:
        for i, what in enumerate(("dtype", "shape", "chunks", "filters")):
            assert got[name][i] == want[name][i], (name, what)
        np.testing.assert_array_equal(got[name][4], want[name][4], err_msg=name)
    assert got["chr22/sequence"][1] == (400_000, 5)
    assert got["chr22/sequence"][2] == (1 << 16, 5) and got["chr22/codes"][2] == (1 << 18,)
    assert not os.path.exists(os.path.join(os.path.dirname(port), "tmp_chrom_files"))
    with h5py.File(port, "r") as f:
        assert needs_blosc(f["chr22/sequence"])


def test_load_from_hdf5_matches_jax(encoded):
    port, jax, _ = encoded
    got, want = HDF5Handler.load_from_hdf5(port), JaxHDF5Handler.load_from_hdf5(jax)
    assert list(got) == list(want) == ["chr22"]
    np.testing.assert_array_equal(got["chr22"], want["chr22"])


def test_reference_genome_class_matches_jax(encoded, tmp_path):
    _, _, fasta = encoded
    rg = ReferenceGenome(fasta_file=fasta, output_dir=str(tmp_path), device="cpu")
    jrg = JaxReferenceGenome(fasta_file=fasta, output_dir=str(tmp_path / "j"), device=False)
    for seq in ("acgtn", "ACGTRYKMN"):
        np.testing.assert_array_equal(rg.encode_sequence(seq), jrg.encode_sequence(seq))
    assert rg.encode_spec == jrg.encode_spec
    os.makedirs(tmp_path / "j")
    rg.genome_files = [rg.load_chromosome("chr22")]
    jrg.genome_files = [jrg.load_chromosome("chr22")]
    np.testing.assert_array_equal(rg.get_sequence("chr22", 100, 5000),
                                  jrg.get_sequence("chr22", 100, 5000))


def test_from_fasta_matches_jax(encoded):
    _, jax_h5, fasta = encoded
    got = GenomeTensors.from_fasta(fasta)
    want = JaxGenomeTensors.from_fasta(fasta)
    assert got.chrom_names == want.chrom_names == ["chr22"]
    for f in ("codes_flat", "offsets", "lengths"):
        assert getattr(got, f).dtype == getattr(want, f).dtype
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    np.testing.assert_array_equal(got.codes_flat, GenomeTensors.from_h5(jax_h5).codes_flat)


def test_from_fasta_named_records(tmp_path):
    p = tmp_path / "m.fa"
    p.write_bytes(b">a\nACGTN\n>b\nacgtx\n>c\nGG\n")
    got = GenomeTensors.from_fasta(str(p), ["c", "a"])
    want = JaxGenomeTensors.from_fasta(str(p), ["c", "a"])
    assert got.chrom_names == want.chrom_names == ["c", "a"]
    np.testing.assert_array_equal(got.codes_flat, want.codes_flat)
    np.testing.assert_array_equal(got.offsets, [0, 128])


def test_cli_encodes_chr22(tmp_path, capsys):
    fasta = str(tmp_path / "chr22.fasta")
    shutil.copy(os.path.join(DATA, "chr22.fasta"), fasta)
    cli.main(["fasta_encoder", "--fasta", fasta, "--outdir", str(tmp_path / "o"),
              "--chromosomes", "chr22", "--cores", "2", "--device", "cpu"])
    with h5py.File(tmp_path / "o" / "reference_genome.h5", "r") as f:
        assert f["chr22/sequence"].shape == (400_000, 5)
        assert f["chr22/codes"].shape == (400_000,)
    with pytest.raises(SystemExit):
        cli.main(["fasta_encoder", "--fasta", str(tmp_path / "missing.fa"), "--outdir", "x"])
    assert "does not exist" in capsys.readouterr().err


def test_cli_faidx(tmp_path, capsys):
    fasta = str(tmp_path / "g.fa")
    with open(fasta, "wb") as f:
        f.write(b">a\nACGT\nAC\n>b\nGG\n>c x\nT\n")
    cli.main(["faidx", fasta])
    assert "3 sequences indexed" in capsys.readouterr().out
    assert open(fasta + ".fai").read().splitlines()[0] == "a\t6\t3\t4\t5"
