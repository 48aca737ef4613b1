"""The PyTorch port's public surface against the JAX package's.

Every name in the ``__all__`` of ``haplohyped_tpu/{ops,pipeline,storage}``
imports from the same port package; the JAX lists are read with ``ast``, so
the port's own import stays free of JAX.  The constants the port copies
equal the JAX package's, and ``HDF5Handler.merge_h5_files`` takes JAX's
``cores`` argument.
"""

import ast
import importlib
import pathlib

import h5py
import numpy as np
import pytest

from haplohyped_tpu.core import constants as jax_constants
from haplohyped_tpu_torch.core import constants
from haplohyped_tpu_torch.pipeline import HDF5Handler

ROOT = pathlib.Path(__file__).resolve().parents[1]


def jax_all(package: str) -> list[str]:
    """The ``__all__`` list of ``haplohyped_tpu/<package>/__init__.py``."""
    tree = ast.parse((ROOT / "haplohyped_tpu" / package / "__init__.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"haplohyped_tpu/{package} has no __all__")


@pytest.mark.parametrize("package", ["ops", "pipeline", "storage"])
def test_every_jax_export_imports_from_the_port(package):
    names = jax_all(package)
    assert len(names) >= 4
    port = importlib.import_module(f"haplohyped_tpu_torch.{package}")
    assert sorted(port.__all__) == sorted(names)
    for name in names:
        assert callable(getattr(port, name)), name


@pytest.mark.parametrize("name", ["CODE_TO_ASCII", "BLOSC_COMPCODE_NAMES"])
def test_constants_equal_jax(name):
    got, want = getattr(constants, name), getattr(jax_constants, name)
    assert type(got) is type(want)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert bytes(got[constants.BASE_LUT[np.frombuffer(b"acgtnX", np.uint8)]]) == b"ACGTNN"
    else:
        assert got == want


def test_merge_h5_files_takes_cores(tmp_path):
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    for chrom, n in (("chr1", 7), ("chr2", 3)):
        with h5py.File(tmp / f"{chrom}.h5", "w") as f:
            f["sequence"] = np.arange(n * 5, dtype=np.int8).reshape(n, 5)
    final = str(tmp_path / "reference_genome.h5")
    HDF5Handler.merge_h5_files(str(tmp), final, cores=2)
    HDF5Handler.merge_h5_files(str(tmp), final)  # again: datasets replaced, not doubled
    got = HDF5Handler.load_from_hdf5(final)
    assert sorted(got) == ["chr1", "chr2"]
    np.testing.assert_array_equal(got["chr2"], np.arange(15, dtype=np.int8).reshape(3, 5))
