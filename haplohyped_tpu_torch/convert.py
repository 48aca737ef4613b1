"""Carry the JAX package's state across to this package's containers.

The "weights" of this system are its genome and cohort tensors.  A caller
holding the JAX package's ``GenomeTensors``/``CohortTensors`` passes their
fields, as plain numpy arrays (``{field: getattr(obj, field)}``), to
:func:`genome_from_state`/:func:`cohort_from_state`; :func:`genome_state`
and :func:`cohort_state` give the same mapping back.  Nothing here imports
the JAX package: only the fields cross.  Every array must already have its
dtype and a consistent shape, so the state crosses bit for bit.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np

from haplohyped_tpu_torch.data.cohort import CohortTensors
from haplohyped_tpu_torch.data.genome import GenomeTensors

#: array fields and their dtypes
GENOME_ARRAYS = {"codes_flat": np.int8, "offsets": np.int32, "lengths": np.int32}
COHORT_ARRAYS = {
    "pos": np.int32, "ref_code": np.int8, "alt_code": np.int8,
    "phase1": np.int8, "phase2": np.int8, "counts": np.int32,
}


def _arrays(state: Mapping, fields: dict) -> dict[str, np.ndarray]:
    out = {}
    for name, dtype in fields.items():
        a = state[name]
        if not isinstance(a, np.ndarray) or a.dtype != dtype:
            raise TypeError(
                f"{name} must be a numpy array of {np.dtype(dtype)}, got "
                f"{getattr(a, 'dtype', type(a).__name__)}"
            )
        out[name] = np.ascontiguousarray(a)
    return out


def genome_from_state(state: Mapping) -> GenomeTensors:
    """``GenomeTensors`` from ``chrom_names``, ``codes_flat``, ``offsets``
    and ``lengths``."""
    names = list(state["chrom_names"])
    a = _arrays(state, GENOME_ARRAYS)
    C = len(names)
    if a["codes_flat"].ndim != 1 or a["offsets"].shape != (C,) or a["lengths"].shape != (C,):
        raise ValueError("genome state: codes_flat must be (G,), offsets and lengths (C,)")
    return GenomeTensors(chrom_names=names, **a)


def cohort_from_state(state: Mapping) -> CohortTensors:
    """``CohortTensors`` from ``donors``, ``chrom_names``, ``pos``,
    ``ref_code``, ``alt_code``, ``phase1``, ``phase2`` and ``counts``."""
    donors, names = list(state["donors"]), list(state["chrom_names"])
    a = _arrays(state, COHORT_ARRAYS)
    shape = a["pos"].shape
    if len(shape) != 3 or shape[:2] != (len(donors), len(names)):
        raise ValueError(f"cohort state: pos shape {shape} does not match (D, C, V)")
    for name in ("ref_code", "alt_code", "phase1", "phase2"):
        if a[name].shape != shape:
            raise ValueError(f"cohort state: {name} shape {a[name].shape} != pos {shape}")
    if a["counts"].shape != shape[:2]:
        raise ValueError(f"cohort state: counts shape {a['counts'].shape} != (D, C)")
    return CohortTensors(donors=donors, chrom_names=names, **a)


def genome_state(genome: GenomeTensors) -> dict:
    """The fields :func:`genome_from_state` takes."""
    return {"chrom_names": list(genome.chrom_names)} | {
        name: np.asarray(getattr(genome, name)) for name in GENOME_ARRAYS
    }


def cohort_state(cohort: CohortTensors) -> dict:
    """The fields :func:`cohort_from_state` takes."""
    return {"donors": list(cohort.donors), "chrom_names": list(cohort.chrom_names)} | {
        name: np.asarray(getattr(cohort, name)) for name in COHORT_ARRAYS
    }
