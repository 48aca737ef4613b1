"""Carry the JAX package's state across to this package's containers.

The data of this system are its genome and cohort tensors.  A caller
holding the JAX package's ``GenomeTensors``/``CohortTensors`` passes their
fields, as plain numpy arrays (``{field: getattr(obj, field)}``), to
:func:`genome_from_state`/:func:`cohort_from_state`; :func:`genome_state`
and :func:`cohort_state` give the same mapping back.  HaploFormer's weights
cross as a flax params tree of numpy arrays (``jax.device_get(params)``):
:func:`params_from_flax` makes the ``state_dict`` of the port's
``HaploFormer`` and :func:`params_to_flax` gives the tree back.  Nothing
here imports the JAX package or flax: only the arrays cross.  Every array
must already have its dtype and a consistent shape, so the state crosses
bit for bit.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from haplohyped_tpu_torch.data.cohort import CohortTensors
from haplohyped_tpu_torch.data.genome import GenomeTensors
from haplohyped_tpu_torch.models.haploformer import HaploFormer, HaploFormerConfig

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


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out |= _flatten(v, f"{prefix}{k}.")
        else:
            out[f"{prefix}{k}"] = v
    return out


def _config_of(flat: dict) -> tuple[HaploFormerConfig, int]:
    """The widths of the ``HaploFormer`` a flat params tree belongs to, and
    the window length its ``pos_embed`` was built for."""
    try:
        _, T, d = flat["pos_embed"].shape
        W, C, _ = flat["stem.conv1.kernel"].shape
    except (KeyError, AttributeError, ValueError) as e:
        raise ValueError(f"not a HaploFormer params tree: {e!r}") from None
    layers = len({k.split(".")[0] for k in flat if k.startswith("block")})
    heads, ratio = 1, 4
    if "block0.attn.query.kernel" in flat and "block0.mlp_in.kernel" in flat:
        heads = flat["block0.attn.query.kernel"].shape[1]
        ratio = flat["block0.mlp_in.kernel"].shape[1] // d
    cfg = HaploFormerConfig(num_channels=C, d_model=d, num_heads=heads, num_layers=layers,
                            mlp_ratio=ratio, conv_width=W)
    return cfg, T * cfg.pool


def params_from_flax(tree: Mapping) -> dict[str, torch.Tensor]:
    """The ``state_dict`` (CPU float32 tensors) of the port's ``HaploFormer``
    from a flax params tree (nested dicts of numpy arrays, as
    ``jax.device_get(params)`` gives it).  Every leaf must be a float32
    array whose name and shape the model of the tree's widths has; a
    missing or extra leaf raises."""
    flat = _flatten(tree)
    cfg, seq_length = _config_of(flat)
    want = HaploFormer(cfg, seq_length, device="cpu").state_dict()
    missing, extra = sorted(want.keys() - flat.keys()), sorted(flat.keys() - want.keys())
    if missing or extra:
        raise ValueError(f"params tree: missing leaves {missing}, extra leaves {extra}")
    out = {}
    for name, ref in want.items():
        a = flat[name]
        if not isinstance(a, np.ndarray) or a.dtype != np.float32:
            raise TypeError(f"{name} must be a numpy array of float32, got "
                            f"{getattr(a, 'dtype', type(a).__name__)}")
        if a.shape != tuple(ref.shape):
            raise ValueError(f"{name}: shape {a.shape}, expected {tuple(ref.shape)}")
        out[name] = torch.from_numpy(np.array(a))
    return out


def params_to_flax(model: HaploFormer) -> dict:
    """The flax params tree (nested dicts of float32 numpy arrays) of
    ``model``: the inverse of :func:`params_from_flax`."""
    tree: dict = {}
    for name, t in model.state_dict().items():
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t.detach().cpu().numpy().copy()
    return tree
