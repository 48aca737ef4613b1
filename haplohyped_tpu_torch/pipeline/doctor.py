"""Environment check: what the port needs at run time, each reported ✓ or ✗.

    python -m haplohyped_tpu_torch.pipeline.doctor

The native VCF/FASTA reader builds and loads; the Blosc HDF5 filter; a CUDA
card (its name and power limit); the ``csrc/`` kernels build with ``nvcc``
for ``sm_90a``; h5py and HDF5; and a decode sanity check.  Any ✗ exits 1.
"""

from __future__ import annotations

import argparse

#: the checks, in the order they run and print
CHECKS = ("native hostio", "blosc filter", "cuda card", "nvcc kernels", "h5py/HDF5",
          "decode sanity")


def _native():
    from haplohyped_tpu_torch.ops import _build

    lib = _build.load_hostio()
    return True, f"{lib._name} loaded"


def _blosc():
    from haplohyped_tpu_torch.storage.blosc import blosc_available

    ok = blosc_available()
    return ok, ("HDF5 filter 32001 registered" if ok
                else "h5py or libblosc.so.1 missing: datasets fall back to gzip")


def _card():
    import torch

    from haplohyped_tpu_torch.core.timing import card_line

    if not torch.cuda.is_available():
        return False, "torch.cuda.is_available() is False"
    return True, f"{torch.cuda.device_count()} device(s): {card_line()}"


def _nvcc():
    from haplohyped_tpu_torch.ops import _build

    names = _build.kernel_names()
    for name in names:
        _build.load_kernel(name)
    return True, f"{', '.join(names)} built for sm_90a"


def _h5py():
    import h5py

    return True, f"h5py {h5py.__version__} / HDF5 {h5py.version.hdf5_version}"


def _decode():
    import numpy as np

    from haplohyped_tpu_torch.hostio.frame_format import pack_frame
    from haplohyped_tpu_torch.ops.vcf_decode import decode_frames_numpy

    d = decode_frames_numpy(np.stack([pack_frame(b"chr1", b"100", b"A", b"G", b"1|0")]))
    return bool(d["snp_mask"][0] and d["phase1"][0] == 1), "one framed record decodes (numpy)"


def run_checks() -> list[tuple[str, bool, str]]:
    """``(name, ok, detail)`` of every check; a check that raises is ✗ with
    the error as its detail, and the rest still run."""
    checks = []
    for name, fn in zip(CHECKS, (_native, _blosc, _card, _nvcc, _h5py, _decode)):
        try:
            ok, detail = fn()
        except Exception as exc:  # noqa: BLE001 - each check reports, the next runs
            first = str(exc).splitlines()[0] if str(exc) else ""
            ok, detail = False, f"{type(exc).__name__}: {first}"
        checks.append((name, ok, detail))
    return checks


def main(argv=None) -> None:
    """Check the runtime environment (native libraries, filter, card, kernels)."""
    argparse.ArgumentParser(
        prog="python -m haplohyped_tpu_torch.pipeline.doctor",
        description="Check the runtime environment of haplohyped_tpu_torch.",
    ).parse_args(argv)
    failed = 0
    for name, ok, detail in run_checks():
        print(f"  {'✓' if ok else '✗'} {name:16s} {detail}")
        failed += not ok
    if failed:
        raise SystemExit(1)
    print("all checks passed")


if __name__ == "__main__":
    main()
