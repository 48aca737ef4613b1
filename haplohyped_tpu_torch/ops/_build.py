"""Build the port's native code at first use and load it with ``ctypes``.

Each CUDA source ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface.  The host code
the port shares with the JAX package is compiled from the repository's
``cpp/`` with the host compilers: the VCF framer (``hostio.cpp`` +
``bcf.cpp``, with ``g++`` and the flags of ``cpp/Makefile``) and the blosc
HDF5 filter.  Outputs go to the git-ignored ``haplohyped_tpu_torch/_build/``,
named by a hash of the sources, their headers and the command, so a changed
source rebuilds and an unchanged one is reused.  A failed build raises;
nothing here falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import uuid
from pathlib import Path
from typing import NamedTuple

from haplohyped_tpu_torch.core.profiling import annotate

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
CPP_DIR = PACKAGE_DIR.parent / "cpp"

#: the native VCF framer: sources and the header they include
HOSTIO_SOURCES = (CPP_DIR / "hostio.cpp", CPP_DIR / "bcf.cpp")
HOSTIO_DEPS = (CPP_DIR / "hostio_common.h",)
#: ``cpp/Makefile``'s CXXFLAGS (warnings aside) and link line
HOSTIO_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # print registers, shared memory and spills of every kernel
    "-Xptxas", "-v",
)


class _Job(NamedTuple):
    target: Path
    tmp: Path
    proc: subprocess.Popen


def _target(name: str, files, argv: list[str]) -> Path:
    h = hashlib.sha256("\0".join(argv).encode())
    for f in files:
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(
    name: str, sources, compiler: str, flags, libs=(), deps=()
) -> tuple[Path, _Job | None]:
    """Start compiling ``sources`` into one shared library.  Returns its path
    and the job, or ``None`` for the job when the library is already built.
    ``deps`` are headers the sources include: they enter the hash only."""
    target = _target(name, [*sources, *deps], [compiler, *flags, *libs])
    if target.exists():
        return target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp")
    argv = [compiler, *flags, "-o", str(tmp), *map(str, sources), *libs]
    proc = subprocess.Popen(
        argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return target, _Job(target, tmp, proc)


def _finish(job: _Job) -> str:
    out, _ = job.proc.communicate()
    if job.proc.returncode != 0:
        job.tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"build of {job.target.name} failed "
            f"(exit {job.proc.returncode}): {' '.join(job.proc.args)}\n{out}"
        )
    os.replace(job.tmp, job.target)  # atomic: concurrent builds of one source agree
    return out


def build_shared_library(
    name: str, sources, compiler: str, flags, libs=(), deps=()
) -> Path:
    """Compile ``sources`` once into ``BUILD_DIR`` and return the library."""
    target, job = _start(name, sources, compiler, flags, libs, deps)
    if job is not None:
        _finish(job)
    return target


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = shutil.which("nvcc") or (
        os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    )
    if not nvcc or not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (neither on PATH nor under CUDA_HOME); the CUDA "
            "kernels of haplohyped_tpu_torch cannot be built"
        )
    return nvcc


def kernel_names() -> list[str]:
    """Every CUDA source of the package, by name."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _kernel_sources(name: str) -> list[Path]:
    return [CSRC_DIR / f"{name}.cu"]


def _kernel_deps() -> list[Path]:
    """The headers under ``csrc/``: every kernel's build hashes them, so an
    edited header rebuilds the kernels that include it."""
    return sorted(CSRC_DIR.glob("*.cuh"))


@functools.cache
def _has_libdeflate() -> bool:
    """Whether the host compiler finds libdeflate's header and library
    (``cpp/Makefile`` then builds the framer with ``-DHH_USE_LIBDEFLATE``)."""
    probe = subprocess.run(
        ["g++", "-x", "c++", "-", "-ldeflate", "-o", os.devnull],
        input="#include <libdeflate.h>\nint main() { return 0; }\n",
        capture_output=True, text=True,
    )
    return probe.returncode == 0


def _hostio_command() -> tuple[tuple[str, ...], tuple[str, ...]]:
    """``(flags, libs)`` of the framer's ``g++`` command, as in ``cpp/Makefile``."""
    if _has_libdeflate():
        return (*HOSTIO_FLAGS, "-DHH_USE_LIBDEFLATE"), ("-lz", "-ldeflate")
    return HOSTIO_FLAGS, ("-lz",)


def _start_hostio() -> tuple[Path, _Job | None]:
    flags, libs = _hostio_command()
    return _start("hh_hostio", HOSTIO_SOURCES, "g++", flags, libs, HOSTIO_DEPS)


def build_kernels() -> dict[str, str]:
    """Build every kernel source (one ``nvcc`` each) and the native framer
    (one ``g++``), all started together.  Returns each build's compiler
    output (empty where the build was cached); the framer's key is
    ``"hh_hostio"``."""
    nvcc = _nvcc()
    jobs = {
        n: _start(n, _kernel_sources(n), nvcc, NVCC_FLAGS, deps=_kernel_deps())[1]
        for n in kernel_names()
    }
    jobs["hh_hostio"] = _start_hostio()[1]
    return {n: (_finish(j) if j is not None else "") for n, j in jobs.items()}


@functools.cache
def load_hostio() -> ctypes.CDLL:
    """The native VCF framer built from ``cpp/``, building it if needed."""
    target, job = _start_hostio()
    if job is not None:
        _finish(job)
    return ctypes.CDLL(str(target))


@functools.cache
def load_kernel(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if needed.  The
    span ``hh.build.load_kernel`` covers the first call of each name only."""
    with annotate("hh.build.load_kernel", kernel=name):
        sources = _kernel_sources(name)
        if not sources[0].exists():
            raise FileNotFoundError(sources[0])
        path = build_shared_library(name, sources, _nvcc(), NVCC_FLAGS, deps=_kernel_deps())
        return ctypes.CDLL(str(path))
