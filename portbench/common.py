"""What every loop does alike: the set-up split, the program's sampler on the
benchmark's state, the clock, and the program's release before the
reference runs."""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from portbench.state import State


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Split:
    """Seconds of each named part of the set-up, logged on one line."""

    def __init__(self):
        self.parts: dict[str, float] = {}

    def __call__(self, name: str, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        self.parts[name] = self.parts.get(name, 0.0) + time.perf_counter() - t0
        return out

    def line(self) -> str:
        return "set-up split (s): " + ", ".join(f"{k} {v:.4f}" for k, v in self.parts.items())


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_kernels(device: torch.device) -> None:
    """Build (first run in a checkout) or load the CUDA kernels the sampler
    launches, so the split shows the build apart from the rest."""
    if device.type == "cuda":
        from haplohyped_tpu_torch.ops import _build

        for name in ("draw_kernel", "window_kernel"):
            _build.load_kernel(name)


def sampler(state: State, cfg: dict, seed: int, device: torch.device):
    """The program's ``DeviceHaplotypeSampler`` over the state (its index
    built inside), ``PRNGKey(seed)`` its key."""
    from haplohyped_tpu_torch.core.config import SamplerConfig
    from haplohyped_tpu_torch.data.cohort import CohortTensors
    from haplohyped_tpu_torch.data.genome import GenomeTensors
    from haplohyped_tpu_torch.data.sampler import DeviceHaplotypeSampler

    genome = GenomeTensors(state.names, state.codes, state.offsets.astype(np.int32),
                           state.lengths.astype(np.int32))
    donors = [f"donor{d:03d}" for d in range(state.pos.shape[0])]
    cohort = CohortTensors(donors, list(state.names), state.pos, state.ref, state.alt,
                           state.p1, state.p2, state.counts)
    s = cfg["sampler"]
    config = SamplerConfig(seq_length=s["seq_length"], batch_size=s["batch_size"], seed=seed,
                           max_variants_per_window=s["max_variants_per_window"])
    out = DeviceHaplotypeSampler(genome, cohort, state.regions, config, device=device)
    sync(device)
    return out


class Marks:
    """Marks after each unit of work: CUDA events on a card (no synchronize
    between them), the host clock on the CPU.  ``gaps_ms()`` reads them once
    the work has finished."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def mark(self) -> None:
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def gaps_ms(self) -> list[float]:
        m = self.marks
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]


def memory_peak(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def release(device: torch.device) -> None:
    """Return the program's freed memory to the card before the reference."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def percentile(values: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))
