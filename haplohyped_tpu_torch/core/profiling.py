"""Profiling hooks: ``torch.profiler`` traces and named regions.

Usage::

    from haplohyped_tpu_torch.core.profiling import annotate, trace

    with trace("/tmp/hh_trace"):           # a Chrome trace of CPU and CUDA activity
        with annotate("sample"):
            batch = sampler.sample()
"""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Trace the block with ``torch.profiler`` (CPU, and CUDA where a card is
    present) and write ``{log_dir}/trace.json`` (Chrome trace format); a
    no-op when ``log_dir`` is falsy.  Yields the profiler (or None)."""
    if not log_dir:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named region visible in profiler timelines."""
    with torch.profiler.record_function(name):
        yield
