"""The port's spans, and ``torch.profiler`` traces.

Usage::

    from haplohyped_tpu_torch.core.profiling import annotate, recording, trace

    with recording() as rec:               # spans in memory: host clock, CUDA events
        state, metrics = fused(state, 0)
    rec.totals()["hh.train.forward"]       # calls, host and device ms, self times

    with trace("/tmp/hh_trace"):           # a Chrome trace of CPU and CUDA activity,
        state, metrics = fused(state, 1)   # the spans among its host ops

:func:`annotate` is the span.  The package opens one at each boundary of its
main path (``hh.train.fused_step``, ``hh.sampler.batch``, ``hh.train.step``
and its ``forward``, ``backward`` and ``optimizer``, ``hh.sampler.chain``,
the set-up's parts; the README lists them).  A span is in one of three
states:

- **off**, with no recording open and no profiler running: it returns one
  shared no-op, after one check of a module flag and one of the profiler's;
- **a profiler is running**: it enters ``torch.profiler.record_function``,
  so its interval sits in the trace on the device ops' clock, and each
  kernel is tied to the host op inside it that launched it;
- **a recording is open** (:func:`recording`): it keeps its name, attributes,
  parent (the innermost span open on its thread), host start and end
  (``time.perf_counter_ns``) and, on a CUDA card, a pair of timing events
  at its edges, read only when the record is read.

Both of the last two may hold at once.  A span opened while the current
CUDA stream captures a graph does nothing: a replayed graph runs no Python,
so a graph's work is one span around its replay.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

#: the open recording, or None: every span of the process goes into it
_recording: "Record | None" = None
_local = threading.local()


class _Off:
    """The span when nothing listens: enters and leaves, doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> list:
    """This thread's open spans, innermost last."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class Span:
    """One region of a :func:`recording` (and of a running profiler's trace)."""

    __slots__ = ("name", "attrs", "parent", "start_ns", "end_ns", "events", "_rec", "_rf")

    def __init__(self, name: str, attrs: dict, rec: "Record | None"):
        self.name, self.attrs, self._rec = name, attrs, rec
        self.parent = self.start_ns = self.end_ns = self.events = self._rf = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        rec = self._rec
        if rec is not None:
            stack = _stack()
            if stack and stack[-1]._rec is rec:
                self.parent = stack[-1]
            stack.append(self)
            rec.spans.append(self)
            if rec.cuda:
                self.events = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
                self.events[0].record()
            self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            self.end_ns = time.perf_counter_ns()
            if self.events is not None:
                self.events[1].record()
            _stack().pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def annotate(name: str, **attrs):
    """The span ``name`` with attributes ``attrs``, as a context manager:
    the shared no-op when nothing listens or the stream is capturing."""
    rec = _recording
    if rec is None and not _autograd_profiler._is_profiler_enabled:
        return _OFF
    if torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing():
        return _OFF
    return Span(name, attrs, rec)


class Record:
    """The spans of one :func:`recording`, in the order they opened."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.spans: list[Span] = []

    def rows(self) -> list[dict]:
        """Each closed span: ``name``, ``attrs``, ``parent`` (its row's index,
        None for a root), ``host_ms``, ``device_ms`` (the stream's time between
        its two events; None without CUDA) and the self times, each less what
        its children cover.  Synchronizes the card first."""
        spans = [s for s in self.spans if s.end_ns is not None]
        if self.cuda and spans:
            torch.cuda.synchronize()
        index = {id(s): i for i, s in enumerate(spans)}
        rows = []
        for s in spans:
            host = (s.end_ns - s.start_ns) / 1e6
            dev = s.events[0].elapsed_time(s.events[1]) if s.events is not None else None
            rows.append({"name": s.name, "attrs": dict(s.attrs), "parent": index.get(id(s.parent)),
                         "host_ms": host, "device_ms": dev,
                         "self_host_ms": host, "self_device_ms": dev})
        for r in rows:
            if r["parent"] is not None:
                p = rows[r["parent"]]
                p["self_host_ms"] -= r["host_ms"]
                if r["device_ms"] is not None:
                    p["self_device_ms"] -= r["device_ms"]
        return rows

    def totals(self) -> dict[str, dict]:
        """Per span name: ``calls`` and the sums of each time of :meth:`rows`."""
        out: dict[str, dict] = {}
        for r in self.rows():
            t = out.setdefault(r["name"], {"calls": 0, "host_ms": 0.0, "self_host_ms": 0.0,
                                           "device_ms": None, "self_device_ms": None})
            t["calls"] += 1
            for k in ("host_ms", "self_host_ms", "device_ms", "self_device_ms"):
                if r[k] is not None:
                    t[k] = (t[k] or 0.0) + r[k]
        return out


@contextlib.contextmanager
def recording():
    """Record every span the process opens inside the block; yields the
    :class:`Record`.  Where a card is present each span is timed on the
    current CUDA stream too.  The record is read after the block, when its
    spans have closed."""
    global _recording
    rec = Record(torch.cuda.is_available())
    prev, _recording = _recording, rec
    try:
        yield rec
    finally:
        _recording = prev


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Trace the block with ``torch.profiler`` (CPU, and CUDA where a card is
    present) and write ``{log_dir}/trace.json`` (Chrome trace format); a
    no-op when ``log_dir`` is falsy.  Yields the profiler (or None).  The
    spans show as host ops of the trace."""
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
