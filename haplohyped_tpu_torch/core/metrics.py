"""Metrics registry + phase timing.

The port's own copy of ``haplohyped_tpu.core.metrics``: thread-safe
counters (records, SNPs, bytes) and phase timers (``parse``,
``h5_write``) that the converter reports through.  Host clocks only; a
timer around device work measures it only where that work ends in a
synchronisation (the converter's decode copies its output back to the host).
"""

from __future__ import annotations

import contextlib
import json
import logging
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field

logger = logging.getLogger(__name__)


@dataclass
class Metrics:
    """Thread-safe counters + phase timings."""

    counters: dict[str, float] = field(default_factory=lambda: defaultdict(float))
    timings: dict[str, float] = field(default_factory=lambda: defaultdict(float))
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def count(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] += value

    @contextlib.contextmanager
    def timer(self, phase: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.timings[phase] += dt

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self.counters),
                "timings": {k: round(v, 6) for k, v in self.timings.items()},
            }

    def log_summary(self, prefix: str = "metrics") -> None:
        logger.info("%s %s", prefix, json.dumps(self.snapshot(), sort_keys=True))


#: process-global default registry
GLOBAL_METRICS = Metrics()
