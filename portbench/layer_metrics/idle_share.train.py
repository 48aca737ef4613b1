"""% of the untraced window in which no device op ran: the device-busy time
of a step under the profiler right after set-up, times the window's steps,
against the window's seconds (``portbench/trace.py``)."""

from portbench.trace import window_idle_percent


def read(rec):
    return window_idle_percent(rec, "steps")
