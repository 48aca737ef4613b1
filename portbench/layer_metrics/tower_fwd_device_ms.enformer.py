"""Device ms a step of Enformer's stem and conv tower in the forward: the
program's spans ``hh.enformer.stem`` and ``hh.enformer.conv_tower``
(``core/profiling.py``, CUDA events at their edges), summed over the traced
run's ``recording()`` block of ``host_steps`` steps after the window, over
its steps.  None where the program records no such span."""

SPANS = ("hh.enformer.stem", "hh.enformer.conv_tower")


def read(rec):
    spans = rec["spans"].get("program") or {}
    ms = [spans.get(name) for name in SPANS]
    if any(v is None for v in ms):
        return None
    return sum(ms) / rec["spans"]["program_steps"]
