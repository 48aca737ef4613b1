"""Device ms a step of Enformer's transformer blocks in the forward: the
program's span ``hh.enformer.transformer`` (``core/profiling.py``, CUDA
events at its edges) over the traced run's ``recording()`` block of
``host_steps`` steps after the window, over its steps.  None where the
program records no such span."""


def read(rec):
    ms = (rec["spans"].get("program") or {}).get("hh.enformer.transformer")
    if ms is None:
        return None
    return ms / rec["spans"]["program_steps"]
