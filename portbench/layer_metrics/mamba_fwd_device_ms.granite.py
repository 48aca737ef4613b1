"""Device ms a step of the Granite hybrid's Mamba-2 mixers in the forward:
the program's spans ``hh.granite.mamba`` (``core/profiling.py``, CUDA
events at their edges, one a mixer), summed over the traced run's
``recording()`` block of ``host_steps`` steps after the window, over its
steps.  None where the program records no such span."""


def read(rec):
    ms = (rec["spans"].get("program") or {}).get("hh.granite.mamba")
    if ms is None:
        return None
    return ms / rec["spans"]["program_steps"]
