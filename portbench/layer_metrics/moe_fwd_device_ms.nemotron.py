"""Device ms a step of the Nemotron-H hybrid's 5 MoE layers in the forward
(router, selection, sort and gather, the held experts' grouped products,
the weighted scatter, the shared expert): the program's spans
``hh.nemotron.moe`` (``core/profiling.py``, CUDA events at their edges, one
a layer), summed over the traced run's ``recording()`` block of
``host_steps`` steps after the window, over its steps.  None where the
program records no such span."""


def read(rec):
    ms = (rec["spans"].get("program") or {}).get("hh.nemotron.moe")
    if ms is None:
        return None
    return ms / rec["spans"]["program_steps"]
