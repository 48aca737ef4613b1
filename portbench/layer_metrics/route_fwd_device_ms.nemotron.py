"""Device ms a step of the Nemotron-H hybrid's routing in the forward: the
program's spans ``hh.moe.route`` (router, top-k selection, weights, the sort
of the held (token, slot) pairs and the gather of their rows) and
``hh.moe.combine`` (the weighted scatter back into the tokens), summed over
the traced run's ``recording()`` block of ``host_steps`` steps after the
window, over its steps.  None where the program records neither span (or
no device time for them)."""


def read(rec):
    program = rec["spans"].get("program") or {}
    parts = [program.get(k) for k in ("hh.moe.route", "hh.moe.combine")]
    parts = [ms for ms in parts if ms is not None]
    if not parts:
        return None
    return sum(parts) / rec["spans"]["program_steps"]
