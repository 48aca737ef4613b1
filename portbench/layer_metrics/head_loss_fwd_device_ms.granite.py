"""Device ms a step of the Granite hybrid's final norm, tied head and
chunked cross-entropy in the forward (which also takes the head's
gradients, so no logits are kept): the program's span
``hh.granite.head_loss`` over the traced run's ``recording()`` block of
``host_steps`` steps after the window, over its steps.  None where the
program records no such span."""


def read(rec):
    ms = (rec["spans"].get("program") or {}).get("hh.granite.head_loss")
    if ms is None:
        return None
    return ms / rec["spans"]["program_steps"]
