"""ms of one ``sampler.batch_at(step)`` to a synchronize (host clock), the
mean over the traced run's ``host_steps`` calls after the window."""


def read(rec):
    t = rec["spans"].get("batch_at_s")
    return sum(t) / len(t) * 1e3 if t else None
