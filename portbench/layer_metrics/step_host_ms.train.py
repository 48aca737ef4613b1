"""ms of host time to enqueue one ``make_train_step()`` call after a
synchronize (no synchronize inside), the mean over the traced run's
``host_steps`` calls: what a CUDA graph over the step would take away."""


def read(rec):
    t = rec["spans"].get("step_enqueue_s")
    return sum(t) / len(t) * 1e3 if t else None
