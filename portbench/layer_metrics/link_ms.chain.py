"""Device ms of one chain link: CUDA events around the traced run's
``replay_calls`` graph replays (no fetch between them), over their links."""


def read(rec):
    ev = rec["events"].get("replays_ms")
    return ev[0] / ev[1] if ev else None
