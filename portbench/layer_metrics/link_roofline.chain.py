"""% of its roofline a chain link reaches: the least bytes a link moves
(``portbench/counts.py::link_bytes``) over 3.35 TB/s, over the link's device
ms (``link_ms.chain``)."""

from portbench.counts import HBM_BYTES_PER_S


def read(rec):
    ev = rec["events"].get("replays_ms")
    if not ev:
        return None
    return 100.0 * rec["counts"]["link_bytes"] / HBM_BYTES_PER_S * 1e3 / (ev[0] / ev[1])
