"""The whole chain's share of the card's peak, beside the kernels' roofline
``link_roofline.chain``: the least bytes of every link the window ran
(``portbench/counts.py::link_bytes``), over the window's seconds (host
clock, the fetch and launch between calls included), over the 3.35 TB/s
memory-bandwidth peak, in %.  The chain moves bytes and computes next to no
FLOPs, so its peak is the bandwidth; a later change that takes a kernel off
the link leaves ``link_roofline.chain`` silent, and this share still bounds
its claim."""

from portbench.counts import HBM_BYTES_PER_S


def read(rec):
    c = rec["counts"]
    if not c.get("links"):
        return None
    return 100.0 * c["link_bytes"] * c["links"] / c["window_s"] / HBM_BYTES_PER_S
