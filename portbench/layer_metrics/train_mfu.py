"""The window's share of the card's dense bf16 peak: the frozen FLOPs of a
train step (``portbench/counts.py``) times the window's steps, over the
window's seconds, over 989 TFLOP/s, in %."""

from portbench.counts import BF16_DENSE_FLOPS_PER_S


def read(rec):
    c = rec["counts"]
    if not c.get("steps"):
        return None
    return 100.0 * c["flops_per_step"] * c["steps"] / c["window_s"] / BF16_DENSE_FLOPS_PER_S
