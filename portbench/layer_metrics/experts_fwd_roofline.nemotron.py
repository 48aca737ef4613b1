"""% of its roofline one forward call of the held experts' products
reaches: the call's bound, the larger of its least bytes over 3.35 TB/s and
its FLOPs over 989 TFLOP/s (``portbench/counts_nemotron.py::experts_bytes``,
``experts_flops``, at the block's mean held slots a call, which the loop
reads from the program's ``moe.held_slots``), over its device time, the
program's spans ``hh.moe.experts`` (CUDA events at their edges: the
weights' casts, the two grouped products and ReLU²) summed over the traced
run's ``recording()`` block of ``host_steps`` steps after the window, over
the span's calls in that block (a MoE call with no held slot runs none).
None where the program records no such span."""

from portbench.counts import BF16_DENSE_FLOPS_PER_S, HBM_BYTES_PER_S


def read(rec):
    spans, c = rec["spans"], rec["counts"]
    ms = (spans.get("program") or {}).get("hh.moe.experts")
    calls = c.get("experts_calls", 0)
    if ms is None or not calls:
        return None
    bound_s = max(c["experts_fwd_bytes"] / HBM_BYTES_PER_S,
                  c["experts_fwd_flops"] / BF16_DENSE_FLOPS_PER_S)
    return 100.0 * bound_s / (ms / calls * 1e-3)
