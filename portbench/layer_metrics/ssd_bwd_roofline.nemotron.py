"""% of its roofline one call of the Nemotron-H scan's backward (8 groups of
``B`` and ``C``, chunks of 128) reaches: the call's bound, the larger of its
least bytes over 3.35 TB/s and its products' FLOPs over 989 TFLOP/s
(``portbench/counts_nemotron.py::ssd_bytes``, ``ssd_flops``), over its
device time, the program's spans ``hh.ssd_scan.backward`` (CUDA events at
their edges: the kernels and the ``torch.bmm`` products alike) summed over
the traced run's ``recording()`` block of ``host_steps`` steps after the
window, over the scan's backward calls in that block. None where the program
records no such span."""

from portbench.counts import BF16_DENSE_FLOPS_PER_S, HBM_BYTES_PER_S


def read(rec):
    spans, c = rec["spans"], rec["counts"]
    ms = (spans.get("program") or {}).get("hh.ssd_scan.backward")
    calls = c.get("ssd_bwd_calls_a_step", 0) * spans.get("program_steps", 0)
    if ms is None or not calls:
        return None
    bound_s = max(c["ssd_bwd_bytes"] / HBM_BYTES_PER_S,
                  c["ssd_bwd_flops"] / BF16_DENSE_FLOPS_PER_S)
    return 100.0 * bound_s / (ms / calls * 1e-3)
