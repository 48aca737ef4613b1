"""% of its roofline the window kernel reaches on Enformer's windows: the
least bytes a batch's encode moves (``portbench/counts.py::link_bytes`` for
the batch's B windows of L bp, at the mean applied SNVs of the profiled
steps' batches) over 3.35 TB/s, over the kernel's mean device time a launch
in the traced profile (its ops named ``window_kernel``)."""

from portbench.counts import HBM_BYTES_PER_S


def read(rec):
    prof, nbytes = rec.get("profile"), rec["counts"].get("window_bytes")
    if not prof or not nbytes:
        return None
    us = [b - a for name, a, b in prof["device"]
          if "window_kernel" in name and "lab" not in name]
    if not us:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / (sum(us) / len(us) * 1e-6)
