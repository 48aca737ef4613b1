"""The benchmark of ``haplohyped_tpu_torch`` on NVIDIA cards (see README.md)."""
