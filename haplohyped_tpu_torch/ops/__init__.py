"""ops layer of haplohyped_tpu_torch."""
