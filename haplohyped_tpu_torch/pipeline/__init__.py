"""Pipelines: the VCF -> cohort-HDF5 converter."""
