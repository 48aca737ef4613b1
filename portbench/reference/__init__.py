"""The plain reference the benchmark judges the program by.

Plain PyTorch and NumPy only: nothing here imports ``jax``, the JAX package or
``haplohyped_tpu_torch``, and nothing takes a tensor the program derived.
"""
