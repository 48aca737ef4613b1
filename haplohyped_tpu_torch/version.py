"""The port's version: the JAX package's, whose outputs it reproduces."""

__version__ = "0.4.0"
