"""The traffic generators: one module a ``loop`` kind, named by a mix file."""
