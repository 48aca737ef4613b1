"""The model's starting weights, made by the benchmark on the device from the
seed and handed alike to the program and to the reference.

One ``torch.randn`` call of every leaf's elements together, from a generator
on the device, cut and scaled per leaf by its kind: kernels ``N(0, 1 /
fan_in)`` (flax's ``lecun_normal`` scale, untruncated), biases ``N(0,
0.01^2)``, layer-norm scales ``1 + N(0, 0.01^2)``, the position embedding
``N(0, 0.02^2)``.  Biases and scales are not left at 0 and 1, so the check
sees every leaf's arithmetic.
"""

from __future__ import annotations

import math

import torch

_SCALE = {"bias": 0.01, "scale": 0.01, "embed": 0.02}


def make(specs: list, seed: int, device) -> dict[str, torch.Tensor]:
    """``{name: float32 tensor}`` for ``reference.haploformer.param_specs``."""
    g = torch.Generator(device=device).manual_seed(seed)
    sizes = [math.prod(shape) for _, shape, _, _ in specs]
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out = {}
    for (name, shape, kind, fan_in), part in zip(specs, flat.split(sizes)):
        if kind == "kernel":
            part = part / math.sqrt(fan_in)
        else:
            part = part * _SCALE[kind] + (1.0 if kind == "scale" else 0.0)
        out[name] = part.view(shape)
    return out
