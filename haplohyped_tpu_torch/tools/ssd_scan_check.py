"""The comparison that holds the chunked scan's kernels (``ops/ssd_scan.py``)
to their plain version on the card.

``chip_smoke.py`` phases 21 and 23 run :func:`ssd_compare` at the Granite
and Nemotron-H hybrid cells' shapes, and the ``cuda``-marked tests too;
:func:`ssd_inputs` makes inputs of a Mamba-2 mixer's scales from a
generator.
"""

from __future__ import annotations

import math

import torch

from haplohyped_tpu_torch.ops.ssd_scan import ssd_scan, ssd_scan_plain

#: the cell's scan: 2 sequences of 8,192 tokens, 64 heads of 64, a state of
#: 128, chunks of 256
CELL_SHAPE = (2, 8192, 64, 64, 128)
CHUNK = 256
#: the Nemotron-H cell's scan: 4 sequences of 8,192 tokens, 64 heads of 64,
#: a state of 128 in 8 groups of B and C, chunks of 128
NEMOTRON_SHAPE = (4, 8192, 64, 64, 128, 8)
NEMOTRON_CHUNK = 128
#: the largest gap of the kernels' output and of each gradient from the
#: plain version's, as a share of the plain version's norm: the kernels round
#: the mask, the entering states' operand copy and the products' outputs to
#: bf16 (2^-9 of each value) where the plain version keeps float32, so their
#: results differ by a few tenths of a percent of the norm; a wrong index or
#: a lost term moves a share of order 1
TOLERANCE = 0.02
NAMES = ("y", "x", "dt", "A", "B", "C", "D")


def ssd_inputs(shape: tuple, gen: torch.Generator, device) -> dict:
    """``x``, ``B``, ``C`` bf16 (``N(0, 0.5^2)``, a SiLU's scale), ``dt``
    log-uniform in ``[1e-3, 1e-1]`` (Mamba-2's range), ``A`` in ``[-16,
    -1]``, ``D`` ``1 + N(0, 0.1^2)`` and an output gradient ``dy``, from
    ``gen`` on ``device``.  ``shape`` is ``(b, T, H, P, N)`` (``B`` and
    ``C`` ``(b, T, N)``: one group) or ``(b, T, H, P, N, G)`` (``(b, T, G,
    N)``)."""
    b, T, H, P, N = shape[:5]
    bc = (b, T, N) if len(shape) == 5 else (b, T, shape[5], N)

    def rnd(*s):
        return torch.randn(s, generator=gen, device=device)

    def uni(*s):
        return torch.rand(s, generator=gen, device=device)

    lo, hi = math.log(1e-3), math.log(1e-1)
    return {"x": (0.5 * rnd(b, T, H, P)).to(torch.bfloat16),
            "dt": torch.exp(lo + (hi - lo) * uni(b, T, H)),
            "A": -(1 + 15 * uni(H)),
            "B": (0.5 * rnd(*bc)).to(torch.bfloat16),
            "C": (0.5 * rnd(*bc)).to(torch.bfloat16),
            "D": 1 + 0.1 * rnd(H),
            "dy": rnd(b, T, H, P).to(torch.bfloat16)}


def ssd_run(fn, inp: dict, chunk: int = CHUNK, wide=None) -> dict:
    """``fn`` forward and backward on copies of ``inp`` (widened to ``wide``
    if given): the output and the six gradients."""
    cast = (lambda t: t.to(wide)) if wide is not None else (lambda t: t)
    args = [cast(inp[k]).detach().requires_grad_() for k in ("x", "dt", "A", "B", "C", "D")]
    y = fn(*args, chunk)
    grads = torch.autograd.grad(y, args, cast(inp["dy"]))
    return dict(zip(NAMES, (y.detach(), *grads)))


def ssd_compare(inp: dict, chunk: int = CHUNK) -> dict:
    """The kernels against the plain version in float32 on the same inputs:
    each result's ``||kernel - plain|| / ||plain||``, checked against
    :data:`TOLERANCE`; and two runs of the kernels bit-equal but for the
    gradients summed by atomics (``dt``, ``A``, ``D``)."""
    got = ssd_run(ssd_scan, inp, chunk)
    want = ssd_run(ssd_scan_plain, inp, chunk, torch.float32)
    again = ssd_run(ssd_scan, inp, chunk)
    gaps = {k: float((got[k].float() - want[k]).norm() / want[k].norm()) for k in NAMES}
    for k, v in gaps.items():
        if not v <= TOLERANCE:
            raise RuntimeError(f"check failed: ssd_scan {k} is {v:.3g} of the plain "
                               f"version's norm away, over {TOLERANCE}")
    for k in ("y", "x", "B", "C"):
        if not torch.equal(got[k], again[k]):
            raise RuntimeError(f"check failed: two runs of ssd_scan differ in {k}")
    return gaps

