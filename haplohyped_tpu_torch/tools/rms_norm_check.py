"""The comparison that holds the norms' kernels (``ops/rms_norm.py``) to
their plain version on the card.

``chip_smoke.py`` phases 22 and 23 and the ``cuda``-marked tests run
:func:`rms_compare` at the Granite and Nemotron-H hybrid cells' shapes; the
CPU tests use :func:`rms_inputs` and :func:`rms_run` on the plain version.
"""

from __future__ import annotations

import torch

from haplohyped_tpu_torch.ops.rms_norm import rms_norm, rms_norm_plain
from haplohyped_tpu_torch.tools.batchnorm_gelu_check import bf16_steps_apart

#: the Granite cell's norms: 2 sequences of 8,192 tokens a step, the hidden
#: width (the plain norms), the mixer's width (the gated ones) and the width
#: of ``in_proj``'s output, whose first ``MIXER`` columns are the gate ``z``
ROWS, HIDDEN, MIXER, IN_PROJ = 16384, 2048, 4096, 8512
#: the Nemotron-H cell's: 4 sequences of 8,192 tokens, the hidden width
#: 2,688 (21 x 128), the mixer's 4,096 normalised in 8 groups of 512, and
#: ``in_proj``'s 10,304
NEMOTRON_ROWS, NEMOTRON_HIDDEN, NEMOTRON_GROUP, NEMOTRON_IN_PROJ = 32768, 2688, 512, 10304
#: the published ``rms_norm_eps``
EPS = 1e-5
#: the largest gap of each gradient from the float64 plain version's, as a
#: share of its norm.  bf16 gradients are compared with the float64 ones
#: rounded to bf16: the kernels' float32 round-off (a few 2^-24 of each
#: term) moves an element across a rounding boundary, one bf16 step, at a
#: few in 10^4 elements, so their gap is of order 1e-4; ``dw`` is a float32
#: sum over the rows of exact products, 1e-6.  float32 gradients carry only
#: float32 round-off.  A wrong index or a lost term moves a share of order 1.
BF16_GRAD_TOL, DW_TOL, F32_TOL = 1e-3, 1e-4, 1e-5


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def rms_inputs(rows: int, width: int, gated: bool, dtype: torch.dtype, gen: torch.Generator,
               gate_from: int | None = None) -> dict:
    """From ``gen`` on its device: ``x`` ``N(0, s^2)`` with ``s`` in ``[0.5,
    ~3]`` a row, an output gradient ``dout``, the float32 ``weight`` ``1 +
    N(0, 0.1^2)`` and, gated, a gate ``N(0, 2^2)`` (silu's curved range)
    taken as the first ``width`` columns of a ``(rows, gate_from)`` tensor,
    as the mixer's ``z`` is of ``in_proj``'s output."""
    dev = gen.device

    def rnd(*s):
        return torch.randn(s, generator=gen, device=dev)

    inp = {"x": (rnd(rows, width) * (0.5 + rnd(rows, 1).abs())).to(dtype),
           "dout": rnd(rows, width).to(dtype), "weight": 1 + 0.1 * rnd(width)}
    if gated:
        inp["gate"] = (2 * rnd(rows, gate_from or width)).to(dtype)[:, :width]
    return inp


def rms_run(fn, inp: dict, wide=None, group: int | None = None) -> dict:
    """``fn`` forward and backward on ``inp`` (widened to ``wide`` if given,
    else the gate's view as it is), over groups of ``group`` columns if
    given: the output and every gradient."""
    cast = (lambda t: t.to(wide)) if wide is not None else (lambda t: t)
    x, weight = (cast(inp[k]).detach().requires_grad_() for k in ("x", "weight"))
    gate = cast(inp["gate"]).detach().requires_grad_() if "gate" in inp else None
    out = fn(x, weight, EPS, gate) if group is None else fn(x, weight, EPS, gate, group)
    leaves = (x, weight) if gate is None else (x, weight, gate)
    grads = torch.autograd.grad(out, leaves, cast(inp["dout"]))
    return dict(zip(("out", "dx", "dw", "dg"), (out.detach(), *grads)))


def rms_compare(inp: dict, what: str, group: int | None = None) -> dict:
    """:func:`rms_norm` on the card's tensors ``inp`` (the kernels) against
    the float64 plain version: a bf16 output equal to its rounding or one
    bf16 step apart, at most 1% of elements apart, a float32 one within
    ``F32_TOL`` of its norm; each gradient within its tolerance above; two
    runs bit-equal.  Raises on a failed check; returns the worst gaps."""
    _check(inp["x"].is_cuda, f"{what}: the kernels' comparison needs the card's tensors")
    got = rms_run(rms_norm, inp, group=group)
    again = rms_run(rms_norm, inp, group=group)
    torch.cuda.synchronize()  # a fault in a kernel surfaces here
    for k in got:
        _check(torch.equal(got[k], again[k]), f"{what}: two runs give different {k}")
    exact = rms_run(rms_norm_plain, inp, wide=torch.float64, group=group)
    bf16 = got["out"].dtype == torch.bfloat16
    gaps = {}
    if bf16:
        want = exact["out"].to(torch.bfloat16)
        far = bf16_steps_apart(got["out"], want, torch.zeros_like(want, dtype=torch.float32))
        _check(not bool(far.any()),
               f"{what}: {int(far.sum())} outputs more than one bf16 step from the float64 "
               f"plain version's: kernel {got['out'][far][:4].tolist()}, plain "
               f"{exact['out'][far][:4].tolist()}")
        gaps["out_apart_share"] = float((got["out"] != want).float().mean())
        _check(gaps["out_apart_share"] <= 0.01,
               f"{what}: {gaps['out_apart_share']:.4%} of outputs off the plain version's")
    else:
        gaps["out"] = float((got["out"].double() - exact["out"]).norm() / exact["out"].norm())
        _check(gaps["out"] <= F32_TOL, f"{what}: out is {gaps['out']:.3g} of its norm off")
    for k in got:
        if k == "out":
            continue
        want = exact[k].to(got[k].dtype).double()
        gaps[k] = float((got[k].double() - want).norm() / exact[k].norm())
        tol = F32_TOL if not bf16 else DW_TOL if k == "dw" else BF16_GRAD_TOL
        _check(gaps[k] <= tol, f"{what}: {k} is {gaps[k]:.3g} of the float64 plain version's "
                               f"norm off (tolerance {tol})")
    return gaps
