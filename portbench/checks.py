"""The numbers that decide ``correct``, each against its limit.

Exact answers (windows, digests, keys) are compared element by element with
the limit 0.  A training run is compared with the reference's first three
steps by three numbers (``PERF.md`` gives the readings each limit was set
from, and the look behind each choice):

- ``grad_gap``: over the leaves, the largest gap between the first
  gradient's norm (the program's worked out from AdamW's first moment after
  one step) and the reference's, over the reference's norm of that leaf or
  of the median leaf, whichever is larger;
- ``row_grad_gap``: the loss's gradient with respect to the model's two
  outputs (``variant_count``, ``base_logits``) row by row in the first step,
  as the timed step's backward takes it, against the reference's
  (``reference/haploformer.py::Model.output_grads``): the larger
  ``||g - g_ref|| / ||g_ref||`` of the two, rows the program lacks counted
  as zero.  It is each row's weight in the loss: a mean over the wrong rows
  reads about 1, where norms and means cannot tell half of a batch of alike
  random windows from the whole;
- ``grad_sign_share``: the share of the first gradient's elements, over
  the leaves ``change_gap`` takes, whose sign differs from the
  reference's.  AdamW's first update moves each element by about the
  learning rate in its gradient's sign, so this is the share of the first
  update that goes the wrong way; one precision lower flips several times
  as many as bf16 does;
- ``change_gap``: the median leaf's gap of the change after the steps, as
  ``grad_gap`` takes it, over the leaves whose first reference gradient is
  at least ``TINY_GRAD`` of the median leaf's (a key's bias under softmax
  has a gradient that is zero but for round-off).  Not the worst leaf: where
  a leaf's first gradient all but cancels, rounding sets its elements'
  signs, and AdamW's first update moves every element by about the learning
  rate in that sign, so one leaf's change can differ by a third or more on a
  sound run.

The first step's loss is logged and not compared: over five dozen seeds
the fp8 control reads as little as 1.2 times the largest sound gap, so it
sets no upper end, and ``grad_sign_share`` catches the control.
"""

from __future__ import annotations

import math
import statistics
from typing import NamedTuple

import torch

#: a leaf's first gradient under this share of the median leaf's leaves it
#: out of ``change_gap``
TINY_GRAD = 1e-3


class Check(NamedTuple):
    name: str
    value: float
    limit: float
    note: str = ""

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def mismatches(pairs) -> int:
    """Elements that differ over ``(got, want)`` tensor pairs (a shape that
    differs counts every element of ``want``)."""
    n = 0
    for got, want in pairs:
        got, want = got.cpu().long(), want.cpu().long()
        n += int((got != want).sum()) if got.shape == want.shape else want.numel()
    return n


def _leaf_gaps(prog: dict, ref: dict, names) -> dict[str, float]:
    """Each leaf's ``|prog - ref|`` over its reference norm or the median
    leaf's, whichever is larger (a leaf the program lacks reads 1)."""
    floor = statistics.median(ref[k] for k in names)
    return {k: abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], floor, 1e-30) for k in names}


def _worst(gaps: dict) -> tuple[float, str]:
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def loss_gaps(prog: dict, ref: dict) -> list[float]:
    """``|loss - ref| / |ref|`` of each step (inf where one side has no
    finite loss for it)."""
    n = max(len(prog["losses"]), len(ref["losses"]), 1)
    out = [math.inf] * n
    for i, (p, r) in enumerate(zip(prog["losses"], ref["losses"])):
        gap = abs(p - r) / abs(r)
        out[i] = gap if math.isfinite(gap) else math.inf
    return out


def row_grad_gaps(prog_rows: dict, ref_rows: dict) -> dict[str, float]:
    """``||g - g_ref|| / ||g_ref||`` of each output of ``ref_rows``; ``g``
    is ``prog_rows``' gradient, its missing rows (or a missing output)
    counted as zero; more rows than the reference's read inf."""
    out = {}
    for k, want in ref_rows.items():
        want = want.double()
        got = prog_rows.get(k)
        got = want.new_zeros(0, *want.shape[1:]) if got is None else got.to(want)
        if got.shape[1:] != want.shape[1:] or got.shape[0] > want.shape[0]:
            out[k] = math.inf
            continue
        full = want.new_zeros(want.shape)
        full[: got.shape[0]] = got
        gap = float((full - want).norm() / want.norm())
        out[k] = gap if math.isfinite(gap) else math.inf
    return out


def row_grad_gap(prog_rows: dict, ref_rows: dict) -> tuple[float, str]:
    """The larger of ``row_grad_gaps``, and where."""
    gaps = row_grad_gaps(prog_rows, ref_rows)
    k = max(gaps, key=gaps.get)
    rows = prog_rows[k].shape[0] if k in prog_rows else 0
    return gaps[k], f"{k}, {rows} of {ref_rows[k].shape[0]} rows"


def sign_share(prog_vec: dict, ref_vec: dict, names) -> float:
    """The share of the elements of leaves ``names`` whose sign in
    ``prog_vec`` differs from ``ref_vec``'s (a leaf the program lacks counts
    as zero, which no positive element matches)."""
    flips = total = 0
    for k in names:
        want = ref_vec[k]
        got = prog_vec.get(k)
        got = torch.zeros_like(want) if got is None else got.to(want.device)
        flips += int(((got > 0) != (want > 0)).sum())
        total += want.numel()
    return flips / total


def train_gaps(prog: dict, ref: dict) -> dict[str, tuple[float, str]]:
    """``{name: (value, where)}`` of the numbers compared; ``prog`` holds
    ``grad`` and ``change`` (leaf to norm), ``grad_vec`` (leaf to first
    gradient) and ``output_grads`` (output to its gradient row by row),
    ``ref`` what
    ``reference/haploformer.py::train`` returns in float32."""
    g_med = statistics.median(ref["grad"].values())
    moved = [k for k, g in ref["grad"].items() if g >= TINY_GRAD * g_med]
    change = _leaf_gaps(prog["change"], ref["change"], moved)
    worst, leaf = _worst(change)
    return {"grad_gap": _worst(_leaf_gaps(prog["grad"], ref["grad"], list(ref["grad"]))),
            "row_grad_gap": row_grad_gap(prog["output_grads"], ref["output_grads"]),
            "grad_sign_share": (sign_share(prog["grad_vec"], ref["grad_vec"], moved),
                                f"{len(moved)} leaves"),
            "change_gap": (statistics.median(change.values()),
                           f"median of {len(change)} leaves; worst {worst:.3g} ({leaf})")}
