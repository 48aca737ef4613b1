"""The chunked state-space scan (``ops/ssd_scan.py``).

On the CPU its plain chunked form against the token-by-token recurrence
``S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T``, ``y_t = S_t C_t + D x_t``
in float64, forward and the gradients of every input: at lengths that are
and are not multiples of the chunk, so states cross chunk boundaries and a
short last chunk is padded.  float64 with only the order of sums apart: the
output and each gradient within ``1e-10`` of the recurrence's largest value.

On the card (``cuda``-marked; this module imports no JAX, so it collects
there) the kernels against the plain version in float32 on the same bf16
inputs, at the Granite hybrid cell's ``(2, 8192)`` with 64 heads of 64 and
a state of 128, and at a small odd shape: each result within
``tools/ssd_scan_check.py::TOLERANCE`` of the plain version's norm (the
kernels round the mask, the products' operands and outputs to bf16).
"""

import pytest
import torch

from haplohyped_tpu_torch.core.profiling import annotate, recording
from haplohyped_tpu_torch.ops import ssd_scan as S
from haplohyped_tpu_torch.tools.ssd_scan_check import (
    CELL_SHAPE,
    NEMOTRON_CHUNK,
    NEMOTRON_SHAPE,
    ssd_compare,
    ssd_inputs,
)

NAMES = ("x", "dt", "A", "B", "C", "D")


def _inputs(b, T, H, P, N, seed):
    g = torch.Generator().manual_seed(seed)
    f64 = torch.float64
    return {"x": torch.randn(b, T, H, P, generator=g, dtype=f64),
            "dt": torch.rand(b, T, H, generator=g, dtype=f64) * 0.3,
            "A": -(0.1 + 2 * torch.rand(H, generator=g, dtype=f64)),
            "B": torch.randn(b, T, N, generator=g, dtype=f64),
            "C": torch.randn(b, T, N, generator=g, dtype=f64),
            "D": torch.randn(H, generator=g, dtype=f64)}


def recurrence(x, dt, A, B, C, D):
    b, T, H, P = x.shape
    state = x.new_zeros(b, H, P, B.shape[-1])
    ys = []
    for t in range(T):
        decay = torch.exp(dt[:, t, :, None, None] * A[:, None, None])
        state = decay * state + (dt[:, t, :, None, None] * x[:, t, :, :, None]
                                 * B[:, t, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", state, C[:, t]) + D[:, None] * x[:, t])
    return torch.stack(ys, 1)


def grouped_recurrence(x, dt, A, B, C, D):
    """The recurrence with ``B`` and ``C`` ``(b, T, G, N)``: head ``h``
    reads group ``h // (H / G)``."""
    K = x.shape[2] // B.shape[2]
    ys = [recurrence(x[:, :, h: h + 1], dt[:, :, h: h + 1], A[h: h + 1], B[:, :, h // K],
                     C[:, :, h // K], D[h: h + 1]) for h in range(x.shape[2])]
    return torch.cat(ys, 2)


def _grads(fn, inp, dy):
    args = [inp[k].clone().requires_grad_() for k in NAMES]
    y = fn(*args)
    return (y.detach(), *torch.autograd.grad(y, args, dy))


@pytest.mark.parametrize("T,chunk", [(64, 16), (70, 16), (5, 16), (33, 8), (40, 40)])
def test_the_chunked_form_is_the_recurrence(T, chunk):
    inp = _inputs(2, T, 3, 4, 5, seed=T + chunk)
    dy = torch.randn(2, T, 3, 4, generator=torch.Generator().manual_seed(1),
                     dtype=torch.float64)
    got = _grads(lambda *a: S.ssd_scan(*a, chunk), inp, dy)
    want = _grads(recurrence, inp, dy)
    for name, a, b in zip(("y",) + NAMES, got, want):
        assert float((a - b).abs().max()) <= 1e-10 * float(b.abs().max()), name


@pytest.mark.parametrize("G,H,T,chunk", [(2, 4, 40, 16), (4, 4, 33, 8), (2, 6, 300, 128),
                                         (1, 3, 130, 128)])
def test_the_grouped_chunked_form_is_the_recurrence(G, H, T, chunk):
    """Groups of ``B`` and ``C`` shared by ``H / G`` heads each, and the
    chunk of 128 the Nemotron-H mixers take (300 tokens: a padded third
    chunk), against the per-head recurrence, forward and every gradient."""
    inp = _inputs(2, T, H, 4, 5, seed=T + G)
    g = torch.Generator().manual_seed(G)
    inp["B"] = torch.randn(2, T, G, 5, generator=g, dtype=torch.float64)
    inp["C"] = torch.randn(2, T, G, 5, generator=g, dtype=torch.float64)
    dy = torch.randn(2, T, H, 4, generator=torch.Generator().manual_seed(2),
                     dtype=torch.float64)
    got = _grads(lambda *a: S.ssd_scan(*a, chunk), inp, dy)
    want = _grads(grouped_recurrence, inp, dy)
    for name, a, b in zip(("y",) + NAMES, got, want):
        assert a.shape == b.shape, name
        assert float((a - b).abs().max()) <= 1e-10 * float(b.abs().max()), name


def test_one_group_in_four_dimensions_is_one_group_in_three():
    inp = _inputs(1, 40, 3, 4, 5, seed=9)
    y3 = S.ssd_scan(*(inp[k] for k in NAMES), 16)
    four = {**inp, "B": inp["B"][:, :, None], "C": inp["C"][:, :, None]}
    assert torch.equal(y3, S.ssd_scan(*(four[k] for k in NAMES), 16))


def test_states_carry_across_chunks():
    """An input in the first chunk alone still moves the last chunk's
    output, by the decay the recurrence gives it."""
    inp = _inputs(1, 64, 2, 3, 4, seed=0)
    inp["x"][:, 16:] = 0
    y = S.ssd_scan(*(inp[k] for k in NAMES), 16)
    want = recurrence(*(inp[k] for k in NAMES))
    assert float(y[:, 48:].abs().max()) > 1e-6
    # float64, the order of sums apart: outputs of order 1 agree to ~1e-15
    torch.testing.assert_close(y, want, rtol=0, atol=1e-12)


def test_a_bf16_input_gives_a_bf16_output_and_the_calls_are_counted():
    inp = {k: (v.to(torch.bfloat16) if k in ("x", "B", "C") else v.float())
           for k, v in _inputs(1, 40, 2, 8, 4, seed=3).items()}
    args = [inp[k].requires_grad_() for k in NAMES]
    calls = (S.ssd_scan.forward_calls, S.ssd_scan.backward_calls)
    y = S.ssd_scan(*args, 16)
    assert y.dtype == torch.bfloat16 and y.shape == (1, 40, 2, 8)
    y.float().sum().backward()
    assert (S.ssd_scan.forward_calls - calls[0], S.ssd_scan.backward_calls - calls[1]) == (1, 1)
    assert args[0].grad.dtype == torch.bfloat16 and args[1].grad.dtype == torch.float32


def test_a_span_holds_each_forward_and_each_backward():
    """``hh.ssd_scan.forward`` and ``.backward`` open once a call, inside
    the caller's span for the forward; the backward's opens where autograd
    runs it."""
    inp = _inputs(1, 40, 2, 3, 4, seed=5)
    args = [inp[k].requires_grad_() for k in NAMES]
    with recording() as rec:
        with annotate("caller"):
            y = S.ssd_scan(*args, 16)
        y.sum().backward()
    totals = rec.totals()
    assert totals["hh.ssd_scan.forward"]["calls"] == 1
    assert totals["hh.ssd_scan.backward"]["calls"] == 1
    rows = rec.rows()
    fwd = next(r for r in rows if r["name"] == "hh.ssd_scan.forward")
    assert rows[fwd["parent"]]["name"] == "caller"


# -- on the card ---------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [CELL_SHAPE, (3, 768, 5, 24, 40), (1, 256, 1, 32, 8)],
                         ids=["cell", "odd", "one_chunk"])
def test_kernels_match_the_plain_version_on_card(shape):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(sum(shape))
    ssd_compare(ssd_inputs(shape, gen, torch.device("cuda")))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [NEMOTRON_SHAPE, (3, 640, 6, 24, 40, 3), (1, 128, 4, 32, 8, 4),
                                   (2, 768, 8, 64, 16, 1)],
                         ids=["nemotron_cell", "odd_groups", "one_chunk", "one_group_4d"])
def test_grouped_kernels_at_chunk_128_match_the_plain_version_on_card(shape):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(sum(shape))
    ssd_compare(ssd_inputs(shape, gen, torch.device("cuda")), NEMOTRON_CHUNK)


@pytest.mark.cuda
def test_the_kernels_refuse_what_they_do_not_take():
    _need_card()
    inp = ssd_inputs((1, 512, 2, 8, 4), torch.Generator(device="cuda").manual_seed(0),
                     torch.device("cuda"))
    args = [inp[k] for k in NAMES]
    with pytest.raises(ValueError, match="chunk"):
        S.SsdScan.apply(*args, 64)
    with pytest.raises(ValueError, match="x must be"):
        S.SsdScan.apply(args[0].float(), *args[1:], 256)
    grouped = ssd_inputs((1, 512, 6, 8, 4, 4), torch.Generator(device="cuda").manual_seed(1),
                         torch.device("cuda"))
    with pytest.raises(ValueError, match="groups"):
        S.SsdScan.apply(*(grouped[k] for k in NAMES), 128)
