"""Mamba-2's chunked state-space scan (SSD): the Hopper kernels, their
autograd function and the plain version.

:func:`ssd_scan` computes, for each batch row and head ``h``, the
selective state-space recurrence of Mamba-2 (Dao and Gu 2024, *Transformers
are SSMs*, §6), the heads in ``G`` groups of ``H / G`` consecutive heads that
share one ``B`` and one ``C`` (head ``h`` reads group ``h // (H / G)``)::

    S_t = exp(dt_t A_h) S_{t-1} + dt_t x_t B_t^T,    S_0 = 0  (a (P, N) state)
    y_t = S_t C_t + D_h x_t

over ``x`` ``(b, T, H, P)``, ``dt`` ``(b, T, H)`` float32 (after the
softplus), ``A`` ``(H,)`` float32 (negative), ``B`` and ``C`` ``(b, T, G,
N)`` (or ``(b, T, N)``: one group) and ``D`` ``(H,)`` float32, in the paper's
chunked form: inside a chunk of ``chunk`` positions the decay-masked
products ``(C B^T * L) (dt x)``, ``C B^T`` once a group; the chunk's end
state; a sequential pass of the states over the chunks; the states'
contribution ``exp(s) C H^T`` and ``D x``.  The result has ``x``'s dtype.
A length that is no multiple of the chunk is padded at the end with ``dt =
0`` (no decay, no input), which leaves every earlier output as it is.

- On a CPU tensor it is :func:`ssd_scan_plain`, in float32 (float64 for a
  float64 input), rounded once to ``x``'s dtype.
- On a CUDA tensor it is :class:`SsdScan`: bf16 ``x``, ``B`` and ``C``, a
  chunk of 128 or 256 (:data:`CHUNKS`), ``H`` a multiple of ``G``; the
  matrix products are ``torch.bmm`` (cuBLAS), per group where ``B`` or ``C``
  enters, the decay mask, the float32 state pass and the passes and
  reductions around them the launches of ``csrc/ssd_scan.cu``.  The chunks'
  end states, the pass and the entering states are float32; an entering
  state is rounded to bf16 only as an operand of the products by ``C``
  (forward) and ``dy`` (backward).  Its backward recomputes the chunk states
  from the saved inputs (nothing but the inputs is kept), and its gradients
  cannot be differentiated again.  It refuses what the kernels do not take
  and never falls back.  With one group it computes what it did before
  groups were taken, launch for launch.

``ssd_scan.forward_calls`` and ``ssd_scan.backward_calls`` count the
function's calls and their backward passes on either path;
``ssd_scan.launches`` counts kernel launches (3 a forward, 5 a backward).
On either path the spans ``hh.ssd_scan.forward`` and
``hh.ssd_scan.backward`` (``core/profiling.py``) hold one call's forward and
backward, kernels and products alike.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from haplohyped_tpu_torch.core.profiling import annotate
from haplohyped_tpu_torch.ops import _build


def ssd_scan_plain(x, dt, A, B, C, D, chunk: int) -> torch.Tensor:
    """:func:`ssd_scan` in torch ops, differentiable by autograd: the
    paper's chunked form with the state pass as a loop over the chunks."""
    out_dtype, wide = x.dtype, torch.promote_types(x.dtype, torch.float32)
    b, T, H, P = x.shape
    if B.dim() == 3:
        B, C = B[:, :, None], C[:, :, None]
    G, N = B.shape[-2:]
    K = H // G
    pad = (-T) % chunk
    x, dt, B, C = (F.pad(t.to(wide), (0, 0) * (t.dim() - 2) + (0, pad))
                   for t in (x, dt, B, C))
    nc, Q = (T + pad) // chunk, chunk
    x = x.view(b, nc, Q, G, K, P)
    B, C = B.view(b, nc, Q, G, N), C.view(b, nc, Q, G, N)
    dt = dt.view(b, nc, Q, G, K)
    s = torch.cumsum(dt * A.to(wide).view(G, K), dim=2).permute(0, 3, 4, 1, 2)  # (b, G, K, nc, Q)
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp((s[..., :, None] - s[..., None, :]).masked_fill(~causal, -torch.inf))
    xdt = x * dt[..., None]
    CB = torch.einsum("bcign,bcjgn->bcgij", C, B)  # once a group
    y = torch.einsum("bcgij,bgkcij,bcjgkp->bcigkp", CB, decay, xdt)
    # each chunk's end state, then the states entering each chunk
    states = torch.einsum("bcjgn,bgkcj,bcjgkp->bcgkpn", B, torch.exp(s[..., -1:] - s), xdt)
    chunk_decay = torch.exp(s[..., -1])  # (b, G, K, nc)
    h = x.new_zeros(b, G, K, P, N)
    entering = []
    for c in range(nc):
        entering.append(h)
        h = chunk_decay[..., c, None, None] * h + states[:, c]
    y = y + torch.einsum("bcign,bcgkpn,bgkci->bcigkp", C, torch.stack(entering, 1),
                         torch.exp(s))
    y = y + x * D.to(wide).view(G, K, 1)
    return y.reshape(b, nc * Q, H, P)[:, :T].to(out_dtype)


class _PlainScan(torch.autograd.Function):
    """The plain version on the CPU, its backward recomputed from the inputs
    (as the kernels' is), so the calls are counted alike on both paths."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, A, B, C, D)
        ssd_scan.forward_calls += 1
        with annotate("hh.ssd_scan.forward"):
            return ssd_scan_plain(x, dt, A, B, C, D, chunk)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        ssd_scan.backward_calls += 1
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with annotate("hh.ssd_scan.backward"), torch.enable_grad():
            y = ssd_scan_plain(*inputs, ctx.chunk)
            grads = torch.autograd.grad(y, inputs, dy)
        return (*grads, None)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_kernel("ssd_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hh_ssd_chunk_ok.argtypes = [i]
    lib.hh_ssd_chunk_ok.restype = i
    lib.hh_ssd_fwd_prep.argtypes = [i] * 6 + [p] * 9 + [p]
    lib.hh_ssd_bwd_prep.argtypes = [i] * 6 + [p] * 13 + [p]
    lib.hh_ssd_state_pass.argtypes = [i] * 6 + [p, p, p, p, i, p]
    lib.hh_ssd_fwd_combine.argtypes = [i] * 6 + [p] * 6 + [p]
    lib.hh_ssd_bwd_reverse_pass.argtypes = [i] * 6 + [p] * 5 + [p]
    lib.hh_ssd_bwd_mask.argtypes = [i] * 6 + [p] * 7 + [p]
    lib.hh_ssd_bwd_finish.argtypes = [i] * 6 + [p] * 17 + [p]
    for name in ("hh_ssd_fwd_prep", "hh_ssd_bwd_prep", "hh_ssd_state_pass",
                 "hh_ssd_fwd_combine", "hh_ssd_bwd_reverse_pass", "hh_ssd_bwd_mask",
                 "hh_ssd_bwd_finish"):
        getattr(lib, name).restype = i
    lib.hh_ssd_error_string.argtypes = [i]
    lib.hh_ssd_error_string.restype = ctypes.c_char_p
    return lib


def load() -> None:
    """Build and load the kernels now (a model on a CUDA device calls this
    at construction, so the first build falls in set-up)."""
    _library()


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"ssd_scan {what} launch failed: "
                           f"{_library().hh_ssd_error_string(rc).decode()}")


#: the chunks the kernels take
CHUNKS = (128, 256)


def _validate(x, dt, A, B, C, D, chunk: int) -> None:
    """Raise on what the kernels do not take (``B`` and ``C`` ``(b, T, G,
    N)`` here)."""
    if not x.is_cuda:
        raise ValueError(f"the kernels take CUDA tensors, got one on {x.device}")
    if chunk not in CHUNKS or not _library().hh_ssd_chunk_ok(chunk):
        raise ValueError(f"the kernels take a chunk of {' or '.join(map(str, CHUNKS))}, "
                         f"got {chunk}")
    if x.dim() != 4 or B.dim() != 4:
        raise ValueError(f"x must be (b, T, H, P) and B (b, T, G, N), got {tuple(x.shape)} "
                         f"and {tuple(B.shape)}")
    b, T, H, P = x.shape
    G, N = B.shape[-2:]
    if G < 1 or H % G:
        raise ValueError(f"the {H} heads must fall into the {G} groups of B and C evenly")
    shapes = {"x": (x, torch.bfloat16, (b, T, H, P)), "dt": (dt, torch.float32, (b, T, H)),
              "A": (A, torch.float32, (H,)), "B": (B, torch.bfloat16, (b, T, G, N)),
              "C": (C, torch.bfloat16, (b, T, G, N)), "D": (D, torch.float32, (H,))}
    for name, (t, dtype, shape) in shapes.items():
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} {shape} tensor on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if T % chunk:
        raise ValueError(f"T={T} is no multiple of the chunk {chunk}")


def _by_group(t: torch.Tensor, chunk: int) -> torch.Tensor:
    """``B`` or ``C`` ``(b, T, G, N)`` as ``(b nc G, Q, N)``, one matrix a
    chunk and group (a view for one group)."""
    b, T, G, N = t.shape
    return t.view(b, T // chunk, chunk, G, N).transpose(2, 3).reshape(-1, chunk, N)


def _by_token(t: torch.Tensor, b: int, T: int) -> torch.Tensor:
    """A ``(b nc G, Q, N)`` gradient back as ``(b, T, G, N)``."""
    n, Q, N = t.shape
    G = n // (b * (T // Q))
    return t.view(b, T // Q, G, Q, N).transpose(2, 3).reshape(b, T, G, N)


def _recompute(x, dt, A, B, C, chunk: int, dy=None) -> dict:
    """The forward's prep, chunk states and state pass (with ``dy``: the
    backward's, with ``dy`` head-major and scaled by ``exp(s)``).  The chunk
    states ``S`` and the entering states ``Hin`` are float32; ``Hb`` is
    ``Hin`` rounded to bf16, the operand of the products by ``C`` and ``dy``
    (Mamba-2's kernels round the states they multiply by ``C`` alike).  The
    operands of the per-group products (``xw``, ``dye``) are group-major,
    ``(b nc G, Q, H / G P)``."""
    lib = _library()
    b, T, H, P = x.shape
    G, N = B.shape[-2:]
    nc, Q, K = T // chunk, chunk, H // G
    dev, bf = x.device, torch.bfloat16
    Bc, Cc = _by_group(B, chunk), _by_group(C, chunk)  # (b nc G, Q, N)
    Gm = torch.bmm(Cc.float(), Bc.float().transpose(1, 2))  # (b nc G, Q, Q): C B^T
    r = {"Bc": Bc, "Cc": Cc, "G": Gm,
         "s": torch.empty((b, H, T), dtype=torch.float32, device=dev),
         "e": torch.empty((b, H, nc), dtype=torch.float32, device=dev),
         "M": torch.empty((b * nc * H, Q, Q), dtype=bf, device=dev),
         "xh": torch.empty((b * nc * H, Q, P), dtype=bf, device=dev),
         "xw": torch.empty((b * nc * G, Q, K * P), dtype=bf, device=dev)}
    stream = torch.cuda.current_stream(dev).cuda_stream
    common = (b, T, H, P, G, Q, x.data_ptr(), dt.data_ptr(), A.data_ptr(), Gm.data_ptr(),
              r["s"].data_ptr(), r["e"].data_ptr(), r["M"].data_ptr(), r["xh"].data_ptr(),
              r["xw"].data_ptr())
    with torch.cuda.device(dev):
        if dy is None:
            _check(lib.hh_ssd_fwd_prep(*common, stream), "forward prep")
        else:
            r |= {"dyh": torch.empty_like(r["xh"]), "dye": torch.empty_like(r["xw"]),
                  "dtT": torch.empty_like(r["s"])}
            _check(lib.hh_ssd_bwd_prep(*common, dy.data_ptr(), r["dyh"].data_ptr(),
                                       r["dye"].data_ptr(), r["dtT"].data_ptr(), stream),
                   "backward prep")
        # each chunk's end state: (x w)^T B a group, (b nc G, K P, N) = (b nc, H P, N), float32
        S = torch.bmm(r["xw"].transpose(1, 2), Bc, out_dtype=torch.float32)
        r["Hin"], r["Hb"] = torch.empty_like(S), torch.empty_like(S, dtype=bf)
        _check(lib.hh_ssd_state_pass(b, T, H, P, N, Q, S.data_ptr(), r["e"].data_ptr(),
                                     r["Hin"].data_ptr(), r["Hb"].data_ptr(),
                                     int(dy is not None), stream),
               "state pass")
    ssd_scan.launches += 2
    return r


def _forward_kernel(x, dt, A, B, C, D, chunk: int) -> torch.Tensor:
    lib = _library()
    b, T, H, P = x.shape
    G = B.shape[-2]
    r = _recompute(x, dt, A, B, C, chunk)
    ydiag = torch.bmm(r["M"], r["xh"])  # (b nc H, Q, P)
    yoff = torch.bmm(r["Cc"], r["Hb"].transpose(1, 2))  # (b nc G, Q, K P): C H^T
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _check(lib.hh_ssd_fwd_combine(b, T, H, P, G, chunk, ydiag.data_ptr(), yoff.data_ptr(),
                                      r["s"].data_ptr(), x.data_ptr(), D.data_ptr(),
                                      y.data_ptr(), stream), "forward combine")
    ssd_scan.launches += 1
    return y


def _backward_kernel(x, dt, A, B, C, D, chunk: int, dy: torch.Tensor):
    lib = _library()
    b, T, H, P = x.shape
    G, N = B.shape[-2:]
    nc, Q = T // chunk, chunk
    dev, f32 = x.device, torch.float32
    if dy.dtype != x.dtype or dy.shape != x.shape:
        raise ValueError(f"the output's gradient is {dy.dtype} {tuple(dy.shape)}, the input "
                         f"{x.dtype} {tuple(x.shape)}")
    dy = dy.contiguous()
    r = _recompute(x, dt, A, B, C, chunk, dy)
    Bc, Cc, dye = r["Bc"], r["Cc"], r["dye"]
    Hb = r["Hb"].view(b * nc * G, -1, N)  # (b nc G, K P, N)
    yoff = torch.bmm(Cc, Hb.transpose(1, 2))
    dM = torch.bmm(r["dyh"], r["xh"].transpose(1, 2))  # (b nc H, Q, Q): dy x^T
    dxdiag = torch.bmm(r["M"].transpose(1, 2), r["dyh"])  # M^T dy
    dHloc = torch.bmm(dye.transpose(1, 2), Cc)  # (b nc G, K P, N)
    dCoff = torch.bmm(dye, Hb)  # (b nc G, Q, N)
    dS = torch.empty_like(Hb)
    de = torch.zeros((b, H, nc), dtype=f32, device=dev)
    dG = torch.empty((b * nc * G, Q, Q), dtype=f32, device=dev)
    ds = torch.zeros((b, H, T), dtype=f32, device=dev)
    ddt_acc = torch.zeros_like(ds)
    dx = torch.empty_like(x)
    ddt = torch.empty_like(dt)
    dA = torch.zeros_like(A)
    dD = torch.zeros_like(D)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _check(lib.hh_ssd_bwd_reverse_pass(b, T, H, P, N, Q, dHloc.data_ptr(),
                                           r["Hin"].data_ptr(), r["e"].data_ptr(),
                                           dS.data_ptr(), de.data_ptr(), stream),
               "reverse pass")
        dBst = torch.bmm(r["xw"], dS)  # (b nc G, Q, N)
        dxw = torch.bmm(Bc, dS.transpose(1, 2))  # (b nc G, Q, K P)
        _check(lib.hh_ssd_bwd_mask(b, T, H, P, G, Q, dM.data_ptr(), r["G"].data_ptr(),
                                   r["s"].data_ptr(), r["dtT"].data_ptr(), dG.data_ptr(),
                                   ds.data_ptr(), ddt_acc.data_ptr(), stream), "mask backward")
        _check(lib.hh_ssd_bwd_finish(b, T, H, P, G, Q, dxdiag.data_ptr(), dxw.data_ptr(),
                                     dy.data_ptr(), x.data_ptr(), yoff.data_ptr(),
                                     r["s"].data_ptr(), r["dtT"].data_ptr(), r["e"].data_ptr(),
                                     de.data_ptr(), A.data_ptr(), D.data_ptr(), ds.data_ptr(),
                                     ddt_acc.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
                                     dA.data_ptr(), dD.data_ptr(), stream), "finish")
    ssd_scan.launches += 3
    dC = _by_token(torch.bmm(dG, Bc.float()) + dCoff.float(), b, T).to(C.dtype)
    dB = _by_token(torch.bmm(dG.transpose(1, 2), Cc.float()) + dBst.float(), b, T).to(B.dtype)
    return dx, ddt, dA, dB, dC, dD


class SsdScan(torch.autograd.Function):
    """:func:`ssd_scan` on CUDA tensors through the kernels; the backward
    recomputes the mask and the chunk states from the saved inputs.  ``B``
    and ``C`` are ``(b, T, G, N)`` or ``(b, T, N)`` (one group), and their
    gradients take their shape.  Its gradients are written by the kernels,
    so they cannot be differentiated again."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, chunk):
        ctx.one_group = B.dim() == 3
        if ctx.one_group:
            B, C = B[:, :, None], C[:, :, None]
        _validate(x, dt, A, B, C, D, chunk)
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, A, B, C, D)
        ssd_scan.forward_calls += 1
        with annotate("hh.ssd_scan.forward"):
            return _forward_kernel(x, dt, A, B, C, D, chunk)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        ssd_scan.backward_calls += 1
        with annotate("hh.ssd_scan.backward"):
            dx, ddt, dA, dB, dC, dD = _backward_kernel(*ctx.saved_tensors, ctx.chunk, dy)
        if ctx.one_group:
            dB, dC = dB[:, :, 0], dC[:, :, 0]
        return dx, ddt, dA, dB, dC, dD, None


def ssd_scan(x, dt, A, B, C, D, chunk: int) -> torch.Tensor:
    """The chunked scan (module docstring): the kernels on CUDA tensors, the
    plain version on CPU ones.  A length that is no multiple of ``chunk`` is
    padded with ``dt = 0`` and the output cut back."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no ssd_scan for device {x.device}")
    T = x.shape[1]
    pad = (-T) % chunk
    if pad:
        x, dt, B, C = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                       for t in (x, dt, B, C))
    fn = _PlainScan if x.device.type == "cpu" else SsdScan
    y = fn.apply(x, dt, A, B, C, D, chunk)
    return y[:, :T] if pad else y


ssd_scan.forward_calls = 0
ssd_scan.backward_calls = 0
ssd_scan.launches = 0
