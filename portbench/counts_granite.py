"""The frozen counts of the Granite hybrid's cell, from the published shapes
(``reference/granite_hybrid.py``), kept with the benchmark so that a change
to the program cannot move them: a train step's FLOPs, and the least bytes
and the products' FLOPs of one call of the scan, the bound of its
roofline."""

from __future__ import annotations


def _dims(m: dict):
    d, H, P, N = m["hidden_size"], m["mamba_n_heads"], m["mamba_d_head"], m["mamba_d_state"]
    return d, H, P, N, m["mamba_chunk_size"], m["mamba_expand"] * d


def forward_flops_per_token(m: dict, L: int) -> int:
    """Matmul FLOPs (two a multiply-add) of one token's forward: every
    projection and MLP; the causal attention's scores and weighted sum
    (``L / 2`` keys on average); the scan's four products at full chunk
    (``C B^T``, the masked product with ``dt x``, the chunk states and the
    states' contribution); the conv; and the tied head.  Elementwise ops,
    the norms, the softmax and the optimiser are left out."""
    d, H, P, N, Q, W = _dims(m)
    hd = d // m["num_attention_heads"]
    conv = W + 2 * m["mamba_n_groups"] * N
    mlp = 2 * d * 2 * m["intermediate_size"] + 2 * m["intermediate_size"] * d
    mamba = (2 * d * (W + conv + H) + 2 * W * d + 2 * conv * m["mamba_d_conv"]
             + 2 * Q * N + 2 * Q * H * P + 2 * 2 * H * P * N)
    attn = (2 * d * (m["num_attention_heads"] + 2 * m["num_key_value_heads"]) * hd
            + 2 * m["num_attention_heads"] * hd * d + 2 * 2 * (L // 2) * m["num_attention_heads"] * hd)
    layers = sum(mlp + (mamba if k == "mamba" else attn) for k in m["layer_types"])
    return layers + 2 * d * m["vocab_size"]


def train_flops_per_step(m: dict, B: int, L: int) -> int:
    """A train step on ``B`` window pairs, ``2B`` sequences of ``L`` tokens:
    the forward of every token, x3 for the forward and the backward."""
    return 3 * 2 * B * L * forward_flops_per_token(m, L)


def ssd_bytes(m: dict, B: int, L: int, which: str) -> int:
    """The least bytes one call of the scan (``which``: ``fwd`` or ``bwd``)
    moves on ``2B`` sequences of ``L``, whatever computes it: each input
    read once and each output written once, no intermediate.  The forward
    reads ``x``, ``B``, ``C`` (bf16), ``dt``, ``A``, ``D`` (float32) and
    writes ``y`` (bf16); the backward reads the same inputs and ``dy`` and
    writes their gradients in their dtypes."""
    d, H, P, N, Q, W = _dims(m)
    tok = 2 * B * L
    inputs = tok * H * P * 2 + 2 * tok * N * 2 + tok * H * 4 + 2 * H * 4
    act = tok * H * P * 2  # y, or dy
    if which == "fwd":
        return inputs + act
    if which != "bwd":
        raise ValueError(f"which is fwd or bwd, got {which!r}")
    return inputs + act + inputs


def ssd_flops(m: dict, B: int, L: int, which: str) -> int:
    """The matrix products of one call of the chunked scan on ``2B``
    sequences of ``L`` (two FLOPs a multiply-add, every chunk at full
    ``Q x Q``): a chunk's ``C B^T`` (one group, shared by the heads), and a
    head's masked product with ``dt x``, its chunk state and the entering
    state's product with ``C``.  The backward's products (``dy x^T``, ``M^T
    dy``, the state's gradients, ``dG B`` and ``dG^T C``, ...) are twice the
    forward's; what it recomputes of the forward is not counted."""
    d, H, P, N, Q, W = _dims(m)
    chunks = 2 * B * (L // Q)
    fwd = chunks * (2 * Q * Q * N + H * (2 * Q * Q * P + 2 * 2 * Q * P * N))
    if which == "fwd":
        return fwd
    if which != "bwd":
        raise ValueError(f"which is fwd or bwd, got {which!r}")
    return 2 * fwd
