"""The counts of the Nemotron-H hybrid's cell, from the published shapes
(``reference/nemotron_h.py``), kept with the benchmark so that a change to
the program cannot move them: a train step's FLOPs, the least bytes and the
products' FLOPs of one call of the scan (8 groups of ``B`` and ``C``, chunks
of 128), and of one forward call of the held experts' products.

The held experts' share of a step is not frozen: it is what the router sends
them, ``held_slots`` (token, slot) pairs a step, which the loop reads from
the program's counter over the window (``moe.held_slots``) and hands in."""

from __future__ import annotations

#: the mixer each letter of ``hybrid_override_pattern`` names
KINDS = {"M": "mamba", "E": "moe", "*": "attention"}


def _kinds(m: dict) -> list[str]:
    return [KINDS[c] for c in m["hybrid_override_pattern"]]


def _scan(m: dict):
    H, P, N, G = m["mamba_num_heads"], m["mamba_head_dim"], m["ssm_state_size"], m["n_groups"]
    return H, P, N, G, m["chunk_size"]


def dense_flops_per_token(m: dict, L: int) -> int:
    """Matmul FLOPs (two a multiply-add) of one token's forward but the
    routed experts': every projection; the conv; the scan's four products at
    full chunk (``C B^T`` once a group, the masked product with ``dt x``, the
    chunk states and the states' contribution); the causal attention's
    scores and weighted sum (``L / 2`` keys on average); the router over all
    the experts; the shared expert; the head.  Elementwise ops, the norms, the
    softmax, the selection and the optimiser are left out."""
    d = m["hidden_size"]
    H, P, N, G, Q = _scan(m)
    W, conv = H * P, H * P + 2 * G * N
    Hq, Hk, hd = m["num_attention_heads"], m["num_key_value_heads"], m["head_dim"]
    mamba = (2 * d * (W + conv + H) + 2 * W * d + 2 * conv * m["conv_kernel"]
             + 2 * Q * G * N + 2 * Q * H * P + 2 * 2 * H * P * N)
    attn = 2 * d * (Hq + 2 * Hk) * hd + 2 * Hq * hd * d + 2 * 2 * (L // 2) * Hq * hd
    fs = m["moe_shared_expert_intermediate_size"]
    moe = 2 * d * m["n_routed_experts"] + 2 * 2 * d * fs
    per = {"mamba": mamba, "attention": attn, "moe": moe}
    return sum(per[k] for k in _kinds(m)) + 2 * d * m["vocab_size"]


def experts_flops(m: dict, slots: int) -> int:
    """The routed experts' products over ``slots`` held (token, slot) pairs:
    ``up`` and ``down``, two FLOPs a multiply-add."""
    return 2 * 2 * slots * m["hidden_size"] * m["moe_intermediate_size"]


def experts_bytes(m: dict, slots: int) -> int:
    """The least bytes of one forward call of the held experts' products
    over ``slots`` rows: the gathered bf16 rows read, both float32 weight
    stacks read once, the bf16 hidden activation written and read once, the
    bf16 output written."""
    d, f, E = m["hidden_size"], m["moe_intermediate_size"], m["experts_held"][1]
    return 2 * slots * d + 4 * 2 * E * f * d + 2 * 2 * slots * f + 2 * slots * d


def train_flops_per_step(m: dict, B: int, L: int, held_slots: float) -> float:
    """A train step on ``B`` window pairs, ``2B`` sequences of ``L`` tokens,
    whose MoE layers compute ``held_slots`` (token, slot) pairs on this card
    in all: the forward x3 for the forward and the backward."""
    return 3 * (2 * B * L * dense_flops_per_token(m, L) + experts_flops(m, held_slots))


def ssd_bytes(m: dict, B: int, L: int, which: str) -> int:
    """The least bytes one call of the scan (``which``: ``fwd`` or ``bwd``)
    moves on ``2B`` sequences of ``L``: each input read once and each output
    written once, no intermediate.  The forward reads ``x``, ``B``, ``C``
    (bf16, ``B`` and ``C`` a group's ``N`` a token each), ``dt``, ``A``,
    ``D`` (float32) and writes ``y`` (bf16); the backward reads the same
    inputs and ``dy`` and writes their gradients in their dtypes."""
    H, P, N, G, Q = _scan(m)
    tok = 2 * B * L
    inputs = tok * H * P * 2 + 2 * tok * G * N * 2 + tok * H * 4 + 2 * H * 4
    act = tok * H * P * 2
    if which == "fwd":
        return inputs + act
    if which != "bwd":
        raise ValueError(f"which is fwd or bwd, got {which!r}")
    return inputs + act + inputs


def ssd_flops(m: dict, B: int, L: int, which: str) -> int:
    """The matrix products of one call of the chunked scan on ``2B``
    sequences of ``L`` (two FLOPs a multiply-add, every chunk at full ``Q x
    Q``): a chunk's ``C B^T`` once a group, and a head's masked product with
    ``dt x``, its chunk state and the entering state's product with ``C``.
    The backward's products are twice the forward's; what it recomputes of
    the forward is not counted."""
    H, P, N, G, Q = _scan(m)
    chunks = 2 * B * (L // Q)
    fwd = chunks * (G * 2 * Q * Q * N + H * (2 * Q * Q * P + 2 * 2 * Q * P * N))
    if which == "fwd":
        return fwd
    if which != "bwd":
        raise ValueError(f"which is fwd or bwd, got {which!r}")
    return 2 * fwd
