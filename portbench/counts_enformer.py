"""The frozen FLOP count of an Enformer train step, from the published
equations (``reference/enformer.py``), kept with the benchmark so that a
change to the program cannot move it."""

from __future__ import annotations

from portbench.reference.enformer import filter_list, tracks


def train_flops_per_step(m: dict, heads: dict, B: int) -> int:
    """Matmul and convolution FLOPs (two a multiply-add) of one train step
    on ``B`` window pairs, ``2B`` sequences of ``sequence_length``: the
    stem's conv, pointwise conv and pooling logits; each tower stage's conv,
    pointwise conv and pooling logits; each transformer block's q, k, v and
    output projections, content logits, relative logits (over ``2T - 1``
    distances), weighted sum and MLP; the relative keys' projection once a
    forward (it takes no batch); the final pointwise conv and the head; x3
    for the forward and the backward.  Elementwise ops, the norms, the
    pooling's softmax and the optimiser are left out."""
    C, H, K, V = m["channels"], m["num_heads"], m["key_size"], m["value_size"]
    R, L = m["num_relative_position_features"], m["sequence_length"]
    seq = 2 * L * m["stem_width"] * m["num_channels"] * (C // 2) + 2 * 2 * L * (C // 2) ** 2
    n, c_in = L // 2, C // 2
    for f in filter_list(m):
        seq += 2 * n * m["tower_width"] * c_in * f + 2 * 2 * n * f * f
        n, c_in = n // 2, f
    T, Tt = n, m["target_length"]
    block = (2 * T * C * H * (2 * K + V) + 2 * H * T * T * K + 2 * H * T * (2 * T - 1) * K
             + 2 * H * T * T * V + 2 * T * H * V * C + 2 * 2 * T * C * 2 * C)
    seq += m["num_transformer_layers"] * block
    seq += 2 * Tt * C * 2 * C + 2 * Tt * 2 * C * tracks(heads)
    rel_keys = m["num_transformer_layers"] * 2 * (2 * T - 1) * R * H * K
    return 3 * (2 * B * seq + rel_keys)
