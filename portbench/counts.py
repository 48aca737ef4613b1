"""The yardstick's frozen counts and the card's peaks.

Copies kept with the benchmark so that a change to the program cannot move
them: the train step's FLOPs (``haplohyped_tpu_torch/models/haploformer.py::
train_flops_per_step`` as of the benchmark's first version) and the least
bytes a chain link has to move, whatever implements it.
"""

from __future__ import annotations

#: H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet), FLOP/s
BF16_DENSE_FLOPS_PER_S = 989e12
#: H100 SXM device-memory rate (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12


def train_flops_per_step(model: dict, B: int, L: int) -> int:
    """Matmul and convolution FLOPs (two a multiply-add) of one train step on
    ``B`` window pairs of length ``L``: conv1 at L, conv2 at ``L // (pool //
    2)``, each block's q/k/v/out (8 d^2 a token), MLP (4 r d^2) and attention
    (4 T d a token), both towers, the heads, and x3 for the forward and the
    backward.  Elementwise ops, norms and the optimiser are left out."""
    d, C, W, r = model["d_model"], model["num_channels"], model["conv_width"], model["mlp_ratio"]
    L1 = L // (model["pool"] // 2)
    T = L1 // 2
    stem = 2 * W * (C * (d // 2) * L + (d // 2) * d * L1)
    block = T * (8 * d * d + 4 * r * d * d + 4 * T * d)
    heads = 2 * T * d * C + 2 * 2 * d
    return 3 * B * (2 * (stem + model["num_layers"] * block) + heads)


#: bytes a window's draw takes: region, donor and chromosome, int32 each
DRAW_BYTES = 12
#: bytes a window writes besides its codes: n_variants and overflow, int32
WINDOW_TAIL_BYTES = 8
#: bytes an in-window SNV has to be read with: its int32 position and its two
#: phased alleles, one int8 each
SNV_BYTES = 4 + 2


def link_bytes(windows: int, L: int, snvs: float) -> float:
    """The least bytes a chain link of ``windows`` windows of length ``L``
    with ``snvs`` SNVs inside them moves: each window's draw and its ``L``
    genome bytes read, each SNV read once, ``2 L + 8`` bytes written.  No
    index structure, no second pass for the digest."""
    return windows * (DRAW_BYTES + L + 2 * L + WINDOW_TAIL_BYTES) + snvs * SNV_BYTES
