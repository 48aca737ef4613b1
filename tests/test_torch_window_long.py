"""The port's plain window encode against the JAX package's at Enformer's
window, L=196,608, with K=512 (windows past K overflow) and K=128, on the
long fixture of ``tests/test_torch_window_card.py``: bit-equal (integer
outputs, tolerance 0).  The card file holds the Hopper kernel against the
plain version on the same fixture."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from haplohyped_tpu.ops.haplotype_window import encode_haplotype_windows as jax_encode
from haplohyped_tpu_torch.ops.haplotype_window import encode_haplotype_windows
from haplohyped_tpu_torch.ops.window_kernel import K_MAX
from tests.test_torch_window_card import L_LONG, K_LONG, long_fixture


@pytest.mark.parametrize("seed, K", [(0, K_LONG), (1, 128)])
def test_plain_matches_jax_at_l_196608(seed, K):
    state, draws = long_fixture(seed, B=2)
    got = encode_haplotype_windows(*map(torch.from_numpy, state), *map(torch.from_numpy, draws),
                                   L=L_LONG, K=K)
    want = jax_encode(*map(jnp.asarray, state), *map(jnp.asarray, draws), L=L_LONG, K=K)
    for name in ("hap1", "hap2", "n_variants", "overflow"):
        g, w = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    assert int(got.overflow.max()) > 0  # donor 1's window holds more than K


def test_the_kernel_takes_k_up_to_512():
    assert K_MAX == K_LONG == 512
