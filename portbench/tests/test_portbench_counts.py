"""The frozen counts: the train step's FLOPs and a chain link's least bytes."""

import json

import pytest

from portbench import counts
from portbench.tests.conftest import ROOT


def _model(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())["model"]


@pytest.mark.parametrize("config, B, gflop", [
    ("haploformer-flagship", 64, 387.67),
    ("haploformer-scaled", 256, 10_998.74),
])
def test_train_flops_per_step(config, B, gflop):
    assert counts.train_flops_per_step(_model(config), B, 1000) / 1e9 == pytest.approx(gflop, abs=0.005)


@pytest.mark.parametrize("config, B", [("haploformer-flagship", 64), ("haploformer-scaled", 256)])
def test_train_flops_match_the_program_today(config, B):
    from haplohyped_tpu_torch.models.haploformer import HaploFormerConfig, train_flops_per_step

    m = _model(config)
    assert counts.train_flops_per_step(m, B, 1000) == train_flops_per_step(
        HaploFormerConfig(**m), B, 1000)


def test_link_bytes_by_hand():
    # 3 windows of L=10 with 4 SNVs inside: each window reads its 12-byte draw
    # and 10 genome bytes and writes 2 * 10 + 8; each SNV reads 4 + 2 bytes
    assert counts.link_bytes(3, 10, 4) == 3 * (12 + 10 + 28) + 4 * 6 == 174


def test_link_bytes_at_a_chain_link():
    # sample_chain(16, 256) at B=64: 16,384 windows a link, L=1000
    b = counts.link_bytes(16_384, 1000, 16_384 * 1000 * 1.2e-3)
    assert b == pytest.approx(49.6e6, rel=0.01)
    assert b / counts.HBM_BYTES_PER_S * 1e3 == pytest.approx(0.0148, rel=0.01)
