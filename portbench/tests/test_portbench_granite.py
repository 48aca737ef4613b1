"""The Granite hybrid cell at toy size on the CPU: its run, its checks and
its result line; the reference's scan against the token-by-token
recurrence; the frozen counts against a hand count.  The model against the
reference has its tests in ``tests/test_torch_granite_hybrid.py``."""

import json

import pytest
import torch

from portbench import counts_granite
from portbench.catalog import Catalog
from portbench.reference import granite_hybrid as ref
from portbench.run import run_cell
from portbench.tests.conftest import DEVICE, ROOT, SEED, TINY_DEPLOYMENT, make_tiny

CELL = "granite-hybrid-pair-train"
CONFIG = "portbench/configs/granite-4.0-h-micro-dna-8k.json"
#: the published layer pattern at toy widths: hidden 64, 8 Mamba-2 heads of
#: 16 with a state of 16 in chunks of 32, 4 query and 2 key heads, a
#: 512-row vocabulary, 80-bp windows (3 chunks, the last one short)
TINY_GRANITE = {"hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
                "num_key_value_heads": 2, "mamba_n_heads": 8, "mamba_d_head": 16,
                "mamba_d_state": 16, "mamba_chunk_size": 32, "vocab_size": 512,
                "loss_chunk": 64}
#: toy-size limits: bf16 on the CPU against float32 reads under a third of
#: each over a dozen seeds (at most 0.0082, 0.0024, 0.0037 and 0.00032)
TINY_LIMITS = {"grad_gap": 0.03, "row_grad_gap": 0.01, "grad_sign_share": 0.015,
               "change_gap": 0.003}
#: the cell's per-layer metrics that read the host's clock, and so read on
#: the CPU too
HOST_CLOCK = ("train_mfu", "sample_ms.train", "step_host_ms.train")
TINY_MIX = {"log_every": 2, "checked_steps": 3, "warmup_steps": 4, "profile_steps": 2,
            "host_steps": 2}


def _config() -> dict:
    return json.loads((ROOT / CONFIG).read_text())


def make_tiny_granite(root) -> Catalog:
    """The benchmark's tiny tree with the Granite configuration and mix at
    toy size."""
    cat = make_tiny(root)
    cfg = _config()
    cfg["model"] = {k: v for k, v in cfg["model"].items()
                    if k not in ("d_model", "num_heads", "num_layers")} | TINY_GRANITE
    cfg["sampler"] = {"seq_length": 80, "batch_size": 1, "max_variants_per_window": 128}
    cfg["deployment"] = TINY_DEPLOYMENT
    cfg["limits"] = TINY_LIMITS
    (cat.root / CONFIG).write_text(json.dumps(cfg))
    path = cat.dir / "traffic" / "hybrid_lm_train.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), **TINY_MIX}))
    return Catalog(cat.root, cat.dir)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory) -> Catalog:
    return make_tiny_granite(tmp_path_factory.mktemp("tiny_granite"))


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_correct_at_toy_size(tiny, trace):
    out = run_cell(tiny, CELL, SEED, 0.3, trace, DEVICE)["result"]
    assert out["correct"] is True and out["attempted"] > 0 and out["failed"] == 0, out["checks"]
    assert set(out["checks"]) == {"windows", "nonfinite_losses", "grad_gap", "row_grad_gap",
                                  "grad_sign_share", "change_gap"}
    metrics = out["metrics"]
    if trace:
        # the CPU has no device clock: only the host-clock metrics read
        assert set(metrics) == set(HOST_CLOCK)
        assert 0 < metrics["train_mfu"]["value"] < 100
    else:
        assert set(metrics) == {"train_windows_per_s", "train_step_ms_p95", "setup_s"}
    json.dumps(out)


def test_the_references_scan_is_the_recurrence():
    """The paper's segment-sum form against ``S_t = exp(dt_t A) S_{t-1} +
    dt_t x_t B_t^T``, ``y_t = S_t C_t`` in float64 (the ``D x`` term is the
    caller's): four chunks, so states cross three boundaries."""
    g = torch.Generator().manual_seed(0)
    b, T, H, P, N, Q = 2, 32, 3, 4, 5, 8
    f64 = torch.float64
    x = torch.randn(b, T, H, P, generator=g, dtype=f64)
    dt = torch.rand(b, T, H, generator=g, dtype=f64) * 0.5
    A = -(0.1 + torch.rand(H, generator=g, dtype=f64))
    B, C = (torch.randn(b, T, N, generator=g, dtype=f64) for _ in range(2))
    y = ref.ssd(x * dt[..., None], dt * A, B, C, Q)
    state = torch.zeros(b, H, P, N, dtype=f64)
    for t in range(T):
        state = (torch.exp(dt[:, t, :, None, None] * A[:, None, None]) * state
                 + dt[:, t, :, None, None] * x[:, t, :, :, None] * B[:, t, None, None, :])
        want = torch.einsum("bhpn,bn->bhp", state, C[:, t])
        torch.testing.assert_close(y[:, t], want, rtol=1e-10, atol=1e-12)


def test_the_frozen_counts_at_toy_size_by_hand():
    """The count at hidden 8 by hand: 2 layers, one of each kind."""
    m = {"hidden_size": 8, "intermediate_size": 16, "num_attention_heads": 2,
         "num_key_value_heads": 1, "mamba_n_heads": 2, "mamba_d_head": 8, "mamba_d_state": 4,
         "mamba_n_groups": 1, "mamba_d_conv": 4, "mamba_expand": 2, "mamba_chunk_size": 4,
         "vocab_size": 10, "layer_types": ["mamba", "attention"]}
    L = 12
    mlp = 2 * 8 * 32 + 2 * 16 * 8  # input_linear to 2 x 16, output_linear
    # in_proj to z 16 + xBC 24 + dt 2; out_proj; conv 24 x 4 taps; the scan's
    # C B^T (2 Q N), masked product (2 Q H P), states and their use (2 x 2 H P N)
    mamba = 2 * 8 * 42 + 2 * 16 * 8 + 2 * 24 * 4 + 2 * 4 * 4 + 2 * 4 * 16 + 4 * 16 * 4
    # q 8, k and v 4 each, o 8; scores and weighted sum over L / 2 keys, 2 heads of 4
    attn = 2 * 8 * 16 + 2 * 8 * 8 + 2 * 2 * 6 * 2 * 4
    head = 2 * 8 * 10
    assert counts_granite.forward_flops_per_token(m, L) == 2 * mlp + mamba + attn + head
    assert counts_granite.train_flops_per_step(m, 3, L) == 3 * 6 * L * (2 * mlp + mamba + attn
                                                                       + head)
    # one call of the scan at (2, 8) tokens of 2 heads of 8, a state of 4,
    # chunks of 4: x and y 16 x 16 bf16, B and C 16 x 4 bf16, dt 16 x 2 float32,
    # A and D 2 float32 each; the backward reads dy and writes the gradients
    inputs = 16 * 16 * 2 + 2 * 16 * 4 * 2 + 16 * 2 * 4 + 2 * 2 * 4
    assert counts_granite.ssd_bytes(m, 1, 8, "fwd") == inputs + 16 * 16 * 2 == 1424
    assert counts_granite.ssd_bytes(m, 1, 8, "bwd") == 2 * inputs + 16 * 16 * 2 == 2336
    # 4 chunks: C B^T 2 x 4 x 4 x 4, and a head's masked product 2 x 4 x 4 x 8,
    # chunk state and the entering state's product 2 x 4 x 8 x 4 each
    fwd = 4 * (2 * 4 * 4 * 4 + 2 * (2 * 4 * 4 * 8 + 2 * 2 * 4 * 8 * 4))
    assert counts_granite.ssd_flops(m, 1, 8, "fwd") == fwd == 6656
    assert counts_granite.ssd_flops(m, 1, 8, "bwd") == 2 * fwd


@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_the_scan_rooflines_read_a_call_of_the_spans_against_its_bound(which):
    """The share is the call's bound over the span's device time a call:
    here a bound of 1 ms against 18 calls over 2 steps of 36 ms in all, 2 ms
    a call, 50%; None without the span, as the parent's program reads."""
    read = Catalog(ROOT, ROOT / "portbench").reader(f"ssd_{which}_roofline.granite")
    name = {"fwd": "hh.ssd_scan.forward", "bwd": "hh.ssd_scan.backward"}[which]
    bound = {f"ssd_{which}_bytes": 3.35e9, f"ssd_{which}_flops": 1}
    rec = {"spans": {"program": {name: 36.0}, "program_steps": 2},
           "counts": {f"ssd_{which}_calls_a_step": 9, **bound}}
    assert read(rec) == pytest.approx(50.0)
    rec["counts"] |= {f"ssd_{which}_bytes": 1, f"ssd_{which}_flops": 989e9 / 2}
    assert read(rec) == pytest.approx(25.0)
    assert read({"spans": {"program": {}, "program_steps": 2}, "counts": bound}) is None
    assert read({"spans": {}, "counts": bound}) is None

def test_the_model_object_keeps_the_published_widths():
    """The ``model`` object the loop builds from carries the published
    numbers of the file's top level: every width, head count, the state, the
    chunk and the vocabulary; the depth is the file's ``layer_types``."""
    cfg = _config()
    for k, v in cfg["model"].items():
        if k in cfg and k != "layer_types":
            assert cfg[k] == v, k
    assert cfg["model"]["layer_types"] == cfg["layer_types"]
    assert len(cfg["layer_types"]) == cfg["num_hidden_layers"] == 10
    assert cfg["layer_types"].count("attention") == 1 and cfg["layer_types"][5] == "attention"
    assert set(cfg["reduced"]) == {"num_hidden_layers", "layer_types", "depth", "deployment",
                                   "batch"}
