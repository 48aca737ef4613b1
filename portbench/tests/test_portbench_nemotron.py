"""The Nemotron-H hybrid cell at toy size on the CPU: its configuration's
schema, its run, checks and result line, each injected fault caught by a
named check, the reference's grouped scan against the recurrence, the counts
against a hand count, and the new readers on recorded dicts.  The model
against the reference has its tests in ``tests/test_torch_nemotron_h.py``."""

import contextlib
import json

import pytest
import torch

from portbench import common, counts_nemotron
from portbench.catalog import Catalog
from portbench.loops import moe_hybrid_lm_train as loop
from portbench.readings_nemotron import FAULTS, numbers
from portbench.reference import nemotron_h as ref
from portbench.run import run_cell
from portbench.state import make_state
from portbench.tests.conftest import DEVICE, ROOT, SEED, TINY_DEPLOYMENT, make_tiny

CELL = "nemotron-moe-pair-train"
CONFIG = "portbench/configs/nemotron-3-nano-30b-a3b-dna-8k.json"
#: the published stage-1 pattern at toy widths: hidden 64, 8 Mamba-2 heads
#: of 16 in 2 groups with a state of 16 in chunks of 16, 8 routed experts
#: (4 held) top 3, 4 query and 2 key heads of 32, a 128-row vocabulary,
#: 80-bp windows
TINY_NEMOTRON = {"hidden_size": 64, "moe_intermediate_size": 48,
                 "moe_shared_expert_intermediate_size": 96, "mamba_num_heads": 8,
                 "mamba_head_dim": 16, "ssm_state_size": 16, "n_groups": 2, "chunk_size": 16,
                 "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 32,
                 "n_routed_experts": 8, "num_experts_per_tok": 3, "vocab_size": 128,
                 "experts_held": [0, 4], "loss_chunk": 64}
#: toy-size limits: bf16 on the CPU against float32 reads at most 0.024,
#: 0.0028, 0.0082, 0.0006 and 0.0094 over six seeds; the fp8 control 0.23,
#: 0.060, 0.12, 0.0046 and 0.086
TINY_LIMITS = {"grad_gap": 0.05, "row_grad_gap": 0.01, "grad_sign_share": 0.015,
               "change_gap": 0.002, "route_mismatch_share": 0.03}
#: the check that catches each fault at toy size (two seeds read it at 4x
#: or more of its limit)
CAUGHT_BY = {"half_batch": "row_grad_gap", "bias_ignored": "route_mismatch_share",
             "softmax_router": "grad_gap", "no_renorm": "grad_gap", "scale_one": "grad_gap",
             "expert_dropped": "grad_gap", "scan_one_group": "grad_sign_share",
             "norm_whole_row": "grad_gap"}
HOST_CLOCK = ("train_mfu", "sample_ms.train", "step_host_ms.train")
TINY_MIX = {"log_every": 2, "checked_steps": 3, "warmup_steps": 4, "profile_steps": 2,
            "host_steps": 2}
#: the published numbers of ``config.json`` the file keeps at its top level
PUBLISHED = {"hidden_size": 2688, "intermediate_size": 1856, "moe_intermediate_size": 1856,
             "moe_shared_expert_intermediate_size": 3712, "mamba_num_heads": 64,
             "mamba_head_dim": 64, "ssm_state_size": 128, "n_groups": 8, "conv_kernel": 4,
             "chunk_size": 128, "expand": 2, "num_attention_heads": 32,
             "num_key_value_heads": 2, "head_dim": 128, "num_experts_per_tok": 6,
             "n_shared_experts": 1, "routed_scaling_factor": 2.5, "layer_norm_epsilon": 1e-5,
             "norm_eps": 1e-5, "max_position_embeddings": 262144, "rope_theta": 10000,
             "time_step_min": 0.001, "time_step_max": 0.1, "time_step_floor": 0.0001}


def _config() -> dict:
    return json.loads((ROOT / CONFIG).read_text())


def make_tiny_nemotron(root) -> Catalog:
    """The benchmark's tiny tree with the Nemotron-H configuration and mix
    at toy size."""
    cat = make_tiny(root)
    cfg = _config()
    cfg["model"] = {k: v for k, v in cfg["model"].items()
                    if k not in ("d_model", "num_heads", "num_layers")} | TINY_NEMOTRON
    cfg["sampler"] = {"seq_length": 80, "batch_size": 1, "max_variants_per_window": 128}
    cfg["deployment"] = TINY_DEPLOYMENT
    cfg["limits"] = TINY_LIMITS
    (cat.root / CONFIG).write_text(json.dumps(cfg))
    path = cat.dir / "traffic" / "moe_hybrid_lm_train.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), **TINY_MIX}))
    return Catalog(cat.root, cat.dir)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory) -> Catalog:
    return make_tiny_nemotron(tmp_path_factory.mktemp("tiny_nemotron"))


def test_the_configuration_keeps_the_published_widths():
    """Every published width, head count, the state, groups, chunk, top-k and
    scale at the top level and in the ``model`` object the loop builds from;
    what is cut is in ``reduced``; the stage is the published pattern's
    first 13 layers."""
    cfg = _config()
    for k, v in PUBLISHED.items():
        assert cfg[k] == v, k
        if k in cfg["model"]:
            assert cfg["model"][k] == v, k
    assert set(cfg["reduced"]) == {"num_hidden_layers", "hybrid_override_pattern", "depth",
                                   "n_routed_experts", "vocab_size", "deployment", "batch"}
    assert cfg["hybrid_override_pattern"] == cfg["model"]["hybrid_override_pattern"] \
        == "MEMEM*EMEMEM*"
    assert cfg["num_hidden_layers"] == 13 and cfg["published"]["num_hidden_layers"] == 52
    assert cfg["published"]["hybrid_override_pattern"].startswith("MEMEM*EMEMEM*EMEMEM*")
    # the router keeps all 128 experts; the card holds 16
    assert cfg["model"]["n_routed_experts"] == 128 and cfg["n_routed_experts"] == 16
    assert cfg["model"]["experts_held"] == [0, 16]
    assert cfg["vocab_size"] == cfg["model"]["vocab_size"] == 16384
    assert max(cfg["model"]["token_ids"]) < 16384
    assert cfg["sampler"] == {"seq_length": 8192, "batch_size": 2, "max_variants_per_window": 128}
    assert set(cfg["limits"]) == set(TINY_LIMITS)


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_correct_at_toy_size(tiny, trace):
    out = run_cell(tiny, CELL, SEED, 0.3, trace, DEVICE)["result"]
    assert out["correct"] is True and out["attempted"] > 0 and out["failed"] == 0, out["checks"]
    assert set(out["checks"]) == {"windows", "nonfinite_losses", "grad_gap", "row_grad_gap",
                                  "grad_sign_share", "change_gap", "route_mismatch_share"}
    metrics = out["metrics"]
    if trace:
        # the CPU has no device clock: only the host-clock metrics read
        assert set(metrics) == set(HOST_CLOCK)
        assert 0 < metrics["train_mfu"]["value"] < 100
    else:
        assert set(metrics) == {"train_windows_per_s", "train_step_ms_p95", "setup_s"}
    json.dumps(out)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_fault_is_caught_at_toy_size(tiny, fault):
    """The program with one piece of its arithmetic wrong fails its named
    check, where the sound program on the same seed passes every one."""
    cfg = tiny.config(tiny.cell(CELL)["config"])
    seed = 1
    state = make_state(cfg["deployment"], seed, DEVICE)
    init = ref.init(cfg["model"], seed, DEVICE)
    failed = {}
    for what in ("program", fault):
        sampler = common.sampler(state, cfg, seed, DEVICE)
        ts = loop.program_model(cfg, loop.model_config(cfg), init, seed, DEVICE)
        from haplohyped_tpu_torch.models.train import make_fused_train_step

        with FAULTS[what]() if what != "program" else contextlib.nullcontext():
            ts, prog, _ = loop.first_steps(3, sampler, ts, init, make_fused_train_step(sampler))
        _, want = loop.reference_steps(cfg, state, seed, 3, init, DEVICE,
                                       selections=prog["selections"])
        failed[what] = numbers(cfg, prog, want)["failed"]
    assert failed["program"] == []
    assert CAUGHT_BY[fault] in failed[fault], failed


def test_the_fp8_control_fails_at_toy_size(tiny):
    cfg = tiny.config(tiny.cell(CELL)["config"])
    state = make_state(cfg["deployment"], 1, DEVICE)
    init = ref.init(cfg["model"], 1, DEVICE)
    _, low = loop.reference_steps(cfg, state, 1, 3, init, DEVICE, precision="fp8")
    _, want = loop.reference_steps(cfg, state, 1, 3, init, DEVICE, selections=low["used"])
    low["selections"] = low["used"]
    assert {"grad_gap", "grad_sign_share", "route_mismatch_share"} <= set(
        numbers(cfg, low, want)["failed"])


def test_the_route_mismatch_share_counts_slots_not_in_the_reference():
    want = [{1: torch.tensor([[0, 1, 2], [3, 4, 5]])}]
    assert loop.route_mismatch_share(want, want, 8) == 0
    # one slot of one token another expert, the order of a token's slots free
    got = [{1: torch.tensor([[2, 1, 0], [3, 4, 7]])}]
    assert loop.route_mismatch_share(got, want, 8) == pytest.approx(1 / 6)
    # a layer or a step the program lacks counts every slot
    assert loop.route_mismatch_share([{}], want, 8) == 1
    assert loop.route_mismatch_share([], want, 8) == 1


def test_the_references_grouped_scan_is_the_recurrence():
    """The paper's segment-sum form with 2 groups of ``B`` and ``C`` shared
    by 2 heads each against the recurrence in float64, four chunks."""
    g = torch.Generator().manual_seed(0)
    b, T, H, P, N, G, Q = 2, 32, 4, 3, 5, 2, 8
    f64 = torch.float64
    x = torch.randn(b, T, H, P, generator=g, dtype=f64)
    dt = torch.rand(b, T, H, generator=g, dtype=f64) * 0.5
    A = -(0.1 + torch.rand(H, generator=g, dtype=f64))
    B, C = (torch.randn(b, T, G, N, generator=g, dtype=f64) for _ in range(2))
    y = ref.ssd(x * dt[..., None], dt * A, B, C, Q)
    state = torch.zeros(b, H, P, N, dtype=f64)
    Bh, Ch = B.repeat_interleave(H // G, 2), C.repeat_interleave(H // G, 2)
    for t in range(T):
        state = (torch.exp(dt[:, t, :, None, None] * A[:, None, None]) * state
                 + dt[:, t, :, None, None] * x[:, t, :, :, None] * Bh[:, t, :, None, :])
        want = torch.einsum("bhpn,bhn->bhp", state, Ch[:, t])
        torch.testing.assert_close(y[:, t], want, rtol=1e-10, atol=1e-12)


def test_the_counts_at_toy_size_by_hand():
    """At hidden 8: one layer of each kind, 2 groups, chunks of 4."""
    m = {"hidden_size": 8, "moe_intermediate_size": 6, "moe_shared_expert_intermediate_size": 12,
         "mamba_num_heads": 4, "mamba_head_dim": 2, "ssm_state_size": 3, "n_groups": 2,
         "conv_kernel": 4, "chunk_size": 4, "num_attention_heads": 2, "num_key_value_heads": 1,
         "head_dim": 4, "n_routed_experts": 5, "experts_held": [0, 2], "vocab_size": 10,
         "hybrid_override_pattern": "ME*"}
    L = 12
    # in_proj to z 8 + xBC 8 + 12 + dt 4; out_proj; conv 20 x 4 taps; the scan's
    # C B^T a group (2 Q G N), masked product (2 Q H P), states and their use
    mamba = 2 * 8 * 32 + 2 * 8 * 8 + 2 * 20 * 4 + 2 * 4 * 2 * 3 + 2 * 4 * 8 + 4 * 8 * 3
    # the router over 5 experts, the shared expert up and down
    moe = 2 * 8 * 5 + 2 * 2 * 8 * 12
    # q 8, k and v 4 each, o 8; scores and weighted sum over L / 2 keys
    attn = 2 * 8 * 16 + 2 * 8 * 8 + 2 * 2 * 6 * 2 * 4
    head = 2 * 8 * 10
    assert counts_nemotron.dense_flops_per_token(m, L) == mamba + moe + attn + head
    assert counts_nemotron.experts_flops(m, 7) == 2 * 2 * 7 * 8 * 6
    assert counts_nemotron.train_flops_per_step(m, 3, L, 7) == 3 * (
        6 * L * (mamba + moe + attn + head) + 2 * 2 * 7 * 8 * 6)
    # 7 rows: bf16 rows in and out, float32 weights 2 x 2 x 6 x 8, bf16 hidden twice
    assert counts_nemotron.experts_bytes(m, 7) == 2 * 7 * 8 + 4 * 2 * 2 * 6 * 8 \
        + 2 * 2 * 7 * 6 + 2 * 7 * 8
    # the scan at (2, 8) tokens: x and y 16 x 8 bf16, B and C 16 x 2 x 3 bf16,
    # dt 16 x 4 float32, A and D 4 float32 each
    inputs = 16 * 8 * 2 + 2 * 16 * 6 * 2 + 16 * 4 * 4 + 2 * 4 * 4
    assert counts_nemotron.ssd_bytes(m, 1, 8, "fwd") == inputs + 16 * 8 * 2
    assert counts_nemotron.ssd_bytes(m, 1, 8, "bwd") == 2 * inputs + 16 * 8 * 2
    fwd = 4 * (2 * 2 * 4 * 4 * 3 + 4 * (2 * 4 * 4 * 2 + 2 * 2 * 4 * 2 * 3))
    assert counts_nemotron.ssd_flops(m, 1, 8, "fwd") == fwd
    assert counts_nemotron.ssd_flops(m, 1, 8, "bwd") == 2 * fwd


def test_the_readers_on_a_recorded_dict():
    """Each new reader on a recorded dict, and None without its spans, as
    the parent's program reads."""
    cat = Catalog(ROOT, ROOT / "portbench")
    spans = {"hh.nemotron.moe": 40.0, "hh.moe.route": 6.0, "hh.moe.combine": 4.0,
             "hh.moe.experts": 30.0, "hh.ssd_scan.forward": 12.0, "hh.ssd_scan.backward": 36.0}
    rec = {"spans": {"program": spans, "program_steps": 2},
           "counts": {"experts_calls": 10, "experts_fwd_bytes": 3.35e9, "experts_fwd_flops": 1,
                      "ssd_fwd_calls_a_step": 6, "ssd_bwd_calls_a_step": 6,
                      "ssd_fwd_bytes": 3.35e9, "ssd_fwd_flops": 1,
                      "ssd_bwd_bytes": 1, "ssd_bwd_flops": 989e9 * 3}}
    read = {k: cat.reader(k)(rec) for k in (
        "moe_fwd_device_ms.nemotron", "route_fwd_device_ms.nemotron",
        "experts_fwd_roofline.nemotron", "ssd_fwd_roofline.nemotron",
        "ssd_bwd_roofline.nemotron")}
    # a call of the experts 3 ms against a 1-ms bound; the scan's forward
    # 1 ms a call against 1 ms, its backward 3 ms against 3 ms
    assert read == pytest.approx({"moe_fwd_device_ms.nemotron": 20.0,
                                  "route_fwd_device_ms.nemotron": 5.0,
                                  "experts_fwd_roofline.nemotron": 100 / 3,
                                  "ssd_fwd_roofline.nemotron": 100.0,
                                  "ssd_bwd_roofline.nemotron": 100.0})
    empty = {"spans": {"program": {}, "program_steps": 2}, "counts": rec["counts"]}
    for k in read:
        assert cat.reader(k)(empty) is None, k
        assert cat.reader(k)({"spans": {}, "counts": {}}) is None, k
