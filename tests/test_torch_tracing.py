"""The port's spans (``core/profiling.py``) on the CPU: the tree a recorded
fused step gives, the shared no-op when nothing listens, the spans among a
profiler's events, nothing recorded while a stream captures, the set-up's
spans (the sampler, its index, the model, a kernel's first load) and the
data-parallel step's exchange over gloo."""

import dataclasses
import threading
import time
import uuid

import pytest
import torch
import torch.distributed as dist

from haplohyped_tpu_torch.core import profiling
from haplohyped_tpu_torch.core.config import MeshConfig
from haplohyped_tpu_torch.core.profiling import annotate, recording
from haplohyped_tpu_torch.data.sampler import DeviceHaplotypeSampler
from haplohyped_tpu_torch.models import train
from haplohyped_tpu_torch.ops import _build
from haplohyped_tpu_torch.parallel import make_mesh

#: (span, parent) of one fused step, in the order the spans open
FUSED_TREE = [
    ("hh.train.fused_step", None),
    ("hh.sampler.batch", "hh.train.fused_step"),
    ("hh.train.step", "hh.train.fused_step"),
    ("hh.train.forward", "hh.train.step"),
    ("hh.train.backward", "hh.train.step"),
    ("hh.train.optimizer", "hh.train.step"),
]


@pytest.fixture
def fused():
    """A CPU sampler, a small model's train state and its fused step."""
    from tests.test_torch_train import SMALL, cpu_sampler

    sampler = cpu_sampler(seed=3)
    first = sampler.sample()
    state = train.create_train_state(SMALL, (first.hap1, first.hap2), seed=1, device="cpu")
    return sampler, state, train.make_fused_train_step(sampler)


def _tree(rows):
    return [(r["name"], None if r["parent"] is None else rows[r["parent"]]["name"])
            for r in rows]


def test_recorded_fused_step_gives_the_span_tree(fused):
    _, state, step = fused
    with recording() as rec:
        state, _ = step(state, 1)
        state, _ = step(state, 2)
    rows = rec.rows()
    assert _tree(rows) == FUSED_TREE * 2
    for s in rec.spans:  # each inside its parent, siblings one after another
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            assert s.parent.start_ns <= s.start_ns and s.end_ns <= s.parent.end_ns
    for a, b in zip(rec.spans, rec.spans[1:]):
        if b.parent is a.parent:
            assert a.end_ns <= b.start_ns
    for i, r in enumerate(rows):
        kids = [c["host_ms"] for c in rows if c["parent"] == i]
        assert r["self_host_ms"] == pytest.approx(r["host_ms"] - sum(kids), abs=1e-9)
        assert r["self_host_ms"] >= 0 and r["device_ms"] is None  # no card: no events
    assert all(r["attrs"] == {} for r in rows)
    totals = rec.totals()
    assert list(totals) == [name for name, _ in FUSED_TREE]
    assert all(t["calls"] == 2 and t["device_ms"] is None for t in totals.values())
    fs = totals["hh.train.fused_step"]
    assert fs["host_ms"] == pytest.approx(sum(r["host_ms"] for r in rows[::6]))
    assert fs["self_host_ms"] == pytest.approx(
        fs["host_ms"] - totals["hh.sampler.batch"]["host_ms"] - totals["hh.train.step"]["host_ms"])


def test_self_time_is_the_duration_less_the_children():
    with recording() as rec:
        with annotate("outer", n=3):
            time.sleep(0.004)
            with annotate("inner"):
                time.sleep(0.006)
            with annotate("inner"):
                with annotate("leaf"):
                    time.sleep(0.002)
    rows = rec.rows()
    assert _tree(rows) == [("outer", None), ("inner", "outer"), ("inner", "outer"),
                           ("leaf", "inner")]
    assert rows[0]["attrs"] == {"n": 3}
    assert rows[0]["self_host_ms"] == pytest.approx(
        rows[0]["host_ms"] - rows[1]["host_ms"] - rows[2]["host_ms"])
    assert rows[0]["self_host_ms"] >= 4.0 and rows[1]["self_host_ms"] >= 6.0
    assert rows[2]["self_host_ms"] == pytest.approx(rows[2]["host_ms"] - rows[3]["host_ms"])
    assert rec.totals()["inner"]["calls"] == 2


def test_off_is_the_shared_noop_and_enters_nothing(fused, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("entered while tracing is off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert annotate("hh.a") is annotate("hh.b", bytes=4) is profiling._OFF
    with annotate("hh.a") as span:
        assert span is None
    _, state, step = fused
    state, metrics = step(state, 1)  # every span of the step stays off
    assert torch.isfinite(metrics["loss"])


def test_a_running_profiler_sees_the_spans(fused):
    _, state, step = fused
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(state, 1)
    names = {e.name for e in prof.events()}
    assert {name for name, _ in FUSED_TREE} <= names


def test_spans_record_nothing_while_the_stream_captures(fused, monkeypatch):
    """A captured region runs no Python when it replays, so a span opened
    while capturing neither records nor enters the profiler."""
    sampler = fused[0]

    def refuse(*a, **k):
        raise AssertionError("entered while capturing")

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with recording() as rec:
        assert annotate("hh.a") is profiling._OFF
        sampler.batch_at(3)
    assert rec.spans == [] and rec.rows() == []
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert annotate("hh.a") is profiling._OFF
        sampler.batch_at(3)


def test_set_up_spans(fused):
    """The sampler's init with its index as a child, the model's state, the
    chain's call (eager on the CPU: no capture span)."""
    from tests.test_torch_train import SMALL

    sampler = fused[0]
    config = dataclasses.replace(sampler.config, window_kernel="kernel")  # index in init
    with recording() as rec:
        s = DeviceHaplotypeSampler(sampler.genome, sampler.cohort, sampler._regions.numpy(),
                                   config, device="cpu")
        first = s.sample()
        train.create_train_state(SMALL, (first.hap1, first.hap2), device="cpu")
        s.sample_chain(2, 1, key=5)
        s.chain_run(2, 1, key=5)
    assert _tree(rec.rows()) == [
        ("hh.sampler.init", None), ("hh.sampler.index", "hh.sampler.init"),
        ("hh.sampler.batch", None), ("hh.train.create_state", None),
        ("hh.sampler.chain", None), ("hh.sampler.chain", None)]
    with recording() as rec:
        s.index  # built once: a later read opens no span
    assert rec.spans == []


def test_a_cached_kernel_load_records_no_span(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("")
    loaded = []
    monkeypatch.setattr(_build, "_kernel_sources", lambda name: [src])
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "build_shared_library", lambda *a, **k: tmp_path / "k.so")
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: loaded.append(path) or path)
    name = f"hh_span_test_{uuid.uuid4().hex}"  # a name no other call has cached
    with recording() as rec:
        _build.load_kernel(name)
        _build.load_kernel(name)
    rows = rec.rows()
    assert [(r["name"], r["attrs"]) for r in rows] == [("hh.build.load_kernel", {"kernel": name})]
    assert len(loaded) == 1


def test_spans_of_another_thread_take_no_parent_from_this_one():
    seen = []

    def work():
        with annotate("worker"):
            seen.append(profiling._stack()[-1].parent)

    with recording() as rec:
        with annotate("main"):
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    assert seen == [None]
    assert sorted(_tree(rec.rows())) == [("main", None), ("worker", None)]


def test_recording_closes_and_restores_the_outer_one():
    with recording() as outer:
        with recording() as inner:
            with annotate("a"):
                pass
        with annotate("b"):
            pass
    assert annotate("c") is profiling._OFF
    assert [s.name for s in inner.spans] == ["a"] and [s.name for s in outer.spans] == ["b"]


def test_the_data_parallel_exchange_is_a_span_with_its_bytes():
    """A step on a one-rank gloo mesh: one ``hh.parallel.allreduce`` a step,
    inside ``hh.train.step`` between the backward and the optimiser, its
    ``bytes`` the flat buffer of every gradient and the three metrics."""
    from tests.test_torch_train import SMALL, cpu_sampler

    assert not dist.is_initialized()
    mesh = make_mesh(MeshConfig(1, 1), device="cpu")
    try:
        sampler = cpu_sampler(seed=4)
        first = sampler.sample()
        state = train.create_train_state(SMALL, (first.hap1, first.hap2), seed=1,
                                         device="cpu", mesh=mesh)
        step = train.make_fused_train_step(sampler, mesh)
        with recording() as rec:
            for i in (1, 2):
                state, _ = step(state, i)
    finally:
        dist.destroy_process_group()
    rows = rec.rows()
    want = 4 * (sum(p.numel() for p in state.model.parameters()) + 3)
    ex = [(i, r) for i, r in enumerate(rows) if r["name"] == "hh.parallel.allreduce"]
    assert len(ex) == 2
    for i, r in ex:
        assert r["attrs"] == {"bytes": want}
        assert rows[r["parent"]]["name"] == "hh.train.step"
        assert (rows[i - 1]["name"], rows[i + 1]["name"]) == ("hh.train.backward",
                                                              "hh.train.optimizer")


#: (span, parent) of one Enformer fused step, in the order the spans open
ENFORMER_TREE = [
    ("hh.train.fused_step", None),
    ("hh.sampler.batch", "hh.train.fused_step"),
    ("hh.train.targets", "hh.train.fused_step"),
    ("hh.train.step", "hh.train.fused_step"),
    ("hh.train.forward", "hh.train.step"),
    ("hh.enformer.stem", "hh.train.forward"),
    ("hh.enformer.conv_tower", "hh.train.forward"),
    ("hh.enformer.transformer", "hh.train.forward"),
    ("hh.enformer.head", "hh.train.forward"),
    ("hh.train.backward", "hh.train.step"),
    ("hh.train.clip", "hh.train.step"),
    ("hh.train.optimizer", "hh.train.step"),
]


def test_an_enformer_step_records_its_spans_where_they_belong():
    """The model's four stages inside the forward, the clip between the
    backward and the optimiser, the targets after the sampler's batch."""
    from tests.test_torch_enformer import B, CFG, L
    from tests.test_torch_train import cpu_sampler

    sampler = cpu_sampler(L=L, batch_size=B, seed=6)
    x = torch.zeros((B, L), dtype=torch.int8)
    state = train.create_train_state(CFG, (x, x), 5e-4, seed=3, device="cpu")
    y = torch.ones((B, CFG.target_length, CFG.num_tracks))
    step = train.make_fused_train_step(sampler, targets=lambda i, b: y)
    with recording() as rec:
        for i in (0, 1):
            state, _ = step(state, i)
    assert _tree(rec.rows()) == ENFORMER_TREE * 2
    for s in rec.spans:
        if s.parent is not None:
            assert s.parent.start_ns <= s.start_ns and s.end_ns <= s.parent.end_ns


def test_the_enformer_readers_on_a_cpu_run_and_on_nothing(tmp_path):
    """A traced CPU run of the Enformer cell at toy size: the host-clock
    metrics (the step's share of the peak, the sampler's and the step's
    host ms) read numbers; the span and kernel readers, whose numbers are
    the card's device times, read none on the CPU, and none with nothing
    recorded; each reads its number from a record that holds one."""
    from portbench.run import run_cell
    from portbench.tests.conftest import DEVICE, SEED
    from portbench.tests.test_portbench_enformer import CELL, HOST_CLOCK, make_tiny_enformer

    cat = make_tiny_enformer(tmp_path)
    out = run_cell(cat, CELL, SEED, 0.2, True, DEVICE)["result"]
    assert out["correct"] and all(out["metrics"][k]["value"] > 0 for k in HOST_CLOCK)
    device_metrics = ("tower_fwd_device_ms.enformer", "transformer_fwd_device_ms.enformer",
                      "window_roofline.enformer")
    assert not set(device_metrics) & set(out["metrics"])
    rec = {"spans": {"program": {"hh.enformer.stem": 3.0, "hh.enformer.conv_tower": 9.0,
                                 "hh.enformer.transformer": 5.0}, "program_steps": 2},
           "counts": {"window_bytes": 3.35e6},
           "profile": {"device": [("void (anonymous namespace)::window_kernel<4>(...)", 0, 10),
                                  ("void (anonymous namespace)::window_kernel<4>(...)", 20, 30),
                                  ("lab_kernel_variant<0, 1>", 0, 1), ("gemm", 0, 5)]}}
    assert cat.reader("tower_fwd_device_ms.enformer")(rec) == 6.0
    assert cat.reader("transformer_fwd_device_ms.enformer")(rec) == 2.5
    # 3.35 MB in 10 us a launch at 3.35 TB/s: 10% of the bound
    assert cat.reader("window_roofline.enformer")(rec) == pytest.approx(10.0)
    for name in device_metrics + HOST_CLOCK:
        assert cat.reader(name)({"spans": {}, "counts": {}}) is None


def test_the_frozen_enformer_count_is_a_hand_count():
    """``portbench/counts_enformer.py`` at the small size against the
    model's multiply-adds written out layer by layer."""
    from portbench.counts_enformer import train_flops_per_step
    from tests.test_torch_enformer import B, CFG, HEADS, M

    L, C, H, K, V, R = 8192, 64, 2, 8, 32, 12
    filters = [32, 32, 48, 48, 48, 64]  # exponential_linspace_int(32, 64, 6, 16)
    mac = L * 15 * 4 * 32 + 2 * L * 32 * 32  # stem conv; pointwise conv and pool logits
    n, c = L // 2, 32
    for f in filters:
        mac += n * 5 * c * f + 2 * n * f * f
        n, c = n // 2, f
    T = n
    attn = (T * C * H * (2 * K + V) + H * T * T * K + H * T * (2 * T - 1) * K + H * T * T * V
            + T * H * V * C)
    mac += 2 * (attn + 2 * T * C * 2 * C)  # 2 blocks
    mac += 32 * C * 2 * C + 32 * 2 * C * 7  # final pointwise conv, head
    per_forward = 2 * B * mac + 2 * (2 * T - 1) * R * H * K  # relative keys, batch-free
    assert CFG.filter_list == filters and T == 64
    assert train_flops_per_step(M, HEADS, B) == 3 * 2 * per_forward
