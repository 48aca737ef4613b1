"""The device-resident sampler: ``sample_chain(n_chain, n_batches, key)`` in a
closed loop, each call's digest fetched to the host (the fetch proves every
link ran), every call under a key of its own.

The mix file gives ``n_chain`` and ``n_batches`` (a link encodes ``n_batches
* B`` windows), ``warmup_calls`` (the first captures the chain's CUDA graph),
``checked_calls`` (calls of the window drawn from the seed whose digests
the reference recomputes; the first of them is run again after the window
through ``chain_run``, and its keys and last link are compared too),
``profile_calls`` (calls under the profiler in a traced run, right after
set-up) and ``replay_calls`` (calls timed by CUDA events in a traced run).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import common, counts, trace
from portbench.checks import Check, mismatches
from portbench.reference import sampler as ref_sampler
from portbench.state import make_state

MASK32 = 0xFFFFFFFF
#: the second key word of warm-up calls: no call of the window shares one
WARMUP_WORD = 1 << 31


def call_key(seed: int, i: int) -> np.ndarray:
    """The two key words of call ``i`` of the run of ``seed``."""
    return np.array([seed & MASK32, i & MASK32], dtype=np.uint32)


def run(ctx) -> dict:
    cfg, mix, dev, split = ctx.cfg, ctx.mix, ctx.device, ctx.split
    s = cfg["sampler"]
    L, B, K = s["seq_length"], s["batch_size"], s["max_variants_per_window"]
    n_chain, n_batches = mix["n_chain"], mix["n_batches"]
    split("build", common.build_kernels, dev)
    state = split("state", make_state, cfg["deployment"], ctx.seed, dev)
    sampler = split("sampler_index", common.sampler, state, cfg, ctx.seed, dev)

    def call(key) -> int:
        return int(sampler.sample_chain(n_chain, n_batches, key=key))

    def warm():
        for j in range(mix["warmup_calls"]):
            call(call_key(ctx.seed, WARMUP_WORD + j))

    split("warmup", warm)
    setup_s = time.perf_counter() - ctx.t0
    common.log(split.line())

    rec: dict = {"spans": {}, "counts": {}, "events": {}}
    if ctx.trace:
        rec["profile"] = trace.capture(
            lambda i: call(call_key(ctx.seed, WARMUP_WORD + mix["warmup_calls"] + i)),
            mix["profile_calls"], lambda: common.sync(dev))

    # the window
    digests = []
    common.sync(dev)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        digests.append(call(call_key(ctx.seed, len(digests))))
    common.sync(dev)
    window_s = time.perf_counter() - t0
    calls = len(digests)
    per_call = n_chain * n_batches * B
    peak = common.memory_peak(dev)
    common.log(f"window: {calls} calls of {per_call} windows in {window_s:.4f} s, "
               f"{calls * per_call / window_s:.4f} windows/s")
    rec["counts"] = {"calls": calls, "window_s": window_s, "links": calls * n_chain,
                     "link_bytes": counts.link_bytes(
                         n_batches * B, L, n_batches * B * L * cfg["deployment"]["snv_per_bp"])}

    if ctx.trace and dev.type == "cuda":
        n = mix["replay_calls"]
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for j in range(n):
            sampler.sample_chain(n_chain, n_batches, key=call_key(ctx.seed, j))
        b.record()
        b.synchronize()
        rec["events"]["replays_ms"] = (a.elapsed_time(b), n * n_chain)

    # the calls the reference recomputes, drawn from the seed; the first of
    # them run again whole, its keys and last link kept
    rng = np.random.default_rng(ctx.seed)
    picked = [int(i) for i in rng.choice(calls, size=min(mix["checked_calls"], calls),
                                         replace=False)]
    again = sampler.chain_run(n_chain, n_batches, key=call_key(ctx.seed, picked[0]))
    again = (again.keys.cpu(), *(t.reshape(-1, *t.shape[2:]).cpu() for t in (
        again.last.hap1_codes, again.last.hap2_codes, again.last.n_variants,
        again.last.overflow)))
    sampler = None
    common.release(dev)

    wrong = 0
    for n_i, i in enumerate(picked):
        want = ref_sampler.chain(state, tuple(int(w) for w in call_key(ctx.seed, i)),
                                 n_chain, n_batches, B, L, K, dev)
        wrong += digests[i] != want.digest
        if n_i == 0:
            last = mismatches(zip(again, (want.keys, *want.last)))
    checks = [Check("digests", wrong, 0, f"{len(picked)} of {calls} calls"),
              Check("last_link", last, 0, f"call {picked[0]}: keys and windows")]
    return {
        "setup_s": setup_s,
        "end_to_end": {"chain_windows_per_s": calls * per_call / window_s},
        "attempted": calls, "failed": wrong, "memory_peak_bytes": peak,
        "checks": checks, "rec": rec,
    }
