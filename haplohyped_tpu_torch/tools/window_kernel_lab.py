"""The window-kernel lab: where the Hopper window kernel's time goes.

    python -m haplohyped_tpu_torch.tools.window_kernel_lab [--device cuda]
        [--seed N] [--state lab|deployment] [--out PATH]
        [--batch B] [--n-chain N] [--iters N]

The counterpart of the JAX package's ``tools/window_kernel_lab.py``.  Rows:

- ``prod``: the production kernel, ``csrc/window_kernel.cu`` (one window a
  block; it has no ``w``);
- ``{full,dma_only,compute_only}_w{1,8,32}``: the lab kernel
  (``csrc/window_kernel_lab.cu``, :mod:`haplohyped_tpu_torch.ops.window_lab`)
  at 1, 8 and 32 windows a block: the encode, its loads without the
  substitution, and its substitution without the loads.

Each row chains ``n_chain`` encodes of ``B`` windows: each link's windows
feed the next link's starts (``st <- (st + (digest & 0x7FFF) + 1) % (Lc - L -
8)``, the digest the sum of every ``hap1`` byte plus ``n_variants``) and
donors (``di <- (di + 1) % D``), so no link can be skipped or reordered.  On
the card the links are captured once in one CUDA graph and replayed; every
call continues the chain from the last one's starts and ends in one
device-to-host fetch of ``st[0]``.  A row reports the median host seconds a
call over ``--iters`` calls, windows/s and µs per window, and on the card the
device ms a launch (CUDA events, back to back behind a sleep kernel) and the
least time the card could take for the same bytes.

``--state lab`` is the JAX lab's fixture (a 10 Mb genome, 8 donors x 100,000
SNVs on one chromosome, from ``numpy.random.default_rng(1)``); ``--state
deployment`` is chr1 of :func:`~.deployment.make_state` (GRCh38 chr1-chr12,
128 donors).  Window starts and donors come from ``--seed``.  The JSON
result goes to stdout and, with ``--out``, to that file.  ``--device cpu``
runs the plain versions: a check of the path, with no device times.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time

import numpy as np
import torch

from haplohyped_tpu_torch.core.config import resolve_device
from haplohyped_tpu_torch.core.timing import HBM_BYTES_PER_S, card_line, device_ms
from haplohyped_tpu_torch.ops.window_kernel import (
    build_window_index,
    encode_windows_kernel,
    window_slice,
)
from haplohyped_tpu_torch.ops.window_lab import VARIANTS, encode_windows_lab
from haplohyped_tpu_torch.tools.deployment import make_state

#: the JAX lab's shape
LAB_B, LAB_L, LAB_K, LAB_N_CHAIN = 2048, 1000, 64, 16
#: windows per block the rows sweep
LAB_WS = (1, 8, 32)
#: the JAX lab's fixture seed and size
FIXTURE_SEED = 1
FIXTURE_LC, FIXTURE_D, FIXTURE_V = 10_000_000, 8, 100_000
METHOD = ("chained starts-from-digest, one CUDA graph of n_chain links a call "
          "(eager links on the CPU) + d2h fetch of st[0]")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def build_fixture(seed: int = FIXTURE_SEED, device="cuda"):
    """The JAX lab's fixture, draw for draw: a 10 Mb genome and 8 donors x
    100,000 SNVs on one chromosome.  REF, ALT and the phases are int8, the
    port's types.  Returns ``(index, Lc, D)``: the production kernel's
    :class:`~haplohyped_tpu_torch.ops.window_kernel.WindowIndex` on
    ``device``, the chromosome's length and the donor count."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    Lc, D, C, V = FIXTURE_LC, FIXTURE_D, 1, FIXTURE_V
    genome = rng.integers(0, 4, size=Lc).astype(np.int8)
    pos = np.sort(rng.choice(Lc - 2000, size=(D, C, V), replace=False), axis=-1).astype(np.int32)
    ref = rng.integers(0, 4, size=(D, C, V)).astype(np.int8)
    alt = rng.integers(0, 4, size=(D, C, V)).astype(np.int8)
    p1 = rng.integers(0, 2, size=(D, C, V)).astype(np.int8)
    p2 = rng.integers(0, 2, size=(D, C, V)).astype(np.int8)
    counts = np.full((D, C), V, np.int32)
    state = (genome, np.zeros(1, np.int32), pos, ref, alt, p1, p2, counts)
    index = build_window_index(*(torch.from_numpy(a).to(dev) for a in state))
    return index, Lc, D


def deployment_fixture(seed: int, device="cuda"):
    """``(index, Lc, D)`` of the deployment state; the lab reads its chr1."""
    dev = resolve_device(device)
    genome, cohort, _ = make_state(seed, dev)
    flat, offsets, _ = genome.device_arrays(dev)
    index = build_window_index(flat, offsets, *cohort.device_arrays(dev))
    return index, int(genome.lengths[0]), cohort.num_donors


def _launch_counts() -> dict:
    return {k: k.launches for k in (encode_windows_kernel, encode_windows_lab)}


def make_chained(call, index, Lc: int, D: int, B: int, L: int, n_chain: int):
    """``run(starts, donor_idx) -> starts``: ``n_chain`` chained links of
    ``call(index, donor_idx, chrom_idx, start)`` on chromosome 0.

    On the card the links are captured once in one CUDA graph; ``run``
    copies its inputs into the graph's, replays it and returns the graph's
    output starts (overwritten by the next call).  A capture records
    launches without running them, so the kernels' launch counts are set
    back after it and advanced on every replay instead."""
    m = Lc - L - 8
    dev = index.pos.device
    chrom_idx = torch.zeros(B, dtype=torch.int32, device=dev)

    def links(st, di):
        for _ in range(n_chain):
            out = call(index, di, chrom_idx, st)
            # every byte of every window feeds the next starts (int32: d &
            # 0x7FFF <= 32767 and st < m, so nothing wraps)
            d = out.hap1.to(torch.int32).sum(dim=1, dtype=torch.int32) + out.n_variants
            st = (st + (d & 0x7FFF) + 1) % m
            di = (di + 1) % D
        return st

    if dev.type != "cuda":
        return links

    st_in = torch.zeros(B, dtype=torch.int32, device=dev)
    di_in = torch.zeros(B, dtype=torch.int32, device=dev)
    # warm up on a side stream: builds and loads the kernels before the capture
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        links(st_in, di_in)
    torch.cuda.current_stream(dev).wait_stream(side)
    before = _launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        st_out = links(st_in, di_in)
    per_replay = {k: k.launches - n for k, n in before.items()}
    for k, n in before.items():
        k.launches = n

    def run(starts, donor_idx):
        st_in.copy_(starts)
        di_in.copy_(donor_idx)
        graph.replay()
        for k, n in per_replay.items():
            k.launches += n
        return st_out

    return run


def draws(rng, Lc, D, B, L, dev):
    """(donor, chrom, start) of B windows on chromosome 0."""
    d = torch.from_numpy(rng.integers(0, D, size=B).astype(np.int32)).to(dev)
    s = torch.from_numpy(rng.integers(0, Lc - L - 8, size=B).astype(np.int32)).to(dev)
    return d, torch.zeros(B, dtype=torch.int32, device=dev), s


def measure(name, call, index, Lc, D, B, L, n_chain, iters=3, seed=0) -> dict:
    """One row: median host seconds a chained call (ended by the fetch of
    ``st[0]``), windows/s and µs per window."""
    rng = np.random.default_rng(seed)
    di, _, starts = draws(rng, Lc, D, B, L, index.pos.device)
    t0 = time.perf_counter()
    run = make_chained(call, index, Lc, D, B, L, n_chain)
    st = run(starts, di)
    int(st[0])
    log(f"  {name}: capture + first call {time.perf_counter() - t0:.3f} s")
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        st = run(st, di)  # the chain feeds itself across calls
        int(st[0])  # the fetch is the attestation
        ts.append(time.perf_counter() - t0)
    med = float(np.median(ts))
    wps = n_chain * B / med
    log(f"  {name}: {med:.6f} s/call = {wps:,.0f} windows/s "
        f"({med / (n_chain * B) * 1e6:.4f} us/window)")
    return {"name": name, "median_s": med, "windows_per_sec": wps,
            "us_per_window": med / (n_chain * B) * 1e6}


def bound_bytes(kind: str, slices, n_apply, L: int) -> dict:
    """The bytes row ``kind`` must move for a list of batches, each byte read
    once and written once.  ``slices`` holds each batch's ``(a, e)``, the
    slice of the row that bounds each window's variants
    (:func:`~haplohyped_tpu_torch.ops.window_kernel.window_slice`), and
    ``n_apply`` each batch's applied variants a window.

    ``prod``, ``full`` and ``dma_only`` read, per window, (donor, chrom,
    start) 12 B, offset and count 8 B, the two bucket-table entries that
    bound its slice 8 B, L genome bytes, 6 B (position, packed codes) per
    applied variant and 4 B per other position of the slice (at most two
    binary searches of it, 2 ceil(log2(n + 1)) probes), and write 2L + 8 B;
    the lab's variants write 4 B more (the sink), and ``dma_only`` reads 6 B
    more (position and codes at ``lo0``).  ``compute_only`` loads nothing it
    could not compute: its stores alone, 2L + 12 B.  Returns the total, its
    search part (table entries and other positions) and the applied
    variants."""
    total = search = applied = 0.0
    for (a, e), k in zip(slices, n_apply):
        B = a.numel()
        k = k.double()
        applied += float(k.sum())
        if kind == "compute_only":
            total += B * (2 * L + 12)
            continue
        n = (e - a).double()
        other = torch.minimum(n - k, 2 * torch.ceil(torch.log2(n + 1)))
        s = 8 * B + 4 * float(other.sum())
        search += s
        total += B * (12 + 8 + L + 2 * L + 8) + s + 6 * float(k.sum())
        if kind != "prod":
            total += 4 * B
        if kind == "dma_only":
            total += 6 * B
    return {"bytes": total, "search": search, "applied": applied}


def bound_ms(kind: str, slices, n_apply, L: int) -> float:
    """Least time a batch for row ``kind`` on an H100 SXM, the mean over the
    batches of :func:`bound_bytes`, over 3.35 TB/s."""
    return bound_bytes(kind, slices, n_apply, L)["bytes"] / len(slices) / HBM_BYTES_PER_S * 1e3


def lab_calls(L: int, K: int, ws=LAB_WS) -> dict:
    """``{row name: call(index, donor_idx, chrom_idx, start)}``."""
    calls = {"prod": functools.partial(encode_windows_kernel, L=L, K=K)}
    for variant in VARIANTS:
        for w in ws:
            calls[f"{variant}_w{w}"] = functools.partial(
                encode_windows_lab, L=L, K=K, variant=variant, w=w)
    return calls


def lab_rows(index, Lc: int, D: int, *, B: int = LAB_B, L: int = LAB_L, K: int = LAB_K,
             n_chain: int = LAB_N_CHAIN, iters: int = 3, seed: int = 0,
             n_timed: int = 20) -> list[dict]:
    """Every row of the lab on ``index``'s chromosome 0.  On the card each
    row also gets ``device_ms_per_launch`` over ``n_timed`` batches of fresh
    windows and ``bound_ms``, the bound of those batches (mean a batch); on
    the CPU both are ``None``."""
    dev = index.pos.device
    cuda = dev.type == "cuda"
    if cuda:
        rng = np.random.default_rng(seed + 1)
        batches = [draws(rng, Lc, D, B, L, dev) for _ in range(n_timed)]
        slices = [window_slice(index, *x, L) for x in batches]
        n_apply = [encode_windows_kernel(index, *x, L=L, K=K).n_variants.clamp(max=K)
                   for x in batches]
    rows = []
    for name, call in lab_calls(L, K).items():
        row = measure(name, call, index, Lc, D, B, L, n_chain, iters, seed)
        row["device_ms_per_launch"] = row["bound_ms"] = None
        if cuda:
            kind = name.rsplit("_w", 1)[0]
            row["bound_ms"] = bound_ms(kind, slices, n_apply, L)
            ms, _ = device_ms(functools.partial(call, index), batches)
            row["device_ms_per_launch"] = ms
            row["device_windows_per_sec"] = B / ms * 1e3
            log(f"  {name}: {ms:.6f} ms a launch on the device "
                f"(bound {row['bound_ms']:.6f} ms)")
        rows.append(row)
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--state", choices=("lab", "deployment"), default="lab")
    ap.add_argument("--out")
    ap.add_argument("--batch", type=int, default=LAB_B)
    ap.add_argument("--n-chain", type=int, default=LAB_N_CHAIN)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    if args.state == "lab":
        index, Lc, D = build_fixture(FIXTURE_SEED, dev)
    else:
        index, Lc, D = deployment_fixture(args.seed, dev)
    log(f"lab state {args.state}: chr0 {Lc:,} bp, D={D}, V={index.pos.shape[2]:,}, "
        f"built in {time.perf_counter() - t0:.1f} s")
    rows = lab_rows(index, Lc, D, B=args.batch, n_chain=args.n_chain,
                    iters=args.iters, seed=args.seed)
    cuda = dev.type == "cuda"
    out = {
        "platform": "gpu" if cuda else "cpu",
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "card": card_line() if cuda else None,
        "state": args.state, "seed": args.seed,
        "B": args.batch, "L": LAB_L, "K": LAB_K, "n_chain": args.n_chain,
        "method": METHOD,
        "results": rows,
    }
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
            f.write("\n")
    return out


if __name__ == "__main__":
    main()
