"""Host time of a call of the window kernel's wrapper, on the card.

    PYTHONPATH=<tree> python haplohyped_tpu_torch/tools/wrapper_host_time.py
        [--tag NAME] [--seed N] [--calls N] [--reps N]

``encode_windows_kernel`` checks its arguments, allocates its outputs and
launches the kernel through ctypes.  The sampler is host-bound, so that host
time, not the kernel's few µs on the device, is what a call costs it.  This
script times the wrapper, and its ``_check`` alone, at the sampler's two
launch shapes (B=64 for ``sample()``, B=1024 for ``sample_many(16)``;
L=1000, K=128) on a small synthetic index: ``--reps`` passes of ``--calls``
calls over 16 batches of random windows, host clock, the median and the
least pass per call.  The kernel takes a few µs a call against tens of µs
of host time, so the device keeps up and the clock reads the host's work.

The script imports ``haplohyped_tpu_torch`` from ``sys.path`` and uses only
``build_window_index``, ``encode_windows_kernel`` and ``_check``, so one copy
of it times any tree of the package that has them: run it in turns on two
trees, with ``PYTHONPATH`` naming each, to compare them on one card.  Prints
one JSON line.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import functools
import json
import statistics
import sys
import time

import numpy as np
import torch

from haplohyped_tpu_torch.core.timing import card_line
from haplohyped_tpu_torch.ops import window_kernel as wk

L, K = 1000, 128
SHAPES = (64, 1024)
#: the synthetic state: D donors x C chromosomes of LC bp, V SNVs a row
D, C, LC, V = 8, 2, 1_000_000, 4096


def synthetic_index(seed: int, dev) -> wk.WindowIndex:
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 5, size=C * LC, dtype=np.int8)
    offsets = np.arange(C, dtype=np.int32) * LC
    pos = np.sort(np.stack([[rng.choice(LC - L, size=V, replace=False) for _ in range(C)]
                            for _ in range(D)]), axis=-1).astype(np.int32)
    ref = genome[offsets[None, :, None] + pos]
    alt = ((ref + 1) % 5).astype(np.int8)
    p1, p2 = (rng.integers(0, 2, size=pos.shape, dtype=np.int8) for _ in range(2))
    counts = np.full((D, C), V, np.int32)
    state = (genome, offsets, pos, ref, alt, p1, p2, counts)
    return wk.build_window_index(*(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                                   for a in state))


def host_ms(fn, batches, calls: int, reps: int) -> tuple[float, float]:
    """(median, least) host ms a call over ``reps`` passes of ``calls``."""
    for x in batches:
        fn(*x)
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for k in range(calls):
            fn(*batches[k % len(batches)])
        per.append((time.perf_counter() - t0) * 1e3 / calls)
        torch.cuda.synchronize()
    return statistics.median(per), min(per)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--reps", type=int, default=9)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("wrapper_host_time: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    index = synthetic_index(args.seed, dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    out = {"tag": args.tag, "card": card_line(), "package": wk.__file__,
           "calls": args.calls, "reps": args.reps}
    for B in SHAPES:
        batches = [tuple(torch.randint(0, hi, (B,), generator=gen, device=dev,
                                       dtype=torch.int32) for hi in (D, C, LC - L))
                   for _ in range(16)]
        wrap = functools.partial(wk.encode_windows_kernel, index, L=L, K=K)
        check = functools.partial(wk._check, index, L=L, K=K)
        w_med, w_min = host_ms(wrap, batches, args.calls, args.reps)
        c_med, c_min = host_ms(check, batches, args.calls, args.reps)
        out[f"B{B}"] = {"wrapper_ms": w_med, "wrapper_min_ms": w_min,
                        "check_ms": c_med, "check_min_ms": c_min}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
