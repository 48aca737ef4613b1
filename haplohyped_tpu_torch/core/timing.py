"""Device timing on the card: the card's name and power limit, a kernel's
device time back to back behind a sleep kernel, and the card's peak memory
and bf16 rates that bound a kernel or a train step."""

from __future__ import annotations

import functools
import subprocess
import time

import torch

#: H100 SXM device-memory rate (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet), FLOP/s
BF16_DENSE_FLOPS_PER_S = 989e12


def card_line() -> str:
    """``name, power.limit`` of the first card, as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


@functools.cache
def _sleep_cycles_per_ms() -> float:
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    torch.cuda._sleep(20_000_000)
    b.record()
    b.synchronize()
    return 20_000_000 / a.elapsed_time(b)


def device_ms(fn, args_list) -> tuple[float, float]:
    """``(device ms, host ms)`` per call of ``fn`` over ``args_list``.

    The host's time is that of issuing every call once.  For the device's, a
    sleep kernel holds the stream while the host issues every call again, so
    the two CUDA events around them time the device's work alone (gaps
    between launches on the device included), not the wrapper's host time.
    The first event must still be pending when the host is done, or the
    host fell behind and the timing is refused."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for args in args_list:
        fn(*args)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    sleep_ms = 5 * host_ms + 100
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(int(_sleep_cycles_per_ms() * sleep_ms))
    a.record()
    t0 = time.perf_counter()
    for args in args_list:
        fn(*args)
    b.record()
    issue_ms = (time.perf_counter() - t0) * 1e3
    pending = not a.query()
    b.synchronize()
    if not pending:
        raise RuntimeError(
            f"the host fell behind the device (slept {sleep_ms:.1f} ms, issued in "
            f"{issue_ms:.1f} ms, first pass {host_ms:.1f} ms); timing refused")
    return a.elapsed_time(b) / len(args_list), host_ms / len(args_list)
