"""Run one cell of the benchmark once and print its result as the last line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``haplohyped_tpu_torch``.  It makes
the cell's state and weights from ``--seed`` on the card, warms up the
cell's shapes, measures for ``--seconds``, checks what the timed path
produced against the plain reference in ``portbench/reference/``, and
prints one JSON object: with ``--trace 0`` the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics.  The numbers compared, each
beside its limit, are the last lines on standard error and the last key of
the result.  It exits non-zero and prints no result without the cards the
cell asks for, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: top-level module names that no process of the benchmark may load
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "haplohyped_tpu"})


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & FORBIDDEN)


class Ctx:
    """What a loop is given: the cell's configuration and mix, the run's
    seed, window and trace flag, the device, the set-up split and clock."""

    def __init__(self, cfg, mix, seed, seconds, trace, device, t0):
        from portbench.common import Split

        self.cfg, self.mix, self.seed, self.seconds = cfg, mix, seed, seconds
        self.trace, self.device, self.t0 = trace, device, t0
        self.split = Split()

    @contextlib.contextmanager
    def reference_precision(self):
        """float32 as it is written: TF32 off for matmuls and convolutions."""
        import torch

        old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def run_cell(catalog, name: str, seed: int, seconds: float, trace: bool, device,
             t0: float | None = None) -> dict:
    """One run of cell ``name``: the result object (without ``device``'s
    card fields) and the checks, as ``{"result": ..., "checks": [...]}``."""
    import importlib

    from portbench import trace as tr
    from portbench.catalog import value_of

    cell = catalog.cell(name)
    cfg, mix = catalog.config(cell["config"]), catalog.traffic(cell["traffic"])
    loop = importlib.import_module(f"portbench.loops.{mix['loop']}")
    ctx = Ctx(cfg, mix, seed, seconds, trace, device, T0 if t0 is None else t0)
    out = loop.run(ctx)
    if trace:
        metrics = {}
        for m in catalog.metrics("per_layer", name):
            v = catalog.reader(m["name"])(out["rec"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {**out["end_to_end"], "setup_s": out["setup_s"]}
        metrics = {m["name"]: {"value": value_of(m["name"], values), "unit": m["unit"]}
                   for m in catalog.metrics("end_to_end", name)}
    checks = out["checks"]
    result = {
        "correct": all(c.ok for c in checks),
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": metrics,
        "device": {"memory_peak_bytes": out["memory_peak_bytes"]},
    }
    if trace:
        profile = out["rec"].get("profile")
        bw = tr.busy_and_window_s(profile)
        if bw is not None:
            result["device"] |= {"busy_s": bw[0], "window_s": bw[1]}
        bd = tr.breakdown(profile)
        if bd is not None:
            result["breakdown"] = bd
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return {"result": result, "checks": checks}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # every build and kernel cache at a fixed path inside the checkout
    cache = ROOT / "portbench" / "_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))

    from portbench.catalog import Catalog

    catalog = Catalog(ROOT)
    chips = catalog.cell(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"cuda available {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} card(s)", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    from portbench.common import log

    try:
        import subprocess

        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader", "-i", "0"],
                              capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        card = f"nvidia-smi failed: {e}"
    log(f"card: {card}")
    out = run_cell(catalog, args.workload, args.seed, args.seconds, bool(args.trace), device)
    bad = forbidden_modules()
    if bad:
        log(f"portbench: forbidden modules loaded: {bad}")
        return 3
    result = out["result"]
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                        "count": chips, **result["device"]}
    for c in out["checks"]:
        log(f"check {c.name}: {c.value!r} (limit {c.limit!r}){' ' + c.note if c.note else ''}"
            f" {'ok' if c.ok else 'FAILED'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
