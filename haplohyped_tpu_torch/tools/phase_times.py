"""Run one phase of the ``chip_smoke.py`` of the working directory alone and
print its numbers as one JSON line, so two trees of the repository can be
compared on one card in turns (parent, change, change, parent):

    cd <tree> && PYTHONPATH=. python3 <path>/haplohyped_tpu_torch/tools/phase_times.py \\
        --phase single_pass --tag <name> [--out FILE]

``single_pass`` runs phases 7-8 (the converter's input, its per-donor path)
then phase 14 (the single-pass converter); ``tokenizer`` runs those, then
phase 16 (the tokenizer route and the host I/O surface); ``reference`` runs
phase 15 (the reference path); ``parallel`` writes phase 7's chr1 file and
phase 14's chr22 cohort file, then runs phase 17 (the parallel path at world
size 1, NCCL, in a process of its own); ``chain`` makes the deployment state
and phase 3's sampler, then runs phase 18 (``sample_chain``, one CUDA graph
over the window kernel); ``draw`` does the same after phase 6's draw-kernel
times at 64, 1,024 and 16,384 lanes.  The tree's own package and kernels
are used (built into its ``_build/``).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase", required=True,
                    choices=("single_pass", "tokenizer", "reference", "parallel", "chain", "draw"))
    ap.add_argument("--tag", required=True, help="the tree's name in the output")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the JSON object to this file")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from haplohyped_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("phase_times: needs a CUDA card", file=sys.stderr)
        return 2
    _build.build_kernels()
    card, dev = cs.card_line(), torch.device("cuda")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {"tag": args.tag, "phase": args.phase, "card": card}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        if args.phase in ("single_pass", "tokenizer"):
            t0 = time.perf_counter()
            ctx = cs.converter_main_path(tmp, args.seed, dev, cs.DecodeComparisons())
            out["phases_7_8_s"] = time.perf_counter() - t0
            out["per_donor_task_s"] = ctx["task_s"]
            out["single_pass"] = cs.single_pass_phase(card, tmp, args.seed, dev, ctx)
            if args.phase == "tokenizer":
                torch.cuda.empty_cache()
                out["tokenizer"] = cs.tokenizer_phase(card, tmp, dev, ctx)
        elif args.phase in ("chain", "draw"):
            genome, cohort, regions = cs.make_state(args.seed, dev)
            cfg = cs.SamplerConfig(seq_length=cs.SEQ_LENGTH, batch_size=cs.BATCH)
            sampler = cs.DeviceHaplotypeSampler(genome, cohort, regions, cfg)
            if args.phase == "draw":
                out["draw"] = cs.draw_times(card, sampler)
            out["chain"] = cs.chain_phase(card, args.seed, genome, cohort, regions, sampler,
                                          cs.Comparisons())[0]
        elif args.phase == "reference":
            out["reference"] = cs.reference_phase(card, tmp, args.seed, dev, cs.Comparisons())[0]
        else:
            t0 = time.perf_counter()
            cs.make_converter_input(tmp, args.seed)
            cs.cohort_input(tmp, args.seed)
            out["inputs_s"] = time.perf_counter() - t0
            out["parallel"] = cs.run_parallel(args.seed, tmp)
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
