"""The readings that a cell's limits are set from, at the cell's own size.

    python3 -m portbench.control --workload <cell> --seeds <a,b,...> \
        [--control <n>] [--passes <n>]

For each seed: the set-up of a run, a window of ``--passes`` whole passes
through the program, and the check of its sampled reads: the program's
number (the lower reading) and, for the first ``--control`` seeds, the
control's (the reference in bfloat16 in the program's place: the upper
reading).  One JSON line a seed.  The benchmark's own runs do not run
the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--passes", type=int, default=1)
    args = ap.parse_args(argv)

    import torch

    from . import registry, run

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)
    config = registry.config(cell["config"])
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        ctx = run.run_cell(bench, cell, config, seed, 0.0, False, "cuda:0",
                           setup_t0=time.perf_counter(),
                           passes=args.passes, control=i < args.control)
        line = {"seed": seed, "correct": ctx.correct,
                "program": ctx.numbers, "setup_s": ctx.setup_s,
                "window_s": ctx.window_s, "reference_s": ctx.reference_s,
                "failed": ctx.failed, "attempted": ctx.attempted}
        if i < args.control:
            line["control"] = ctx.control_numbers
            line["control_correct"] = ctx.control_correct
        print(json.dumps(line), flush=True)
    bad = run.forbidden_modules()
    if bad:
        print(f"portbench.control: loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
