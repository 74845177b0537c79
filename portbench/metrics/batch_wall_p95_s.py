"""The 95th percentile of the window's batch walls: from the previous
batch's completion (or its pass's start) to the time the program's batch
loop asks for the next batch, taken by the benchmark's wrapper of the
Pipeline's ``batches`` generator."""

import numpy as np

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"
LAYER = "batch loop (pipeline/runner.py Pipeline.batches, align_batch_waved)"
MOVES = "throughput_kb_s"


def read(ctx):
    if not ctx.batch_walls:
        return None
    return float(np.percentile(ctx.batch_walls, 95))
