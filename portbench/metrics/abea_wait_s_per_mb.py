"""The main thread's ``Pipeline.stage_time["align"]`` over the window, a
megabase of read bases (the program's own timer): dispatch, and the main
thread's wait on the walks."""

UNIT, BETTER, SOURCE = "s/Mb", "lower", "program_span"
LAYER = (
    "ABEA launch and walk (runner._dispatch_abea, ops/abea_cuda.py, "
    "ops/abea_ultra_cuda.py)")
MOVES = "throughput_kb_s"


def read(ctx):
    return ctx.stage["align"] / (ctx.bases / 1e6) if ctx.bases else None
