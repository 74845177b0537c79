"""The main thread's ``Pipeline.stage_time["events"]`` over the window, a
megabase of read bases (the program's own timer)."""

UNIT, BETTER, SOURCE = "s/Mb", "lower", "program_span"
LAYER = "host load and event detection (runner._worker_load*, native)"
MOVES = "throughput_kb_s"


def read(ctx):
    return ctx.stage["events"] / (ctx.bases / 1e6) if ctx.bases else None
