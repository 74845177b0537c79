"""The main thread's ``Pipeline.stage_time["output"]`` over the window, a
megabase of read bases (the program's own timer).  The main thread's
share only: the writer thread's rendering counts where it blocks the
main thread."""

UNIT, BETTER, SOURCE = "s/Mb", "lower", "program_span"
LAYER = "output (pipeline/writer.py AsyncWriter, the row renderers)"
MOVES = "throughput_kb_s"


def read(ctx):
    return ctx.stage["output"] / (ctx.bases / 1e6) if ctx.bases else None
