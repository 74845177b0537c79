"""The main thread's ``Pipeline.stage_time["scaling"]`` over the window, a
megabase of read bases (the program's own timer)."""

UNIT, BETTER, SOURCE = "s/Mb", "lower", "program_span"
LAYER = "postalign, QC and recalibration (native.decode_qc_postalign)"
MOVES = "throughput_kb_s"


def read(ctx):
    return ctx.stage["scaling"] / (ctx.bases / 1e6) if ctx.bases else None
