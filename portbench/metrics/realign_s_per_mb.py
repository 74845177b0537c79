"""The main thread's ``Pipeline.stage_time["hmm"]`` over the window, a
megabase of read bases (the program's own timer).  eventalign only: the
stage holds the re-alignment there."""

UNIT, BETTER, SOURCE = "s/Mb", "lower", "program_span"
LAYER = "eventalign re-alignment (pipeline/eventalign.py, native.realign_read)"
MOVES = "throughput_kb_s"


def read(ctx):
    if ctx.config["subcommand"] != "eventalign":
        return None
    return ctx.stage["hmm"] / (ctx.bases / 1e6) if ctx.bases else None
