"""The main thread's ``Pipeline.stage_time["load"]`` over the window, a
megabase of read bases: the program's ``load`` spans, each from a
resumption of the ``Pipeline.batches`` generator to its next yield (the
BAM records, the filters and the read-db lookups).  None where the
program adds nothing to the key (before its span recorder, ``load`` was
printed and never added to)."""

UNIT, BETTER, SOURCE = "s/Mb", "lower", "program_span"
LAYER = ("BAM and read-db read-in (Pipeline.batches, io/bam.py, io/bgzf.py, "
         "io/readdb.py)")
MOVES = "throughput_kb_s"


def read(ctx):
    load = ctx.stage.get("load")
    if not load or not ctx.bases:
        return None
    return load / (ctx.bases / 1e6)
