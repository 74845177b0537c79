"""The main thread's ``Pipeline.stage_time["hmm"]`` over the window, a
megabase of read bases (the program's own timer).  call-methylation only."""

UNIT, BETTER, SOURCE = "s/Mb", "lower", "program_span"
LAYER = "CpG HMM (runner._meth_prepare_dispatch, ops/hmm_cuda.py)"
MOVES = "throughput_kb_s"


def read(ctx):
    if ctx.config["subcommand"] != "call-methylation":
        return None
    return ctx.stage["hmm"] / (ctx.bases / 1e6) if ctx.bases else None
