"""100 less the union of the card's kernel, copy and set spans in the
torch.profiler trace of the window, over the window's wall."""

from .. import trace

UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER = "the card"
MOVES = "throughput_kb_s"


def read(ctx):
    if not ctx.trace or not ctx.spans:
        return None
    return 100.0 * (1.0 - trace.busy(ctx.spans) / ctx.window_s)
