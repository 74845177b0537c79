"""The HMM kernel's (K2, hmm_forward*) share of its roofline: the least
time of the card for the window's HMM launches (``work.hmm_bound``: 55
f32 operations a (k-mer, event) cell of every CpG window; metadata,
events and scores moved once), over its device time in the trace."""

from .. import trace

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "HMM kernel K2 (csrc/hmm.cu)"
MOVES = "throughput_kb_s"


def read(ctx):
    if not ctx.trace or not ctx.spans or not hasattr(ctx, "hmm_bound_s"):
        return None
    t = sum(s for n, (s, _) in trace.by_kernel(ctx.spans).items()
            if n.startswith("hmm_forward"))
    return 100.0 * ctx.hmm_bound_s / t if t > 0 else None
