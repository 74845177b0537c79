"""The ABEA fills' (K1/K3, kernels named abea_fill*) share of their
roofline: the least time of the card for the work of every fill launch
the window made (``work.fill_bound``: 13 f32 operations a cell, 100
cells a band, the bands each read needs; inputs read and the trace
written once), over the fills' device time in the trace."""

from .. import trace

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "ABEA kernels K1/K3 (csrc/abea.cu, abea_ultra.cu, abea_band.cuh)"
MOVES = "throughput_kb_s"


def read(ctx):
    if not ctx.trace or not ctx.spans:
        return None
    t = sum(s for n, (s, _) in trace.by_kernel(ctx.spans).items()
            if n.startswith("abea_fill"))
    return 100.0 * ctx.fill_bound_s / t if t > 0 else None
