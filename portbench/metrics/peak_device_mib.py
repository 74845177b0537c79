"""torch.cuda.max_memory_allocated() over the window, after
reset_peak_memory_stats() at its start, in MiB."""

UNIT, BETTER, SOURCE = "MiB", "lower", "device_trace"


def read(ctx):
    return None if ctx.peak_bytes is None else ctx.peak_bytes / 2 ** 20
