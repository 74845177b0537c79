"""Read bases of every batch the window completed, over the time from the
window's start to the last completion, in kilobases a second."""

UNIT, BETTER, SOURCE = "kbases/s", "higher", "host_clock"


def read(ctx):
    return ctx.bases / ctx.window_s / 1e3 if ctx.window_s > 0 else None
