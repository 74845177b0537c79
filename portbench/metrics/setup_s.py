"""Process start to the window's first batch: imports, the pool's
generation, the program's index step, the Pipeline and one warm pass
(with the program's kernel build on a checkout's first run)."""

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(ctx):
    return ctx.setup_s
