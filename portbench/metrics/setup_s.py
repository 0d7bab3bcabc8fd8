"""Seconds from the process's start to the window's open: imports and the
card's context, the seeded inputs and their signing, the program's tables
and warm-up, and the cell's warm traffic (host clock)."""


def read(ctx, name):
    return ctx.setup_s
