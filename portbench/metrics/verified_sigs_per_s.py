"""Every signature verified in the window, over the whole window (host
clock): rows of all requests handed in and answered, over the time from
the window's open to the last mask's return."""


def read(ctx, name):
    return ctx.rows / ctx.window_s
