"""images_per_s (host clock): images delivered in the window over the
window's seconds.  The window runs whole chunks of the closed loop until
``--seconds`` have passed, so it holds all of their work and time."""


def read(ctx):
    return ctx.win["images"] / ctx.win["window_s"]
