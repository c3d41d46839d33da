"""device_idle (device trace): the share of the traced window in which no
operation (kernel, copy or set) ran on the card, in percent."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.busy_s <= 0:
        return None
    return (1 - tr.busy_s / tr.window_s) * 100
