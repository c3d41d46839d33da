"""mfu.offline (host clock): the window's images times one image's forward
operations (convolutions and FCs from the configuration's layer table,
``bench/flops.py``) over the window's seconds and the type's data-sheet
peak (fp32: 67 TFLOP/s), in percent."""
from bench import flops


def read(ctx):
    ops = ctx.win["images"] * flops.cnn_flops(ctx.cfg)
    return ops / ctx.win["window_s"] / flops.PEAK_FLOPS[ctx.cfg["dtype"]] * 100
