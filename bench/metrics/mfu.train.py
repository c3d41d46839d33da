"""mfu.train (host clock): the window's tokens times a token's model
operations, 6 N + 12 L d s (``bench/flops.py``), over the window's seconds
and the compute type's data-sheet peak (bf16: 989 TFLOP/s), in percent."""
from bench import flops


def read(ctx):
    m = ctx.cfg["model"]
    seq = ctx.wl["traffic_params"]["seq_len"]
    ops = flops.lm_train_flops(m, ctx.win["tokens"], seq)
    return ops / ctx.win["window_s"] / flops.PEAK_FLOPS[m["compute_dtype"]] * 100
