"""gemm_roofline.train (device trace): the window's matrix-product
operations (6 per matmul weight per token, no recompute:
``bench/flops.py``) at bf16's data-sheet peak, 989 TFLOP/s, over the
device time of the SA-CONV GEMM's kernels (``kernels/csrc/sa_conv.cu``),
in percent."""
from bench import flops

KERNELS = r"sa_conv_gemm_kernel|sa_conv_wgmma_kernel"
NOT = r"ConvArgs"


def read(ctx):
    tr = ctx.trace
    if tr is None or not ctx.win.get("tokens"):
        return None
    t = tr.kernel_s(KERNELS, exclude=NOT)
    if t <= 0:
        return None
    m = ctx.cfg["model"]
    ops = flops.lm_train_matmul_flops(m, ctx.win["tokens"])
    return ops / flops.PEAK_FLOPS[m["compute_dtype"]] / t * 100
