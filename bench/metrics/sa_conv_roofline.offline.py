"""sa_conv_roofline.offline (device trace): the least time of the window's
convolutions over the device time of SA-CONV's kernels
(``kernels/csrc/sa_conv_implicit.cu``), in percent.  The least time of a
wave is, per layer, the larger of its operations (from the configuration's
layer table) at the type's data-sheet peak (fp32: 67 TFLOP/s outside the
tensor cores) and its bytes at 3.35 TB/s (``bench/flops.py``)."""
from bench import flops

KERNELS = (r"\bsa_conv_kernel|sa_conv_wgmma_kernel.*ConvArgs"
           r"|pad_channels_kernel|round_filter_kernel")


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    t = tr.kernel_s(KERNELS)
    if t <= 0:
        return None
    bound = sum(flops.conv_bound_s(ctx.cfg, b) for b in ctx.win["wave_batches"])
    return bound / t * 100
