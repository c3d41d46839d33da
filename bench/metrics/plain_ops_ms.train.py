"""plain_ops_ms.train (device trace): device milliseconds a train step
spends in kernels that are not the port's own (``kernels/csrc``): AdamW,
norms, attention's backward, the logits and the loss.  Copies and sets are
not kernels and are left out."""

#: the port's hand-written kernels, by the names nvcc gives them
PORT_KERNELS = (r"\bsa_conv_kernel|sa_conv_gemm_kernel|sa_conv_wgmma_kernel"
                r"|sa_fc_kernel|sa_fc_narrow_kernel|sa_fc_wide_kernel"
                r"|flash_kernel|flash_wgmma_kernel|pool_act_kernel"
                r"|round_filter_kernel|pad_channels_kernel")
COPIES = r"^(Memcpy|Memset)"


def read(ctx):
    tr, steps = ctx.trace, ctx.win.get("steps")
    if tr is None or not steps:
        return None
    s = tr.kernel_s(r".", exclude=f"{PORT_KERNELS}|{COPIES}")
    return s / steps * 1e3 if s > 0 else None
