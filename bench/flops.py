"""The benchmark's own arithmetic: operations and bytes of each model's work
from its published widths (the configuration files), and the card's
data-sheet peaks.  Every roofline and ``mfu`` metric divides these by a
time, so a metric reads the same work whichever kernel does it.  Nothing
here reads the program.
"""
from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense: FLOP/s by the operands' type
#: (float32 outside the tensor cores, bfloat16 on them) and HBM3 bytes/s;
#: rates at the full 700 W power limit
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12
BYTES = {"float32": 4, "bfloat16": 2}


# ---------------------------------------------------------------------------
# VGG-style CNNs: 3x3 "same" convolutions in blocks, each block closed by a
# 2x2 max pool, then fully connected layers
# ---------------------------------------------------------------------------
def cnn_layers(cfg: dict) -> tuple[list[dict], list[dict]]:
    """(convs, fcs) of the network of ``cfg``: each conv ``{h, w, ci, co,
    k, pool}`` at its input map (``pool`` the window of the pool fused
    after it, 0 for none), each fc ``{fan_in, fan_out}``."""
    res, ch, k = cfg["in_res"], cfg["in_ch"], cfg["kernel"]
    convs = []
    for reps, co in cfg["conv_blocks"]:
        for i in range(reps):
            last = i == reps - 1
            convs.append(dict(h=res, w=res, ci=ch, co=co, k=k,
                              pool=cfg["pool"] if last else 0))
            ch = co
        res //= cfg["pool"]
    fcs, fan_in = [], res * res * ch
    for n in cfg["fc"]:
        fcs.append(dict(fan_in=fan_in, fan_out=n))
        fan_in = n
    return convs, fcs


def conv_flops(cfg: dict) -> float:
    """Operations of one image's convolutions (2 per multiply-add)."""
    convs, _ = cnn_layers(cfg)
    return float(sum(2 * c["h"] * c["w"] * c["co"] * c["k"] ** 2 * c["ci"]
                     for c in convs))


def fc_flops(cfg: dict) -> float:
    _, fcs = cnn_layers(cfg)
    return float(sum(2 * f["fan_in"] * f["fan_out"] for f in fcs))


def cnn_flops(cfg: dict) -> float:
    """Operations of one image's forward pass, convolutions and FCs."""
    return conv_flops(cfg) + fc_flops(cfg)


def conv_bound_s(cfg: dict, batch: int) -> float:
    """Least seconds of one batch's convolutions: per layer the larger of
    its operations at the type's peak and its bytes (input, filters and
    bias read once, the pooled output written once) at the memory rate."""
    convs, _ = cnn_layers(cfg)
    nb, peak = BYTES[cfg["dtype"]], PEAK_FLOPS[cfg["dtype"]]
    total = 0.0
    for c in convs:
        ops = 2 * batch * c["h"] * c["w"] * c["co"] * c["k"] ** 2 * c["ci"]
        out_hw = c["h"] * c["w"] // (c["pool"] ** 2 if c["pool"] else 1)
        nbytes = nb * (batch * c["h"] * c["w"] * c["ci"]
                       + c["k"] ** 2 * c["ci"] * c["co"] + c["co"]
                       + batch * out_hw * c["co"])
        total += max(ops / peak, nbytes / PEAK_BYTES_PER_S)
    return total


def fc_bound_s(cfg: dict, batch: int) -> float:
    """Least seconds of one batch's FC head: per layer the larger of its
    operations at the type's peak and its bytes (weights and bias read
    once, each row of activations read and written once)."""
    _, fcs = cnn_layers(cfg)
    nb, peak = BYTES[cfg["dtype"]], PEAK_FLOPS[cfg["dtype"]]
    total = 0.0
    for f in fcs:
        ops = 2 * batch * f["fan_in"] * f["fan_out"]
        nbytes = nb * (f["fan_in"] * f["fan_out"] + f["fan_out"]
                       + batch * (f["fan_in"] + f["fan_out"]))
        total += max(ops / peak, nbytes / PEAK_BYTES_PER_S)
    return total


# ---------------------------------------------------------------------------
# decoder-only transformers (attention + gated MLP blocks, a tied or
# untied head)
# ---------------------------------------------------------------------------
def lm_matmul_params(m: dict) -> int:
    """Weights that enter a matrix product per token: every block's
    q, k, v, o and gated MLP, and the head (the tied embedding's product
    counted once; the lookup costs no operations)."""
    d, hd = m["d_model"], m["d_model"] // m["n_heads"]
    attn = d * m["n_heads"] * hd * 2 + 2 * d * m["n_kv_heads"] * hd
    mlp = 3 * d * m["d_ff"]
    return m["n_layers"] * (attn + mlp) + d * m["vocab_size"]


def lm_train_matmul_flops(m: dict, tokens: int) -> float:
    """A train step's matrix-product operations, forward and backward,
    without recompute: 6 per weight per token."""
    return 6.0 * lm_matmul_params(m) * tokens


def lm_train_flops(m: dict, tokens: int, seq: int) -> float:
    """A train step's model operations for ``mfu``: 6 N per token plus
    attention's 12 L d s (forward and backward of both score products,
    the full square counted, as the usual MFU formula counts it)."""
    return tokens * (6.0 * lm_matmul_params(m)
                     + 12.0 * m["n_layers"] * m["d_model"] * seq)
