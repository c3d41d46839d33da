"""CNNs — the paper's own evaluation domain (AlexNet, VGG-16), on the port.

Layer tables match the JAX package's (and the originals) exactly.  The
forward pass runs every CONV through ``Engine.conv2d`` (the SA-CONV kernel),
every FC through ``Engine.matmul`` (SA-FC when memory-bound), and every
conv+maxpool pair as one fused dispatch whose pool rides the conv epilogue —
dispatch for dispatch what the JAX package's ``cnn_forward`` issues, so the
two traces compare record for record.
"""
from __future__ import annotations

from collections.abc import Iterator, Sequence
from dataclasses import dataclass

import torch

from repro_torch.core import engine
from repro_torch.core.accelerator import resolve_device
from repro_torch.core.dataflow import PoolSpec


@dataclass(frozen=True)
class ConvSpec:
    kind: str                  # conv | pool | fc
    out_ch: int = 0
    kernel: int = 0
    stride: int = 1
    pad: int = 0
    act: str = "relu"


# AlexNet (227x227x3 input, no grouping — Table I: 1.07B CONV MACs,
# 58.6M FC MACs, 3.74M CONV weights, 58.6M FC weights)
ALEXNET: tuple[ConvSpec, ...] = (
    ConvSpec("conv", 96, 11, 4, 0),
    ConvSpec("pool", kernel=3, stride=2),
    ConvSpec("conv", 256, 5, 1, 2),
    ConvSpec("pool", kernel=3, stride=2),
    ConvSpec("conv", 384, 3, 1, 1),
    ConvSpec("conv", 384, 3, 1, 1),
    ConvSpec("conv", 256, 3, 1, 1),
    ConvSpec("pool", kernel=3, stride=2),
    ConvSpec("fc", 4096),
    ConvSpec("fc", 4096),
    ConvSpec("fc", 1000, act="none"),
)


def _vgg():
    spec = []
    for reps, ch in ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512)):
        spec += [ConvSpec("conv", ch, 3, 1, 1)] * reps
        spec += [ConvSpec("pool", kernel=2, stride=2)]
    spec += [ConvSpec("fc", 4096), ConvSpec("fc", 4096),
             ConvSpec("fc", 1000, act="none")]
    return tuple(spec)


# VGG-16 (224x224x3): 15.3B CONV MACs / 123.6M FC MACs
VGG16: tuple[ConvSpec, ...] = _vgg()

NETWORKS = {"alexnet": (ALEXNET, 227), "vgg16": (VGG16, 224)}


# ---------------------------------------------------------------------------
# analytical layer statistics (Table I / Fig. 6)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class LayerStats:
    name: str
    kind: str                  # conv | fc
    macs: int
    weights: int
    weight_reuse: int
    in_act_reuse: int
    out_act_reuse: int
    ifm: tuple[int, int, int] = (0, 0, 0)    # H, W, C at the layer input
    ofm: tuple[int, int, int] = (0, 0, 0)


def network_stats(name: str, *, in_res: int | None = None,
                  in_ch: int = 3) -> list[LayerStats]:
    spec, res0 = NETWORKS[name]
    res, ch = in_res or res0, in_ch
    out = []
    ci = 0
    for s in spec:
        if s.kind == "conv":
            ci += 1
            o = (res + 2 * s.pad - s.kernel) // s.stride + 1
            macs = o * o * s.out_ch * s.kernel * s.kernel * ch
            w = s.out_ch * s.kernel * s.kernel * ch
            out.append(LayerStats(
                f"conv{ci}", "conv", macs, w,
                weight_reuse=o * o,
                in_act_reuse=s.kernel * s.kernel * s.out_ch,
                out_act_reuse=s.kernel * s.kernel * ch,
                ifm=(res, res, ch), ofm=(o, o, s.out_ch)))
            res, ch = o, s.out_ch
        elif s.kind == "pool":
            res = (res - s.kernel) // s.stride + 1
        else:  # fc
            fan_in = res * res * ch if res > 1 else ch
            macs = fan_in * s.out_ch
            out.append(LayerStats(
                f"fc{len([l for l in out if l.kind == 'fc']) + 1}", "fc",
                macs, macs, weight_reuse=1, in_act_reuse=s.out_ch,
                out_act_reuse=fan_in, ifm=(1, 1, fan_in),
                ofm=(1, 1, s.out_ch)))
            res, ch = 1, s.out_ch
    return out


# ---------------------------------------------------------------------------
# classifier head in isolation — the SA-FC workload (paper Fig. 6b: the FC
# stack holds nearly all of AlexNet's and VGG-16's weights at weight reuse
# 1, so it is the batch-amortization target the server batches for)
# ---------------------------------------------------------------------------
def fc_head(name: str, *, in_res: int | None = None, in_ch: int = 3,
            width_mult: float = 1.0) -> list[tuple[int, int, str]]:
    """(fan_in, fan_out, act) of the network's FC stack, its geometry from
    :func:`network_stats`.  ``width_mult`` scales every dimension alike
    (at least 8), so a narrowed head keeps its chain of shapes."""
    spec, _ = NETWORKS[name]
    fcs = [s for s in spec if s.kind == "fc"]
    stats = [s for s in network_stats(name, in_res=in_res, in_ch=in_ch)
             if s.kind == "fc"]

    def scale(d: int) -> int:
        return max(8, int(d * width_mult))

    return [(scale(st.ifm[2]), scale(st.ofm[2]), s.act)
            for st, s in zip(stats, fcs)]


def init_fc_head(head: Sequence[tuple[int, int, str]],
                 seed: int | torch.Generator, *, dtype=torch.float32,
                 device=None) -> list:
    """``{"w", "b"}`` per layer of ``head``: weights truncated-normal(±3) /
    sqrt(fan_in) as (fan_in, fan_out), zero biases, drawn on the CPU from a
    ``torch.Generator`` as :func:`init_cnn` draws its FC layers, then moved
    to ``device`` — the card unless the caller names another."""
    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(seed)
    return [{"w": _fc_weight(fan_in, fan_out, gen).to(device=dev,
                                                      dtype=dtype),
             "b": torch.zeros(fan_out, dtype=dtype, device=dev)}
            for fan_in, fan_out, _ in head]


def _fc_weight(fan_in: int, fan_out: int,
               gen: torch.Generator) -> torch.Tensor:
    """(fan_in, fan_out) truncated-normal(±3) / sqrt(fan_in), on the CPU."""
    w = torch.nn.init.trunc_normal_(torch.empty(fan_in, fan_out), a=-3.0,
                                    b=3.0, generator=gen)
    return w * fan_in ** -0.5


def fc_head_forward(head: Sequence[tuple[int, int, str]], params: list,
                    x2d: torch.Tensor, *, backend: str = "kernels",
                    eng: engine.Engine | None = None) -> torch.Tensor:
    """The classifier head alone, ``(batch, fan_in) -> logits``: every layer
    an engine-dispatched matmul named ``fc1..`` as in :func:`cnn_forward`,
    so SA-FC plans, traces and schedules apply unchanged.  ``eng``
    overrides ``backend``; otherwise an engine is derived from the ambient
    one."""
    if eng is None:
        eng = engine.current().with_(backend=backend)
    for i, ((_, _, act), p) in enumerate(zip(head, params), start=1):
        x2d = eng.matmul(x2d, p["w"], p["b"], act=act, name=f"fc{i}")
    return x2d


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def param_shapes(name: str, *, in_res: int | None = None, in_ch: int = 3,
                 width_mult: float = 1.0
                 ) -> Iterator[tuple[str, tuple[int, ...]]]:
    """(kind, weight shape) of every spec entry: ``("conv", (k, k, ci,
    co))``, ``("pool", ())`` or ``("fc", (fan_in, fan_out))`` — the layout
    of :func:`init_cnn` (and of the JAX package's)."""
    spec, res0 = NETWORKS[name]
    res, ch = in_res or res0, in_ch
    for s in spec:
        if s.kind == "conv":
            oc = max(8, int(s.out_ch * width_mult))
            yield "conv", (s.kernel, s.kernel, ch, oc)
            res = (res + 2 * s.pad - s.kernel) // s.stride + 1
            ch = oc
        elif s.kind == "pool":
            yield "pool", ()
            res = (res - s.kernel) // s.stride + 1
        else:
            oc = max(8, int(s.out_ch * width_mult)) if s.out_ch != 1000 \
                else s.out_ch
            fan_in = res * res * ch if res > 1 else ch
            yield "fc", (fan_in, oc)
            res, ch = 1, oc


def init_cnn(name: str, seed: int | torch.Generator, *,
             in_res: int | None = None, in_ch: int = 3,
             width_mult: float = 1.0, dtype=torch.float32,
             device=None) -> list:
    """Random parameters from a seed: conv filters N(0, 1/fan_in) in HWIO,
    FC weights truncated-normal(±3) / sqrt(fan_in) as (fan_in, fan_out),
    zero biases.  Drawn on the CPU from a ``torch.Generator`` (so a seed
    gives the same weights on every device), then moved to ``device`` —
    the card unless the caller names another."""
    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(seed)
    params = []
    for kind, shape in param_shapes(name, in_res=in_res, in_ch=in_ch,
                                    width_mult=width_mult):
        if kind == "pool":
            params.append({})
            continue
        if kind == "conv":
            fan_in = shape[0] * shape[1] * shape[2]
            w = torch.randn(shape, generator=gen) * fan_in ** -0.5
            key = "f"
        else:
            w = _fc_weight(*shape, gen)
            key = "w"
        params.append({key: w.to(device=dev, dtype=dtype),
                       "b": torch.zeros(shape[-1], dtype=dtype, device=dev)})
    return params


def conv_stage_len(name: str) -> int:
    """Number of spec/param entries before the first FC layer — the stage
    boundary of the dual-array pipeline."""
    spec, _ = NETWORKS[name]
    for i, s in enumerate(spec):
        if s.kind == "fc":
            return i
    return len(spec)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def cnn_conv_stage(name: str, params: list, x: torch.Tensor, *,
                   backend: str = "kernels",
                   eng: engine.Engine | None = None) -> torch.Tensor:
    """The SA-CONV stage: the conv+fused-pool stack,
    ``(N, H, W, C) -> (N, features)``.  Op names ``conv1..``/``pool1..``
    and the conv+pool pairing are the JAX package's."""
    spec, _ = NETWORKS[name]
    if eng is None:
        eng = engine.current().with_(backend=backend)
    end = conv_stage_len(name)
    ci = pi = 0
    i = 0
    while i < end:
        s, p = spec[i], params[i]
        if s.kind == "conv":
            ci += 1
            nxt = spec[i + 1] if i + 1 < len(spec) else None
            if nxt is not None and nxt.kind == "pool":
                x = eng.conv2d(x, p["f"], p["b"], stride=s.stride,
                               pad=s.pad, act=s.act,
                               pool=PoolSpec(nxt.kernel, nxt.stride),
                               name=f"conv{ci}")
                pi += 1
                i += 2
                continue
            x = eng.conv2d(x, p["f"], p["b"], stride=s.stride, pad=s.pad,
                           act=s.act, name=f"conv{ci}")
        else:                                       # standalone pool
            pi += 1
            x = eng.pool(x, window=s.kernel, stride=s.stride,
                         name=f"pool{pi}")
        i += 1
    return x.reshape(x.shape[0], -1)


def cnn_fc_stage(name: str, params: list, feats: torch.Tensor, *,
                 backend: str = "kernels",
                 eng: engine.Engine | None = None) -> torch.Tensor:
    """The SA-FC stage: the classifier head, ``(N, features) -> logits``,
    op names ``fc1..``."""
    spec, _ = NETWORKS[name]
    if eng is None:
        eng = engine.current().with_(backend=backend)
    start = conv_stage_len(name)
    x = feats
    for fi, (s, p) in enumerate(zip(spec[start:], params[start:]), start=1):
        x = x.reshape(x.shape[0], -1)
        x = eng.matmul(x, p["w"], p["b"], act=s.act, name=f"fc{fi}")
    return x


def cnn_forward(name: str, params: list, x: torch.Tensor, *,
                backend: str = "kernels",
                eng: engine.Engine | None = None) -> torch.Tensor:
    """x: (N, H, W, C) -> logits (N, classes): :func:`cnn_conv_stage` then
    :func:`cnn_fc_stage`.  ``eng`` overrides ``backend``; otherwise an
    engine is derived from the ambient one, so an active trace, policy or
    schedule still sees every dispatch."""
    if eng is None:
        eng = engine.current().with_(backend=backend)
    feats = cnn_conv_stage(name, params, x, eng=eng)
    return cnn_fc_stage(name, params, feats, eng=eng)
