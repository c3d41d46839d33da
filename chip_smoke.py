#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py        # from the repo root, on a machine with a
                                 # CUDA card and nvcc; no arguments

Phases (any failure raises and exits non-zero):

1. environment: card, power limit, CUDA/nvcc/torch versions, SMs, shared
   memory; fp32 matmuls must not use TF32;
2. build: every kernel of ``src/repro_torch/kernels/csrc`` with nvcc; the
   registers and spills of every SA-FC, SA-CONV, SA-CONV GEMM, flash and
   pool instantiation (none but an fp32 SA-FC one may spill);
3. kernels against their plain PyTorch versions on the card, at the shapes
   full-width AlexNet serving gives them, plus the bitwise invariants
   (SA-CONV: rows of a b=64 launch equal to b=1 and b=2 launches, fp32 and
   int8; fused pool equal to conv then the pool kernel), NaN kept as the
   plain versions keep it (every pool window position, standalone and
   fused; a NaN row through SA-FC, the GEMM and SA-CONV with relu), and a
   fused pool over conv rows wider than a CTA holds (column strips);
4. the CNN slice: ``CNNServer("alexnet", ...)`` at full width and 227x227
   serves 130 requests on the kernels (and one int8 wave), with every
   dispatch a schedule hit and every kernel of the path launched; then the
   same 130 through a bf16 ``CNNServer`` (C7): logits delivered widened
   to fp32, each request's its unbatched bf16 forward bitwise, pipelined
   == sequential;
5. times: CUDA events, median of 25 runs, L2 flushed and the card held
   busy before each (the card's time); SA-FC also with the card drained
   before each call (the wrapper's host work included) and as host time
   per enqueued call; the pool kernel also over ``POOL_SWEEP``
   (AlexNet's and VGG-16's pooled maps at b = 64, fp32 and int8), each
   map checked bitwise against the plain version before it is timed;
6. the LM slice: the SA-CONV GEMM and flash-attention kernels against their
   plain versions at full-width OLMo-1B shapes (the GEMM: rows of the
   m = 2048 launch equal to m = 1 and m = 512 launches bitwise, operands off
   16-byte alignment; flash: a full wave's and a lone request's prefill,
   rows of the first equal to the second bitwise, every head dim), SA-FC at
   the decode (b=4) and lone-prefill (m=512) shapes, then
   ``ServeEngine(olmo-1b, batch_size=4, max_seq=640)`` serves 9 requests of
   512 prompt tokens and 16 new tokens in fp32 (waves of 4, 4 and 1), with
   every matmul a schedule hit, every kernel of the path launched and no
   plain version called; logits against the ``"torch"`` backend and
   incremental decode against a full forward; tokens/s; kernel times, with
   the card's SM clock and power sampled beside the GEMM's;
7. OLMo-1B as ``configs/olmo_1b.py`` publishes it: bf16 parameters, compute
   and cache at full width and depth.  SA-FC, the SA-CONV GEMM and flash
   attention in bf16 against their plain versions at the served shapes
   (within the reference's bf16 tolerance, and bitwise the fp32 launch on
   the widened operands, rounded once), the bitwise batch invariants in
   bf16, then ``ServeEngine`` serves the same 9 requests with a bf16
   cache: every matmul a schedule hit, launches per kernel equal to the
   schedules' ops per regime, no plain version called, and the
   teacher-forced logits no farther from the ``"torch"`` backend's bf16
   logits than those are from its fp32 logits; tokens/s, idle shares and
   each bf16 kernel's time beside its bound and the bf16 library call;
8. the model zoo, ``ModelZooServer`` over ``build_zoo(("alexnet", "vgg16",
   "alexnet-int8"))`` at full width and native resolution (227² and
   224², waves of 64), and bf16 activations in SA-CONV implicit and the
   pool (C6).  First SA-CONV in bf16 at AlexNet conv1-conv5 and VGG-16
   conv1_2, conv3_3 and conv5_3 (b = 64, fp32 and int8 filters, pools
   fused and unfused) and the pool in bf16 at the ``POOL_SWEEP`` maps:
   within the bf16 tolerance of the plain versions, bitwise the fp32
   launch on the widened operands rounded once, fused == conv -> pool and
   rows == b = 1 bitwise; AlexNet's forward with bf16 activations and the
   declined-fusion dispatch in bf16, launches counted.  Then the
   reference example's three-tenant trace (64 requests a tenant) under
   fifo, smf and edf: every request served once, its logits bitwise its
   model's single-request forward and within TOL_LOGITS of the torch
   backend, every dispatch a schedule hit, launches as the stage
   schedules say, no plain call; the chaos benchmark's full trace under
   edf with admission control and seeded faults, executed, equal to its
   modeled schedule with no execution-side quarantine; images/s per
   policy, a b = 64 wave of each variant, every VGG-16 layer beside its
   bound and library call, the bf16 kernels' times;
9. the replica fleet, ``launch/fleet.py``'s seven configurations over the
   same zoo on four replicas sharing the card: the modeled ones (zero
   unaccounted, one replica == the zoo's decisions, modeled scaling >=
   1.5x from 1 to 4 replicas, replays bit-identical) and three executed
   ones (a replica killed and one partitioned; cooperative sharded waves;
   a replica killed mid-wave), every served row bitwise its model's
   unbatched forward, launches as the decisions imply; the int8
   cooperative wave of 256 rows runs as four forwards of 64, every FC on
   SA-FC, beside one forward over the whole wave as evidence; images/s
   and the device's busy share over one cooperative wave;
10. training OLMo-1B as published (bf16, full width and depth) through
   ``trainer.run`` on the kernels backend.  First the autograd Functions
   against torch autograd through the plain versions (SA-FC at b = 4 rows
   and the SA-CONV GEMM at m = 2048, OLMo-1B widths, fp32 and bf16, with
   bias and without, act none and silu, an int8 weight on SA-FC; flash's
   forward with the plain backward at a 4 x 512 wave) within 3e-4 / 3e-2;
   the step-0 gradients of three leaves against the torch backend's (bf16
   within sqrt(2) times that backend's own bf16-vs-fp32 spread in L2, fp32
   within a relative L2 of 1e-3); then 4 steps of 4 x 512 tokens with remat by
   block and an async checkpoint at step 2: every loss finite, every
   matmul a schedule hit, launches per kernel as the train schedule
   implies (plain attention only in the backward), the checkpoint
   restored bitwise into a fresh state and the trainer resuming from it;
   a step's host time (trainer.run's steps 1-3, and 3 steps with no
   checkpoint write in flight), trained tokens/s, device time and idle
   share, the GEMM's card time split into forward, dx and dw, peak
   memory;
11. the static checks against the card: ``python -m repro_torch.analysis
   --net alexnet --net vgg16 --all-zoo-variants`` in process (exit 0; ops
   and findings per pass) and the launch pass over every LM config's
   launches; the card's opt-in shared memory per CTA equal to SA-CONV's
   ``SMEM_MAX + SMEM_STATIC`` (its SM count against ``SM_COUNT``, a
   warning where it differs); every instantiation's static shared memory
   (ptxas) and spills (none) against the launch pass; each kernel's
   exported shared-memory query against the launch pass for every launch
   of the zoo variants and the LM configs; then all five kernels at the
   launch pass's edge geometries (partial tiles, a short last SA-FC
   segment, flat conv tiles across images and a short last band, every
   pool vector width, paired flash CTAs over an odd number of query tiles
   with and without a window), each output's block filled with NaN first,
   against the plain versions (the pool bitwise) with no NaN left.

Phase 5 also holds ``conv2d_im2col`` (the patch matrix on the GEMM kernel)
against ``conv2d_mpna`` at AlexNet conv2-conv5 (b = 64) and times it beside
SA-CONV.

Before the last line come the ``{"analysis": {...}}`` summary of phase
11, the ``{"kernels": [...]}`` summary, and the card's ``nvidia-smi`` name
and power limit; the last line is ``{"ok": true, "device": {...}}``.  Details go to
``build/chip_smoke.json`` (ignored by git).
"""
from __future__ import annotations

import functools
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Peak rates of an H100 SXM (NVIDIA data sheet, dense): the roof each bound
# is computed against.  fp32 means fp32, so the compute roof is the CUDA
# cores' fp32 rate, not a tensor-core rate.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# bf16 operands: the tensor cores' dense rate, the least time the card
# could take for a bf16 product (the bf16 kernels here use the CUDA cores)
PEAK_BF16_FLOPS = 989e12

# Tolerances (allclose: |got - want| <= atol + rtol * |want|), from the
# reference's own kernel tests (tests/test_kernels.py): both sides accumulate
# in fp32 but in different orders (the kernels sum each output sequentially,
# cuBLAS/cuDNN in blocked trees), so they differ by rounding that grows with
# the contraction length (k up to 9216 for fc1, 3456 for conv4).
TOL_FC = dict(rtol=3e-4, atol=3e-4)
TOL_CONV = dict(rtol=2e-3, atol=2e-3)
# Logits through eight layers against the plain "torch" backend: the
# per-layer rounding differences above compound, so the conv tolerance.
TOL_LOGITS = dict(rtol=2e-3, atol=2e-3)
# Attention against the materialised-softmax plain version: the reference's
# flash-kernel tolerance (tests/test_kernels.py).
TOL_ATTN = dict(rtol=3e-4, atol=3e-4)
# OLMo-1B logits through 16 layers and a 2048-wide tied head against the
# "torch" backend, or decode against a full forward: the 3e-4 per-matmul
# rounding of differently ordered fp32 sums compounds over 113 matmuls and
# 16 attentions; the reference's serving tolerance (5e-4) is for 2 layers.
TOL_LM = dict(rtol=1e-3, atol=1e-3)
# bf16 kernels against their plain versions: the reference's bf16 kernel
# tolerance (tests/test_kernels.py); both sum exact fp32 products in other
# orders and round the output once to bf16 (2^-8 relative).
TOL_BF16 = dict(rtol=3e-2, atol=3e-2)

#: clock cycles the card spins before each timed call (~1 ms at 1.98 GHz)
HOLD_CYCLES = 2_000_000

N_REQUESTS = 130          # two full waves of 64 and a tail of 2
SEED = 0
# the LM slice: 9 requests of 512 tokens in waves of 4, 4 and 1
LM_REQUESTS, LM_PROMPT, LM_NEW, LM_BATCH, LM_MAX_SEQ = 9, 512, 16, 4, 640
#: where phase 6 puts its tensors
DEVICE = "cuda"

SOURCES = {
    "sa_conv_implicit": ("src/repro_torch/kernels/csrc/sa_conv_implicit.cu",
                         "src/repro/kernels/sa_conv_implicit.py:183"),
    "sa_fc_matmul": ("src/repro_torch/kernels/csrc/sa_fc.cu",
                     "src/repro/kernels/sa_fc.py:155"),
    "maxpool_act": ("src/repro_torch/kernels/csrc/pool_act.cu",
                    "src/repro/kernels/pool_act.py:60"),
    "sa_conv_matmul": ("src/repro_torch/kernels/csrc/sa_conv.cu",
                       "src/repro/kernels/sa_conv.py:121"),
    "flash_attention": ("src/repro_torch/kernels/csrc/attention.cu",
                        "src/repro/kernels/attention.py:127"),
}
#: the kernels of each served path, and the path whose launches the
#: kernels line reports for each kernel
CNN_KERNELS = ("sa_conv_implicit", "sa_fc_matmul", "maxpool_act")
LM_KERNELS = ("sa_conv_matmul", "flash_attention", "sa_fc_matmul")
#: the pool kernel's sweep: the maps where a pool the planner declined to
#: fuse would cost bytes, AlexNet's three pooled maps (3/2) and VGG-16's
#: five (2/2), at b = POOL_BATCH, random normal; (label, h = w, c, window,
#: dtype), stride 2
POOL_SWEEP = (("AlexNet conv1", 55, 96, 3, "fp32"),
              ("AlexNet conv2", 27, 256, 3, "fp32"),
              ("AlexNet conv2", 27, 256, 3, "int8"),
              ("AlexNet conv5", 13, 256, 3, "fp32"),
              ("VGG-16 conv1_2", 224, 64, 2, "fp32"),
              ("VGG-16 conv1_2", 224, 64, 2, "int8"),
              ("VGG-16 conv2_2", 112, 128, 2, "fp32"),
              ("VGG-16 conv3_3", 56, 256, 2, "fp32"),
              ("VGG-16 conv4_3", 28, 512, 2, "fp32"),
              ("VGG-16 conv5_3", 14, 512, 2, "fp32"))
POOL_BATCH = 64
#: element types of csrc/pool_act.cu's instantiations, as mangled
POOL_TYPES = {"f": "fp32", "a": "int8", "h": "uint8", "i": "int32",
              "13__nv_bfloat16": "bf16"}
#: the kernels with bf16 activations, reported again on the bf16 LM path
#: under these names
BF16_KERNELS = {k: f"{k}[bf16]" for k in ("sa_conv_matmul",
                                           "flash_attention",
                                           "sa_fc_matmul")}
#: the CNN kernels with bf16 activations (C6), reported on their bf16
#: paths under these names
CNN_BF16_KERNELS = {k: f"{k}[bf16]" for k in ("sa_conv_implicit",
                                               "maxpool_act")}
#: phase 8: the zoo's variants at full width and native resolution, the
#: requests per tenant of the three-tenant trace, the wave size
ZOO_MODELS = ("alexnet", "vgg16", "alexnet-int8")
ZOO_RES = {"alexnet": 227, "vgg16": 224}
ZOO_PER_TENANT = 64
ZOO_BATCH = 64
#: SA-CONV launches (each pool fused into its conv) and SA-FC launches a
#: zoo wave makes, by net
ZOO_CONVS = {"alexnet": 5, "vgg16": 13}
ZOO_FCS = 3
#: phase 9: the fleet's trace tier (launch/fleet.py)
FLEET_TIER = "fast"
#: phase 10: a train step of TRAIN_BATCH x TRAIN_SEQ tokens, TRAIN_STEPS
#: steps through trainer.run with an async checkpoint every TRAIN_CKPT
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_CKPT = 4, 512, 4, 2
#: the leaves whose step-0 gradients are held against the torch backend's:
#: the tied embedding (embedding and head), layer 0's q projection and
#: layer 0's MLP down projection
TRAIN_LEAVES = ("embed", "blocks.0.attn.wq[0]", "blocks.0.mlp.wd[0]")
#: fp32 step-0 gradients, kernels against the torch backend, per leaf:
#: |g_kernels - g_torch|_2 / |g_torch|_2.  Both sum in fp32 in other
#: orders through 16 layers (~1e-6 relative); a wrong gradient (a missed
#: term, a transposed operand, a lost scale) is off by O(1)
TRAIN_FP32_REL_L2 = 1e-3
#: bf16 step-0 gradients, kernels against the torch backend, per leaf:
#: |g_kernels - g_torch|_2 <= TRAIN_BF16_SPREAD x |g_torch - g_torch,fp32|_2
#: (the torch backend's own bf16-vs-fp32 spread, on the same weights
#: widened).  Two bf16 computations of one gradient that sum in other
#: orders round independently, so they differ by up to sqrt(2) times each
#: one's distance from the fp32 gradient; the card gave 0.964-1.014 of the
#: spread at these leaves (PERF.md §6), where a wrong gradient is off
#: by its own norm, ~50 spreads
TRAIN_BF16_SPREAD = 2 ** 0.5
#: matmuls whose activation is not linear (models/mlp.py: the gate of the
#: gated MLPs), whose backward recomputes the pre-activation
ACT_MATMULS = ("mlp.gate",)
#: the kernels of the train path, reported on it under these names
TRAIN_KERNELS = {k: f"{k}[train]" for k in ("sa_conv_matmul",
                                             "flash_attention")}
#: the convs phase 8 holds in bf16 (C6)
BF16_CONV_LAYERS = {"alexnet": ("conv1", "conv2", "conv3", "conv4",
                                "conv5"),
                    "vgg16": ("conv1_2", "conv3_3", "conv5_3")}
#: a template argument of the GEMM-like kernels, as mangled: fp32, int8,
#: bf16 or a back-reference to a type named before (only bf16 repeats)
MANGLED_TYPE = r"f|a|13__nv_bfloat16|S\d*_"


def type_names(mangled: str) -> list[str]:
    """The mangled template type arguments of ``mangled``, in order."""
    return ["fp32" if t == "f" else "int8" if t == "a" else "bf16"
            for t in re.findall(MANGLED_TYPE, mangled)]


def log(msg: str) -> None:
    print(msg, flush=True)


class Report:
    """What the run measured, per kernel and overall."""

    def __init__(self) -> None:
        self.err = {k: 0.0 for k in [*SOURCES, *BF16_KERNELS.values(),
                                     *CNN_BF16_KERNELS.values(),
                                     *TRAIN_KERNELS.values()]}
        self.rows: list[dict] = []          # per-shape timings
        self.detail: dict = {}

    def note_err(self, kernel: str, err: float) -> None:
        self.err[kernel] = max(self.err[kernel], err)


def allclose(name: str, got, want, tol: dict) -> float:
    import torch
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    diff = (got.double() - want.double()).abs()
    err = diff.max().item() if diff.numel() else 0.0
    bad = diff > tol["atol"] + tol["rtol"] * want.double().abs()
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} elements outside "
                             f"{tol}, max |diff| {err:.3g}")
    return err


def allclose_rms(name: str, got, want, tol: dict) -> float:
    """:func:`allclose` on ``got`` and ``want`` divided by the RMS of
    ``want``: the tolerance is taken relative to the gradient's typical
    element, as at the reference's test shapes, whose gradients are of
    order 1.  A gradient summed over m = 2048 rows is ~45 in its typical
    element, where one bf16 ulp is 0.25, so an absolute 3e-2 would test the
    scale of the data, not the gradient.  Returns max|d| / RMS."""
    import torch
    scale = want.double().pow(2).mean().sqrt().clamp(min=1e-30)
    return allclose(name, (got.double() / scale).to(torch.float64),
                    want.double() / scale, tol)


def exact(name: str, got, want) -> None:
    import torch
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{name}: not bitwise equal")


def exact_nan(name: str, got, want) -> None:
    """NaN at the same places and every other value equal."""
    import torch
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    nan = torch.isnan(got)
    if not torch.equal(nan, torch.isnan(want)):
        raise AssertionError(f"{name}: NaN at other places")
    if not torch.equal(got[~nan], want[~nan]):
        raise AssertionError(f"{name}: not bitwise equal")


def same_nan_mask(name: str, got, want) -> None:
    import torch
    if got.shape != want.shape or not torch.equal(torch.isnan(got),
                                                  torch.isnan(want)):
        raise AssertionError(f"{name}: NaN at other places than the plain "
                             "version's")


# ---------------------------------------------------------------------------
# phase 1: environment
# ---------------------------------------------------------------------------
def environment(rep: Report) -> str:
    import torch
    from repro_torch.core.accelerator import gpu_card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run(["nvcc", "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    card = gpu_card()
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"nvcc: {nvcc[-1]}")
    log(f"SMs {card.sm_count}  smem/block opt-in {card.smem_per_block_optin}"
        f"  capability {card.capability}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("torch.backends.cuda.matmul.allow_tf32 is on")
    rep.detail["env"] = dict(smi=smi, torch=torch.__version__,
                             cuda=torch.version.cuda, nvcc=nvcc[-1],
                             sm_count=card.sm_count,
                             smem_optin=card.smem_per_block_optin,
                             name=card.name)
    return smi


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------
def build(rep: Report) -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    seconds = _build.build()
    log(f"build: {len(seconds)} libraries in "
        f"{time.perf_counter() - t0:.1f}s {seconds}")
    ptxas = {}
    for name in _build.SOURCES:
        text = _build.build_log(name)
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(s) for s in re.findall(r"(\d+) bytes spill", text))
        ptxas[name] = dict(registers=regs, spill_bytes=spills)
        log(f"  ptxas {name}: {len(regs)} kernels, registers "
            f"{min(regs)}..{max(regs)}, spill bytes {spills}")
    rep.detail["build_s"] = seconds
    rep.detail["ptxas"] = ptxas
    rep.detail["ptxas_sa_fc"] = sa_fc_ptxas(_build.build_log("sa_fc"))
    for inst, v in rep.detail["ptxas_sa_fc"].items():
        log(f"  ptxas sa_fc_kernel<{inst}>: {v['registers']} registers, "
            f"spill bytes {v['spill_bytes']}")
    if any(v["spill_bytes"] for k, v in rep.detail["ptxas_sa_fc"].items()
           if "x bf16" in k or "out bf16" in k):
        raise AssertionError("ptxas: a bf16 SA-FC instantiation spills")
    conv = sa_conv_ptxas(_build.build_log("sa_conv_implicit"))
    rep.detail["ptxas_sa_conv_implicit"] = conv
    for inst, v in conv.items():
        log(f"  ptxas sa_conv_kernel<{inst}>: {v['registers']} registers, "
            f"spill bytes {v['spill_bytes']}")
    if any(v["spill_bytes"] for v in conv.values()):
        raise AssertionError("ptxas: an SA-CONV instantiation spills")
    gemm = gemm_ptxas(_build.build_log("sa_conv"))
    rep.detail["ptxas_sa_conv_gemm"] = gemm
    for inst, v in gemm.items():
        log(f"  ptxas sa_conv_gemm_kernel<{inst}>: {v['registers']} "
            f"registers, spill bytes {v['spill_bytes']}")
    if any(v["spill_bytes"] for v in gemm.values()):
        raise AssertionError("ptxas: an SA-CONV GEMM instantiation spills")
    attn = flash_ptxas(_build.build_log("attention"))
    rep.detail["ptxas_attention"] = attn
    for inst, v in attn.items():
        log(f"  ptxas flash_kernel<{inst}>: {v['registers']} registers, "
            f"spill bytes {v['spill_bytes']}")
    if any(v["spill_bytes"] for v in attn.values()):
        raise AssertionError("ptxas: a flash instantiation spills")
    pool = pool_ptxas(_build.build_log("pool_act"))
    rep.detail["ptxas_pool_act"] = pool
    regs = [v["registers"] for v in pool.values()]
    log(f"  ptxas pool_act_kernel: {len(pool)} instantiations, registers "
        f"{min(regs)}..{max(regs)}, spill bytes "
        f"{sum(v['spill_bytes'] for v in pool.values())}")
    for inst, v in pool.items():
        if ", 16 B, " in inst:
            log(f"  ptxas pool_act_kernel<{inst}>: {v['registers']} "
                f"registers, spill bytes {v['spill_bytes']}")
    if any(v["spill_bytes"] for v in pool.values()):
        raise AssertionError("ptxas: a pool instantiation spills")


def pool_ptxas(text: str) -> dict:
    """Registers and spills of every pool instantiation (element type;
    vector bytes; unrolled window, or any) from ptxas's -v output."""
    out = {}
    for m, regs, spills in ptxas_kernels(
            text, r"pool_act_kernelI(f|a|h|i|13__nv_bfloat16)Li(\d+)ELi(\d+)E"):
        t, vec, win = m.groups()
        window = "any" if win == "0" else f"{win}x{win}"
        out[f"{POOL_TYPES[t]}, {vec} B, {window}"] = dict(
            registers=regs, spill_bytes=spills)
    # 3 windows (2x2, 3x3, any) for each type and vector: fp32 and int32
    # at 16, 8 and 4 bytes, int8 and uint8 also at 1, bf16 also at 2
    if len(out) != 3 * (3 + 3 + 4 + 4 + 4):
        raise AssertionError(f"ptxas: {len(out)} pool instantiations, "
                             "expected 54")
    return out


def ptxas_kernels(text: str, pattern: str):
    """(match of ``pattern`` in the mangled name, registers, spill bytes)
    of each kernel in ptxas's -v output whose name matches."""
    for block in text.split("Compiling entry function")[1:]:
        m = re.search(pattern, block)
        regs = re.search(r"Used (\d+) registers", block)
        if m and regs:
            yield m, int(regs.group(1)), sum(
                int(v) for v in re.findall(r"(\d+) bytes spill", block))


def sa_fc_ptxas(text: str) -> dict:
    """Registers and spill bytes of each SA-FC instantiation (weight,
    activation and output types, row tile) from ptxas's -v output."""
    out = {}
    for m, regs, spills in ptxas_kernels(
            text, rf"sa_fc_kernelI((?:{MANGLED_TYPE}){{3}})Li(\d+)E"):
        w, x, o = type_names(m.group(1))
        key = f"{w}, RB={m.group(2)}" if (x, o) == ("fp32", "fp32") else \
            f"{w}, x {x}, out {o}, RB={m.group(2)}"
        out[key] = dict(registers=regs, spill_bytes=spills)
    if len(out) != 84:
        raise AssertionError(f"ptxas: {len(out)} SA-FC instantiations, "
                             "not 84")
    return out


def sa_conv_ptxas(text: str) -> dict:
    """Registers and spill bytes of each SA-CONV instantiation (activation
    type, "bf16 x, " before the key where it is bf16; filter rows, columns
    and stride, 0 for the generic one; pixels x channels per thread;
    channels per CTA; channels per staged group) from ptxas's -v output."""
    out = {}
    for m, regs, spills in ptxas_kernels(
            text, rf"sa_conv_kernelI({MANGLED_TYPE})Li(\d+)ELi(\d+)ELi(\d+)"
                  r"ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E"):
        (x,) = type_names(m.group(1))
        p, q, s, tpx, tco, g, cpg = (int(v) for v in m.groups()[1:])
        shape = f"{p}x{q}/{s}" if p else "generic"
        out[f"{'' if x == 'fp32' else 'bf16 x, '}{shape}, {tpx}x{tco} per "
            f"thread, {tco * g} channels, cpg {cpg}"] = dict(
                registers=regs, spill_bytes=spills)
    # fp32 x: 11; bf16 x: the same less the 8 x 16 tile's three
    if len(out) != 11 + 8:
        raise AssertionError(f"ptxas: {len(out)} SA-CONV instantiations, "
                             "not 19")
    return out


def gemm_ptxas(text: str) -> dict:
    """Registers and spill bytes of each SA-CONV GEMM instantiation (weight,
    activation and output types; every one runs the 128 x 128 tile) from
    ptxas's -v output."""
    from repro_torch.kernels.sa_conv import BM, BN
    out = {}
    for m, regs, spills in ptxas_kernels(
            text, rf"sa_conv_gemm_kernelI((?:{MANGLED_TYPE}){{3}})E"):
        w, x, o = type_names(m.group(1))
        key = f"{w}, {BM}x{BN}" if (x, o) == ("fp32", "fp32") else \
            f"{w}, x {x}, out {o}, {BM}x{BN}"
        out[key] = dict(registers=regs, spill_bytes=spills)
    if len(out) != 12:
        raise AssertionError(f"ptxas: {len(out)} SA-CONV GEMM "
                             "instantiations, not 12")
    return out


def flash_ptxas(text: str) -> dict:
    """Registers and spill bytes of each flash instantiation (head dim,
    query rows per tile, element type) from ptxas's -v output."""
    out = {}
    for m, regs, spills in ptxas_kernels(
            text, rf"flash_kernelILi(\d+)ELi(\d+)E({MANGLED_TYPE})E"):
        (t,) = type_names(m.group(3))
        key = f"d={m.group(1)}, {16 * int(m.group(2))} rows" + \
            ("" if t == "fp32" else f", {t}")
        out[key] = dict(registers=regs, spill_bytes=spills)
    if len(out) != 32:
        raise AssertionError(f"ptxas: {len(out)} flash instantiations, "
                             "not 32")
    return out


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def _pad(x, pad: int):
    import torch.nn.functional as F
    return F.pad(x, (0, 0, pad, pad, pad, pad)).contiguous() if pad else x


def cnn_layers(net: str, params):
    """(name, spec, params, pool) of a net's conv layers, each paired with
    the pool after it, and (name, spec, params) of its FC layers.  VGG-16's
    convs are named by block (conv1_1 ... conv5_3)."""
    from repro_torch.models.cnn import NETWORKS
    spec, _ = NETWORKS[net]
    out, i, n, block, j = [], 0, 0, 1, 0
    while spec[i].kind != "fc":
        s = spec[i]
        n, j = n + 1, j + 1
        nxt = spec[i + 1]
        pool = (nxt.kernel, nxt.stride) if nxt.kind == "pool" else None
        out.append((f"conv{block}_{j}" if net == "vgg16" else f"conv{n}",
                    s, params[i], pool))
        if pool:
            block, j = block + 1, 0
        i += 2 if pool else 1
    fcs = [(f"fc{k + 1}", s, params[i + k])
           for k, s in enumerate(spec[i:])]
    return out, fcs


def check_kernels(rep: Report, params, qparams, images) -> dict:
    """Every kernel at its main-path shapes against its plain version, on
    the card, on a chain of real activations.  Returns the inputs each
    kernel sees on the main path, for timing."""
    import torch
    from repro_torch.core.engine import Engine
    from repro_torch.core.dataflow import PoolSpec
    from repro_torch.kernels import ref
    from repro_torch.kernels.pool_act import maxpool_act
    from repro_torch.kernels.sa_conv_implicit import (sa_conv_implicit,
                                                      sa_conv_plain)
    from repro_torch.kernels.sa_fc import sa_fc_matmul, sa_fc_plain

    convs, fcs = cnn_layers("alexnet", params)
    qconvs, qfcs = cnn_layers("alexnet", qparams)
    shapes: dict = {"conv": [], "fc": [], "pool": None}
    x = images
    for (name, s, p, pool), (_, _, qp, _) in zip(convs, qconvs):
        xin = _pad(x, s.pad)
        pw, ps = pool if pool else (0, 0)
        kw = dict(stride=s.stride, act=s.act, pool_window=pw, pool_stride=ps)
        got = sa_conv_implicit(xin, p["f"], p["b"], **kw)
        want = sa_conv_plain(xin, p["f"], p["b"], **kw)
        e = allclose(f"{name} fp32", got, want, TOL_CONV)
        rep.note_err("sa_conv_implicit", e)
        qf = qp["f"]
        qkw = dict(kw, w_scale=qf.scale)
        e8 = allclose(f"{name} int8",
                      sa_conv_implicit(xin, qf.q, qp["b"], **qkw),
                      sa_conv_plain(xin, qf.q, qp["b"], **qkw), TOL_CONV)
        rep.note_err("sa_conv_implicit", e8)
        log(f"  {name}: in {tuple(xin.shape)} out {tuple(got.shape)} "
            f"max|d| fp32 {e:.3g} int8 {e8:.3g}")
        # batch invariance: rows of the b=64 launch against b=1 and against
        # the served tail wave's b=2, fp32 and int8
        q64 = sa_conv_implicit(xin, qf.q, qp["b"], **qkw)
        for lo, hi in ((0, 1), (62, 64)):
            part = xin[lo:hi].contiguous()
            exact(f"{name} rows {lo}:{hi} of b=64 == b={hi - lo}", got[lo:hi],
                  sa_conv_implicit(part, p["f"], p["b"], **kw))
            exact(f"{name} int8 rows {lo}:{hi} of b=64 == b={hi - lo}",
                  q64[lo:hi], sa_conv_implicit(part, qf.q, qp["b"], **qkw))
        log(f"  {name}: rows of b=64 == b=1 and b=2 launches, bitwise "
            "(fp32 and int8)")
        if pool:
            unfused = sa_conv_implicit(xin, p["f"], p["b"], stride=s.stride,
                                       act=s.act)
            chained = maxpool_act(unfused, window=pw, stride=ps, act="none")
            exact(f"{name} fused == conv -> pool", got, chained)
            log(f"  {name}: fused pool == unfused conv -> pool kernel, "
                "bitwise")
            if name == "conv2":
                shapes["pool"] = unfused
        shapes["conv"].append((name, xin, p, qp, kw))
        x = got
    feats = x.reshape(x.shape[0], -1).contiguous()

    # standalone pool kernel: conv2's 27x27x256 map, an odd channel count,
    # and an int8 map (max is exact, so the tolerance is zero)
    pool_in = shapes["pool"]
    for label, t in (("conv2 map", pool_in),
                     ("odd channels", torch.randn(
                         8, 27, 27, 251, device=pool_in.device))):
        exact(f"maxpool_act {label}",
              maxpool_act(t, window=3, stride=2, act="relu"),
              ref.maxpool_act(t, window=3, stride=2, act="relu"))
    ti = torch.randint(-128, 127, (4, 13, 13, 131), dtype=torch.int8,
                       device=pool_in.device)
    exact("maxpool_act int8", maxpool_act(ti, window=3, stride=2, act="none"),
          ref.maxpool2d(ti, window=3, stride=2))
    # a base one element off 16-byte alignment (4-byte and 1-byte vectors)
    flat = torch.randn(8 * 27 * 27 * 256 + 1, device=pool_in.device)
    flat8 = torch.randint(-128, 127, (flat.numel(),), dtype=torch.int8,
                          device=pool_in.device)
    for label, t in (("fp32", flat[1:].view(8, 27, 27, 256)),
                     ("int8", flat8[1:].view(8, 27, 27, 256))):
        exact(f"maxpool_act {label} base + 1 element",
              maxpool_act(t, window=3, stride=2, act="relu"),
              ref.maxpool_act(t, window=3, stride=2, act="relu"))
    log("  maxpool_act: conv2 map, 251 channels, int8, a base one element "
        "off alignment (fp32, int8) — exact")
    check_nan()

    # declined fusion through the engine: silu is not monotone, so the
    # planner declines and the engine runs the standalone pool kernel
    eng = Engine(backend="kernels")
    reset_counters()
    with eng.tracing() as tr:
        got = eng.conv2d(shapes["conv"][2][1], params[4]["f"], params[4]["b"],
                         act="silu", pool=PoolSpec(3, 2), name="c")
    shapes["declined_launches"] = counters()
    want = Engine(backend="torch").conv2d(
        shapes["conv"][2][1], params[4]["f"], params[4]["b"], act="silu",
        pool=PoolSpec(3, 2), name="c")
    if tr[0].conv_plan.fuse_pool:
        raise AssertionError("declined fusion: the planner fused the pool")
    expect_counts(shapes["declined_launches"], "declined fusion",
                  sa_conv_implicit=1, maxpool_act=1)
    rep.note_err("sa_conv_implicit", allclose("silu conv + pool", got, want,
                                              TOL_CONV))
    log("  engine conv2d(act=silu, pool 3/2): fusion declined, "
        "maxpool_act launched")

    check_wide_pool(rep)

    # FC layers at b in {1, 13, 64}, fp32 and int8, on the real features
    for b in (1, 13, 64):
        h = feats[:b].contiguous()
        for (name, s, p), (_, _, qp) in zip(fcs, qfcs):
            got = sa_fc_matmul(h, p["w"], p["b"], act=s.act)
            e = allclose(f"{name} b={b} fp32", got,
                         sa_fc_plain(h, p["w"], p["b"], act=s.act), TOL_FC)
            qw = qp["w"]
            e8 = allclose(f"{name} b={b} int8",
                          sa_fc_matmul(h, qw.q, qp["b"], act=s.act,
                                       w_scale=qw.scale),
                          sa_fc_plain(h, qw.q, qp["b"], act=s.act,
                                      w_scale=qw.scale), TOL_FC)
            rep.note_err("sa_fc_matmul", max(e, e8))
            log(f"  {name} b={b}: max|d| fp32 {e:.3g} int8 {e8:.3g}")
            if b == 64:
                shapes["fc"].append((name, h, p, qp, s.act))
                one = sa_fc_matmul(h[:1].contiguous(), p["w"], p["b"],
                                   act=s.act)
                exact(f"{name} row 0 of b=64 == b=1", got[:1], one)
                q1 = sa_fc_matmul(h[:1].contiguous(), qw.q, qp["b"],
                                  act=s.act, w_scale=qw.scale)
                q64 = sa_fc_matmul(h, qw.q, qp["b"], act=s.act,
                                   w_scale=qw.scale)
                exact(f"{name} int8 row 0 of b=64 == b=1", q64[:1], q1)
            h = got
    log("  sa_fc_matmul: row 0 at b=64 == b=1, bitwise (fp32 and int8)")
    torch.cuda.synchronize()
    return shapes


def check_nan() -> None:
    """NaN goes through every kernel as through its plain version and the
    reference: the pool kernel with one NaN at each position of a 2x2 and a
    3x3 window (act none and relu), bitwise; the fused pool with a NaN conv
    output at each window position (a 3x3 conv at stride 3 reads each input
    pixel for one output alone), bitwise equal to conv -> pool kernel; a
    NaN row of x through SA-FC, the GEMM and SA-CONV with relu, at the
    plain version's places."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.pool_act import maxpool_act
    from repro_torch.kernels.sa_conv import (sa_conv_matmul,
                                             sa_conv_matmul_plain)
    from repro_torch.kernels.sa_conv_implicit import (sa_conv_implicit,
                                                      sa_conv_plain)
    from repro_torch.kernels.sa_fc import sa_fc_matmul, sa_fc_plain
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    nan = float("nan")
    f = torch.randn((3, 3, 8, 16), generator=gen, device="cuda") / 5
    b = torch.randn(16, generator=gen, device="cuda")
    for window in (2, 3):
        for dp in range(window):
            for dq in range(window):
                x = torch.randn((2, 9, 9, 36), generator=gen, device="cuda")
                x[1, 2 + dp, 2 + dq, ::3] = nan
                for act in ("none", "relu"):
                    exact_nan(f"maxpool_act NaN at ({dp}, {dq}) of "
                              f"{window}/2, {act}",
                              maxpool_act(x, window=window, stride=2,
                                          act=act),
                              ref.maxpool_act(x, window=window, stride=2,
                                              act=act))
                res = 18 if window == 2 else 15     # windows tile the map
                xc = torch.randn((2, res, res, 8), generator=gen,
                                 device="cuda")
                xc[1, 3 * (2 + dp), 3 * (2 + dq)] = nan
                kw = dict(stride=3, act="relu")
                fused = sa_conv_implicit(xc, f, b, pool_window=window,
                                         pool_stride=2, **kw)
                exact_nan(f"fused pool NaN at ({dp}, {dq}) of {window}/2 == "
                          "conv -> pool", fused,
                          maxpool_act(sa_conv_implicit(xc, f, b, **kw),
                                      window=window, stride=2, act="none"))
                same_nan_mask(f"fused pool NaN at ({dp}, {dq})", fused,
                              sa_conv_plain(xc, f, b, pool_window=window,
                                            pool_stride=2, **kw))
    x = torch.randn((6, 300), generator=gen, device="cuda")
    x[2] = nan
    w = torch.randn((300, 200), generator=gen, device="cuda") / 17
    bias = torch.randn(200, generator=gen, device="cuda")
    for name, kern, plain in (("sa_fc_matmul", sa_fc_matmul, sa_fc_plain),
                              ("sa_conv_matmul", sa_conv_matmul,
                               sa_conv_matmul_plain)):
        same_nan_mask(f"{name} NaN row, relu", kern(x, w, bias, act="relu"),
                      plain(x, w, bias, act="relu"))
    xc = torch.randn((3, 13, 13, 8), generator=gen, device="cuda")
    xc[1] = nan
    same_nan_mask("sa_conv_implicit NaN image, relu",
                  sa_conv_implicit(xc, f, b, act="relu"),
                  sa_conv_plain(xc, f, b, act="relu"))
    log("  NaN: pool kernel at each position of 2x2 and 3x3 windows and the "
        "fused pool (== conv -> pool), bitwise; a NaN row through SA-FC, the "
        "GEMM and SA-CONV with relu at the plain versions' places")


def check_wide_pool(rep: Report) -> None:
    """A fused pool over conv rows wider than a CTA holds (a 3x3 conv, 16
    -> 64 channels, over 259- and 388-wide inputs with 3/2 and 2/2 pools):
    the engine still fuses, the wrapper runs column strips.  Against the
    plain version; fused == conv -> pool kernel and rows of the b=8 launch
    == b=1 launches, bitwise."""
    import torch
    from repro_torch.core.dataflow import PoolSpec
    from repro_torch.core.engine import Engine
    from repro_torch.kernels.pool_act import maxpool_act
    from repro_torch.kernels.sa_conv_implicit import (column_strips,
                                                      sa_conv_implicit,
                                                      sa_conv_plain)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    f = torch.randn((3, 3, 16, 64), generator=gen, device="cuda") / 12
    b = torch.randn(64, generator=gen, device="cuda")
    for hw, window in ((259, 3), (388, 2)):
        x = torch.randn((8, hw, hw, 16), generator=gen, device="cuda")
        kw = dict(act="relu", pool_window=window, pool_stride=2)
        eng = Engine(backend="kernels")
        reset_counters()
        with eng.tracing() as tr:
            got = eng.conv2d(x, f, b, act="relu", pool=PoolSpec(window, 2),
                             name="wide")
        strips = column_strips(hw, hw, 16, 3, 3, 64, pool_window=window,
                               pool_stride=2)
        if not tr[0].conv_plan.fuse_pool:
            raise AssertionError(f"wide {hw}: the planner declined the pool")
        expect_counts(counters(), f"wide {hw}",
                      sa_conv_implicit=len(strips))
        e = allclose(f"wide {hw} pool {window}/2", got,
                     sa_conv_plain(x, f, b, **kw), TOL_CONV)
        rep.note_err("sa_conv_implicit", e)
        exact(f"wide {hw} fused == conv -> pool", got, maxpool_act(
            sa_conv_implicit(x, f, b, act="relu"), window=window, stride=2,
            act="none"))
        for i in (0, 7):
            exact(f"wide {hw} row {i} of b=8 == b=1", got[i:i + 1],
                  sa_conv_implicit(x[i:i + 1].contiguous(), f, b, **kw))
        log(f"  conv2d over {hw}-wide rows, pool {window}/2: fused, "
            f"{len(strips)} column strips, out {tuple(got.shape)}, max|d| "
            f"{e:.3g}; fused == conv -> pool and rows 0, 7 of b=8 == b=1, "
            "bitwise")


# ---------------------------------------------------------------------------
# phase 4: the slice
# ---------------------------------------------------------------------------
def _requests(images_np, uids):
    from repro_torch.serve.cnn_server import CNNRequest
    return [CNNRequest(uid=u, image=images_np[u]) for u in uids]


def _wrappers() -> dict:
    from repro_torch.kernels.attention import flash_attention
    from repro_torch.kernels.pool_act import maxpool_act
    from repro_torch.kernels.sa_conv import sa_conv_matmul
    from repro_torch.kernels.sa_conv_implicit import sa_conv_implicit
    from repro_torch.kernels.sa_fc import sa_fc_matmul
    return {"sa_conv_implicit": sa_conv_implicit,
            "sa_fc_matmul": sa_fc_matmul, "maxpool_act": maxpool_act,
            "sa_conv_matmul": sa_conv_matmul,
            "flash_attention": flash_attention}


def counters():
    from repro_torch.kernels import ref
    return {**{k: fn.launches for k, fn in _wrappers().items()},
            **{f"plain.{k}": v for k, v in ref.counts().items()}}


def reset_counters() -> None:
    from repro_torch.kernels import ref
    for fn in _wrappers().values():
        fn.launches = 0
    ref.reset_counts()


def expect_counts(c: dict, what: str, **launches: int) -> None:
    """``c`` launched exactly ``launches`` (every other kernel 0 times)
    and called no plain version."""
    want = {k: launches.get(k, 0) for k in _wrappers()}
    want.update({k: 0 for k in c if k.startswith("plain.")})
    if c != want:
        raise AssertionError(f"{what}: launch counts {c} != {want}")


def check_served(srv, done, n, waves_expected):
    """Every request served once with finite logits, in the expected waves,
    every dispatch a schedule hit; returns the logits in uid order."""
    import numpy as np
    if len(done) != n or not all(r.done for r in done):
        raise AssertionError(f"served {len(done)} of {n}")
    logits = np.stack([r.logits for r in sorted(done, key=lambda r: r.uid)])
    if logits.shape != (n, 1000) or not np.isfinite(logits).all():
        raise AssertionError(f"logits {logits.shape}, finite "
                             f"{np.isfinite(logits).all()}")
    if [w.batch for w in srv.waves] != waves_expected:
        raise AssertionError(f"waves {[w.batch for w in srv.waves]}")
    for w in srv.waves:
        if w.schedule_hits != len(w.trace) or len(w.trace) != 8:
            raise AssertionError(f"wave {w.wave}: {w.schedule_hits} hits of "
                                 f"{len(w.trace)} dispatches")
    return logits


def check_counts(c: dict, waves: int) -> None:
    expect_counts(c, "CNNServer.run", sa_conv_implicit=5 * waves,
                  sa_fc_matmul=3 * waves)


def serve(rep: Report, params, qparams, images_np) -> dict:
    import numpy as np
    import torch
    from repro_torch.core.engine import Engine
    from repro_torch.models import cnn
    from repro_torch.serve.cnn_server import CNNServer

    n = N_REQUESTS
    waves = [64, 64, n - 128]
    srv = CNNServer("alexnet", params)
    if srv.microbatch != 64:
        raise AssertionError(f"planner micro-batch {srv.microbatch} != 64")
    for r in _requests(images_np, range(n)):
        srv.submit(r)
    reset_counters()
    t0 = time.perf_counter()
    done = srv.run()
    first_run_s = time.perf_counter() - t0
    c = counters()
    check_counts(c, len(waves))
    logits = check_served(srv, done, n, waves)
    log(f"  served {n} requests in waves {waves} ({first_run_s:.2f}s, "
        f"schedules compiled on the way); launches {c}")
    rep.detail["launches_per_run"] = c

    # sequential == pipelined, bitwise
    seq = CNNServer("alexnet", params, pipeline=False)
    for r in _requests(images_np, range(n)):
        seq.submit(r)
    seq_logits = check_served(seq, seq.run(), n, waves)
    if not np.array_equal(seq_logits, logits):
        raise AssertionError("sequential logits != pipelined logits")
    log("  pipelined == sequential, bitwise")

    # one at a time == batched, bitwise
    for u in (0, 77, n - 1):
        one = CNNServer("alexnet", params)
        one.submit(_requests(images_np, [u])[0])
        single = one.run()[0].logits
        if not np.array_equal(single, logits[u]):
            raise AssertionError(f"request {u}: unbatched != batched")
    log("  requests 0, 77, 129 re-served alone: bitwise equal")

    # against the plain "torch" backend on the card, TF32 off
    sel = [0, 1, 2, 3, 64, 65, 128, 129]
    x = torch.from_numpy(images_np[sel]).cuda()
    with torch.no_grad():
        plain = cnn.cnn_forward("alexnet", params, x,
                                eng=Engine(backend="torch")).cpu()
    e = allclose("logits vs torch backend", torch.from_numpy(logits[sel]),
                 plain, TOL_LOGITS)
    log(f"  logits vs torch backend: max|d| {e:.3g} (|logits| max "
        f"{np.abs(logits).max():.3g})")
    rep.detail["logits_max_abs_err"] = e

    # int8 variant, one wave
    q = CNNServer("alexnet", qparams)
    for r in _requests(images_np, range(64)):
        q.submit(r)
    reset_counters()
    qlogits = check_served(q, q.run(), 64, [64])
    check_counts(counters(), 1)
    with torch.no_grad():
        qplain = cnn.cnn_forward("alexnet", qparams, x[:4],
                                 eng=Engine(backend="torch")).cpu()
    e8 = allclose("int8 logits vs torch backend",
                  torch.from_numpy(qlogits[sel[:4]]), qplain, TOL_LOGITS)
    log(f"  int8 wave: 64 served, 5 + 3 launches; vs torch backend max|d| "
        f"{e8:.3g}")
    rep.detail["int8_logits_max_abs_err"] = e8
    return dict(launches=c)


def serve_bf16(rep: Report, params, images_np) -> dict:
    """C7 on the card: ``CNNServer(..., dtype=torch.bfloat16)`` serves the
    N_REQUESTS in waves of 64, 64 and 2, pipelined and sequential: logits
    delivered as fp32 (the bf16 values widened), every request's bitwise
    its unbatched bf16 forward, pipelined == sequential bitwise, every
    dispatch a schedule hit, 5 SA-CONV and 3 SA-FC launches a wave and no
    plain call.  Returns the pipelined run's launches."""
    import numpy as np
    import torch
    from repro_torch.models import cnn
    from repro_torch.serve.cnn_server import CNNServer
    n = N_REQUESTS
    waves = [64, 64, n - 128]
    out, launches = [], None
    for pipeline in (True, False):
        srv = CNNServer("alexnet", params, dtype=torch.bfloat16,
                        pipeline=pipeline)
        for r in _requests(images_np, range(n)):
            srv.submit(r)
        reset_counters()
        done = srv.run()
        c = counters()
        check_counts(c, len(waves))
        logits = check_served(srv, done, n, waves)
        if logits.dtype != np.float32:
            raise AssertionError(f"bf16 server delivered {logits.dtype}")
        out.append(logits)
        launches = launches or c
    if not np.array_equal(out[0], out[1]):
        raise AssertionError("bf16 CNNServer: sequential != pipelined")
    for u in range(n):
        x = torch.from_numpy(images_np[u:u + 1]).cuda().to(torch.bfloat16)
        one = cnn.cnn_forward("alexnet", params, x, eng=srv.engine)
        if one.dtype != torch.bfloat16 or not np.array_equal(
                one.float().cpu().numpy()[0], out[0][u]):
            raise AssertionError(f"bf16 CNNServer request {u}: logits != "
                                 "its unbatched bf16 forward, widened")
    widened = torch.from_numpy(out[0]).to(torch.bfloat16).float().numpy()
    if not np.array_equal(widened, out[0]):
        raise AssertionError("bf16 CNNServer: a delivered value is not a "
                             "bf16 value")
    rep.detail["bf16_server_launches"] = launches
    log(f"  C7: bf16 CNNServer served {n} requests in waves {waves}, "
        "pipelined == sequential bitwise, every request == its unbatched "
        f"bf16 forward widened, bitwise; launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 5: times
# ---------------------------------------------------------------------------
def timed(fn, *, runs: int = 25, warmup: int = 3, host: bool = False) -> float:
    """Median ms of ``fn`` over ``runs`` CUDA-event-timed calls, each after
    the L2 cache is flushed by writing a 256 MB buffer.  By default the
    card is then held busy for about a millisecond, so that the host has
    enqueued the call before the card reaches it: the time is the card's.
    With ``host=True`` the card is drained instead, so the time runs from
    the host's start of the call to the card's end of it: the wrapper's
    host work is included, as on a host-bound decode step."""
    import torch
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        if host:
            torch.cuda.synchronize()
        else:
            torch.cuda._sleep(HOLD_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def enqueue_us(fn, *, calls: int = 20, runs: int = 11) -> float:
    """Median host-clock microseconds per call of ``fn`` over bursts of
    ``calls`` calls enqueued while the card is held busy (so that no call
    waits for the card): the wrapper's host work alone."""
    import torch
    fn()
    per = []
    for _ in range(runs):
        torch.cuda.synchronize()
        torch.cuda._sleep(10 * HOLD_CYCLES)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(per)


def host_costs(fn) -> dict:
    """The host's share of a call two ways: ``host_ms``, the call timed
    with the card drained first, and ``enqueue_us``, its host work
    alone."""
    return dict(host_ms=timed(fn, host=True), enqueue_us=enqueue_us(fn))


def smi_sample(fn, seconds: float = 1.0) -> dict:
    """The card's SM clock (MHz) and power draw (W), sampled by nvidia-smi
    every 100 ms while ``fn`` runs back to back for about ``seconds``."""
    import torch
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    try:
        # nvidia-smi can take over a second to start: wait for its first
        # sample (taken before the loop, so left out) and time from there
        smi.stdout.readline()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        text, _ = smi.communicate()
    samples = [[float(v) for v in line.split(",")]
               for line in text.splitlines() if line.count(",") == 1]
    if not samples:
        raise AssertionError("nvidia-smi gave no clock samples")
    clocks = [c for c, _ in samples]
    return dict(samples=len(samples), sm_clock_mhz_min=min(clocks),
                sm_clock_mhz_median=statistics.median(clocks),
                power_w_max=max(p for _, p in samples))


def bound(flops: float, nbytes: float,
          peak: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    """(least ms, "operations" or "bytes"): the larger of the FLOPs over
    ``peak`` (fp32's, or bf16's for bf16 operands) and the bytes over the
    memory rate."""
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def host_log(host: dict | None) -> str:
    return "" if host is None else (f"  host {host['host_ms']:.4f} ms, "
                                    f"enqueue {host['enqueue_us']:.1f} us")


def add_row(rep: Report, kernel: str, path: str, label: str, ms: float,
            plain_ms: float, lib_ms: float | None, flops: float, nb: int, *,
            peak: float = PEAK_FP32_FLOPS, per_pass: int = 1,
            phase: str | None = None, host: dict | None = None,
            smi: dict | None = None) -> None:
    """Record and log one timed shape of ``kernel`` on ``path`` beside its
    bound (operations at ``peak`` or bytes), its plain version and its
    library call; ``per_pass`` launches of it in one unit of the path's
    ``phase``."""
    b_ms, by = bound(flops, nb, peak)
    rep.rows.append(dict(kernel=kernel, shape=label, ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=by, flops=flops, bytes=nb,
                         path=path, per_pass=per_pass,
                         tflops=flops / ms / 1e9,
                         pct_of_bound=100 * b_ms / ms,
                         **({} if phase is None else {"phase": phase}),
                         **(host or {}), **({"smi": smi} if smi else {})))
    log(f"  {kernel:24s} {label:34s} {ms:9.4f} ms  bound {b_ms:8.4f} "
        f"({by}, {100 * b_ms / ms:.1f} %, {flops / ms / 1e9:.1f} TFLOP/s)  "
        f"plain {plain_ms:9.4f}  library "
        f"{'-' if lib_ms is None else f'{lib_ms:.4f}'}{host_log(host)}"
        f"{'' if phase is None else f'  x{per_pass} per {phase}'}")
    if smi:
        log(f"    back to back for 1 s: SM clock median "
            f"{smi['sm_clock_mhz_median']:.0f} MHz (min "
            f"{smi['sm_clock_mhz_min']:.0f}), power up to "
            f"{smi['power_w_max']:.1f} W ({smi['samples']} nvidia-smi "
            "samples)")


def layer_chain(net: str, params, x) -> tuple[list, list, object]:
    """``net``'s layers on the card, each fed the kernel output before it:
    (label, padded input, params, None, conv kwargs) of each conv, (label,
    input, params, None, act) of each FC (the rows ``cnn_layer_rows``
    takes; None where phase 3 puts the int8 params), and the logits."""
    from repro_torch.kernels.sa_conv_implicit import sa_conv_implicit
    from repro_torch.kernels.sa_fc import sa_fc_matmul
    convs, fcs = cnn_layers(net, params)
    conv_rows, fc_rows = [], []
    for label, s, p, pool in convs:
        xin = _pad(x, s.pad)
        pw, ps = pool or (0, 0)
        kw = dict(stride=s.stride, act=s.act, pool_window=pw, pool_stride=ps)
        conv_rows.append((label, xin, p, None, kw))
        x = sa_conv_implicit(xin, p["f"], p["b"], **kw)
    h = x.reshape(x.shape[0], -1).contiguous()
    for label, s, p in fcs:
        fc_rows.append((label, h, p, None, s.act))
        h = sa_fc_matmul(h, p["w"], p["b"], act=s.act)
    return conv_rows, fc_rows, h


def cnn_layer_rows(rep: Report, path: str, convs: list, fcs: list, *,
                   plain_runs: int = 20, host: bool = False) -> None:
    """Each conv and FC of a CNN chain (the rows of ``layer_chain``, or
    phase 3's with int8 params) first held against its plain version on the
    same inputs (TOL_CONV, TOL_FC; TOL_BF16 for bf16 activations), then
    timed beside its bound, its plain version and its library call
    (``F.conv2d`` with TF32 off on the NCHW view and a channels_last filter
    in the activations' dtype, ``addmm``); int8 rows where int8 params are
    given.  ``host`` adds the FC rows' host costs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.sa_conv_implicit import (sa_conv_implicit,
                                                      sa_conv_plain)
    from repro_torch.kernels.sa_fc import sa_fc_matmul, sa_fc_plain

    def checked(kernel, label, fn, plain, tol, *args, **kw):
        rep.note_err(kernel, allclose(label, fn(*args, **kw).float(),
                                      plain(*args, **kw).float(), tol))
        return functools.partial(fn, *args, **kw)

    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for name, xin, p, qp, kw in convs:
            f, b = p["f"], p["b"]
            fp32 = xin.dtype == torch.float32
            kernel = "sa_conv_implicit" if fp32 else \
                CNN_BF16_KERNELS["sa_conv_implicit"]
            peak = PEAK_FP32_FLOPS if fp32 else PEAK_BF16_FLOPS
            batch, h, w, ci = xin.shape
            kk, _, _, co = f.shape
            oh = (h - kk) // kw["stride"] + 1
            ow = (w - kk) // kw["stride"] + 1
            flops = 2 * batch * oh * ow * co * kk * kk * ci
            label = (f"{name} b={batch} {'fp32' if fp32 else 'bf16'}"
                     f"{' pool' if kw['pool_window'] else ''}")
            kern = checked(kernel, label, sa_conv_implicit, sa_conv_plain,
                           TOL_CONV if fp32 else TOL_BF16, xin, f, b, **kw)
            out = kern()
            xc = xin.permute(0, 3, 1, 2)          # NCHW view, channels_last
            fc = f.to(xin.dtype).permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            bc = b.to(xin.dtype)
            add_row(rep, kernel, path, label, timed(kern),
                    timed(lambda: sa_conv_plain(xin, f, b, **kw),
                          runs=plain_runs, warmup=1),
                    timed(lambda: F.conv2d(xc, fc, bc, stride=kw["stride"])),
                    flops, nbytes(xin, f, b, out), peak=peak)
            if qp is None:
                continue
            qf = qp["f"]
            qkw = dict(kw, w_scale=qf.scale)
            label = f"{name} b={batch} int8"
            kern = checked(kernel, label, sa_conv_implicit, sa_conv_plain,
                           TOL_CONV, xin, qf.q, qp["b"], **qkw)
            add_row(rep, kernel, path, label, timed(kern),
                    timed(lambda: sa_conv_plain(xin, qf.q, qp["b"], **qkw),
                          runs=plain_runs, warmup=1),
                    None, flops, nbytes(xin, qf.q, qf.scale, qp["b"], out))
        for name, h, p, qp, act in fcs:
            w, b = p["w"], p["b"]
            flops = 2 * h.shape[0] * w.shape[0] * w.shape[1]
            label = f"{name} b={h.shape[0]} fp32"
            kern = checked("sa_fc_matmul", label, sa_fc_matmul, sa_fc_plain,
                           TOL_FC, h, w, b, act=act)
            out = kern()
            add_row(rep, "sa_fc_matmul", path, label, timed(kern),
                    timed(lambda: sa_fc_plain(h, w, b, act=act),
                          runs=plain_runs),
                    timed(lambda: ref.apply_act(torch.addmm(b, h, w), act)),
                    flops, nbytes(h, w, b, out),
                    host=host_costs(kern) if host else None)
            if qp is None:
                continue
            qw = qp["w"]
            label = f"{name} b={h.shape[0]} int8"
            kern = checked("sa_fc_matmul", label, sa_fc_matmul, sa_fc_plain,
                           TOL_FC, h, qw.q, qp["b"], act=act,
                           w_scale=qw.scale)
            add_row(rep, "sa_fc_matmul", path, label, timed(kern),
                    timed(lambda: sa_fc_plain(h, qw.q, qp["b"], act=act,
                                              w_scale=qw.scale),
                          runs=plain_runs),
                    None, flops, nbytes(h, qw.q, qw.scale, qp["b"], out),
                    host=host_costs(kern) if host else None)


def pool_map(hw: int, c: int, dtype: str, gen):
    """A sweep map on the card: (POOL_BATCH, hw, hw, c) normal fp32, or
    normal x 32 rounded into int8."""
    import torch
    x = torch.randn((POOL_BATCH, hw, hw, c), generator=gen, device="cuda")
    if dtype == "int8":
        x = (x * 32).round_().clamp_(-128, 127).to(torch.int8)
    return x


def pool_sweep(rep: Report) -> None:
    """The pool kernel at every ``POOL_SWEEP`` map: checked bitwise against
    its plain version (act none and relu), then timed (act none) beside the
    plain version and, for fp32, ``F.max_pool2d`` on the channels-last
    view.  Rows go on the path "maxpool_act sweep", which the kernels line
    does not sum."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.pool_act import maxpool_act, pool_geometry
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for label, hw, c, window, dtype in POOL_SWEEP:
        x = pool_map(hw, c, dtype, gen)
        kw = dict(window=window, stride=2)
        for act in ("none", "relu"):
            exact(f"maxpool_act {label} {dtype} {act}",
                  maxpool_act(x, act=act, **kw),
                  ref.maxpool_act(x, act=act, **kw))
        out = maxpool_act(x, act="none", **kw)
        ms = timed(lambda: maxpool_act(x, act="none", **kw))
        plain_ms = timed(lambda: ref.maxpool_act(x, act="none", **kw),
                         runs=10)
        xc = x.permute(0, 3, 1, 2)
        lib_ms = timed(lambda: F.max_pool2d(xc, window, 2)) \
            if dtype == "fp32" else None
        flops, nb = out.numel() * window * window, nbytes(x, out)
        b_ms, by = bound(flops, nb)
        g = pool_geometry(*x.shape, x.element_size(), window, 2, 16)
        geom = dict(vec_bytes=g.vec_bytes, ctas=g.blocks * g.n)
        rep.rows.append(dict(
            kernel="maxpool_act", shape=f"{label} {tuple(x.shape)} "
            f"{window}/2 {dtype}", ms=ms, plain_ms=plain_ms,
            library_ms=lib_ms, bound_ms=b_ms, bound_by=by, flops=flops,
            bytes=nb, path="maxpool_act sweep", per_pass=1,
            tflops=flops / ms / 1e9, pct_of_bound=100 * b_ms / ms,
            geometry=geom))
        log(f"  maxpool_act {label:15s} {dtype} {window}/2 "
            f"{nb / 1e6:8.1f} MB {ms:9.4f} ms  bound {b_ms:8.4f} "
            f"({100 * b_ms / ms:5.1f} %)  plain {plain_ms:9.4f}  "
            f"F.max_pool2d {'-' if lib_ms is None else f'{lib_ms:.4f}'}  "
            f"{g.vec_bytes}-byte vectors, {g.blocks * g.n} CTAs")
        del x, out, xc


def server_throughput(rep: Report, params, images_np):
    """``CNNServer.run`` images/s at b=64 fp32, pipelined and sequential:
    warm schedules, then 4 full waves on the host clock, the card drained
    before and after.  Returns a warm server and the requests."""
    import torch
    from repro_torch.serve.cnn_server import CNNServer
    srv = CNNServer("alexnet", params)
    for r in _requests(images_np, range(64)):
        srv.submit(r)
    srv.run()
    reqs = []
    for rep_i in range(4):
        for r in _requests(images_np, range(64)):
            r.uid += 1000 * (rep_i + 1)
            reqs.append(r)
    for pipelined in (True, False):
        s = CNNServer("alexnet", params)
        s.run()
        for r in reqs:
            r.done, r.logits = False, None
            s.submit(r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.run(pipelined=pipelined)
        sec = time.perf_counter() - t0
        key = "pipelined" if pipelined else "sequential"
        rep.detail[f"server_images_per_s_{key}"] = len(reqs) / sec
        log(f"  server {key}: {len(reqs)} images in {sec * 1e3:.1f} ms = "
            f"{len(reqs) / sec:.1f} images/s")
    return srv, reqs


def measure(rep: Report, shapes: dict, params, images_np) -> None:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.pool_act import maxpool_act

    cnn_layer_rows(rep, "CNNServer.run", shapes["conv"], shapes["fc"],
                   host=True)
    t = shapes["pool"]
    out = maxpool_act(t, window=3, stride=2, act="none")
    tc = t.permute(0, 3, 1, 2)
    add_row(rep, "maxpool_act", "CNNServer.run",
            f"conv2 map {tuple(t.shape)} 3/2",
            timed(lambda: maxpool_act(t, window=3, stride=2, act="none")),
            timed(lambda: ref.maxpool_act(t, window=3, stride=2,
                                          act="none")),
            timed(lambda: F.max_pool2d(tc, 3, 2)),
            out.numel() * 9, nbytes(t, out))
    pool_sweep(rep)

    srv, reqs = server_throughput(rep, params, images_np)
    copies = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv._to_device(reqs[:64])
        torch.cuda.synchronize()
        copies.append((time.perf_counter() - t0) * 1e3)
    rep.detail["input_copy_ms_b64"] = statistics.median(copies)
    log(f"  input stack + pin + copy to device, b=64: "
        f"{rep.detail['input_copy_ms_b64']:.3f} ms (host clock, median of 10)")


# ---------------------------------------------------------------------------
# phase 6: the LM slice (OLMo-1B, fp32, full width and depth)
# ---------------------------------------------------------------------------
def olmo_config():
    import dataclasses
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config("olmo-1b"), param_dtype="float32",
                               compute_dtype="float32")


def gemm_shapes(cfg, params, gen) -> list:
    """(label, x, w, act, launches per full-wave prefill) of every distinct
    SA-CONV GEMM shape of a full wave's prefill (m = 4 x 512), on layer 0's
    weights and the tied head, with normal inputs from ``gen``."""
    import torch
    m = LM_BATCH * LM_PROMPT
    d, ff, n = cfg.d_model, cfg.d_ff, cfg.n_layers
    blk = params["blocks"][0]
    x_d = torch.randn((m, d), generator=gen, device=DEVICE)
    x_ff = torch.randn((m, ff), generator=gen, device=DEVICE)
    out = [("attn.q/k/v/o", x_d, blk["attn"]["wq"][0], "none", 4 * n),
           ("mlp.gate/up", x_d, blk["mlp"]["wg"][0], "silu", 2 * n),
           ("mlp.down", x_ff, blk["mlp"]["wd"][0], "none", n),
           ("lm_head", x_d, params["embed_t"], "none", 1)]
    return [(f"{name} {w.shape[0]}x{w.shape[1]}", x, w, act, per)
            for name, x, w, act, per in out]


def check_lm_kernels(rep: Report, cfg, params) -> dict:
    """B4 and B5 against their plain versions at the path's shapes, plus a
    ragged GEMM, int8 weights, and the reference's attention cases."""
    import torch
    from repro_torch.core.quant import quantize
    from repro_torch.kernels import ref
    from repro_torch.kernels.attention import (HEAD_DIMS, flash_attention,
                                               flash_plain)
    from repro_torch.kernels.sa_conv import (sa_conv_matmul,
                                             sa_conv_matmul_plain)

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    shapes = {"gemm": gemm_shapes(cfg, params, gen)}
    outs = {}
    for label, x, w, act, _ in shapes["gemm"]:
        outs[label] = sa_conv_matmul(x, w, act=act)
        e = allclose(f"sa_conv_matmul {label}", outs[label],
                     sa_conv_matmul_plain(x, w, act=act), TOL_FC)
        rep.note_err("sa_conv_matmul", e)
        log(f"  sa_conv_matmul {label} m={x.shape[0]}: max|d| {e:.3g}")
    check_gemm_rows(shapes["gemm"], outs)
    x, w = shapes["gemm"][1][1], shapes["gemm"][1][2]
    qw = quantize(w)
    bias = torch.randn(w.shape[1], generator=gen, device=DEVICE)
    kw = dict(act="silu", w_scale=qw.scale)
    e8 = allclose("sa_conv_matmul int8 gate", sa_conv_matmul(x, qw.q, bias,
                                                             **kw),
                  sa_conv_matmul_plain(x, qw.q, bias, **kw), TOL_FC)
    xr = torch.randn((1000, 1001), generator=gen, device=DEVICE)
    wr = torch.randn((1001, 2999), generator=gen, device=DEVICE) * 0.03
    br = torch.randn(2999, generator=gen, device=DEVICE)
    er = allclose("sa_conv_matmul ragged 1000x1001x2999",
                  sa_conv_matmul(xr, wr, br, act="gelu"),
                  sa_conv_matmul_plain(xr, wr, br, act="gelu"), TOL_FC)
    rep.note_err("sa_conv_matmul", max(e8, er))
    log(f"  sa_conv_matmul int8 gate + bias + silu: max|d| {e8:.3g}; "
        f"ragged 1000x1001x2999 + gelu: {er:.3g}")
    check_gemm_unaligned(rep, shapes["gemm"][0][2], gen)

    b, s, h, hd = LM_BATCH, LM_PROMPT, cfg.n_heads, cfg.hd
    q, k, v = (torch.randn((b, s, h, hd), generator=gen, device=DEVICE)
               for _ in range(3))
    shapes["attn"] = (q, k, v)
    full = flash_attention(q, k, v)
    e = allclose("flash_attention OLMo prefill", full, flash_plain(q, k, v),
                 TOL_ATTN)
    rep.note_err("flash_attention", e)
    one = [t[-1:].contiguous() for t in (q, k, v)]
    e1 = allclose("flash_attention OLMo lone prefill",
                  flash_attention(*one), flash_plain(*one), TOL_ATTN)
    rep.note_err("flash_attention", e1)
    exact("flash_attention row 3 of b=4 == b=1", full[-1:],
          flash_attention(*one))
    log(f"  flash_attention {tuple(q.shape)} causal: max|d| {e:.3g}; "
        f"b=1: {e1:.3g}; row 3 of b=4 == b=1, bitwise ({geometry_log(q)})")
    cases = [(2, 256, 256, 4, 2, 64, 0, 0.0), (1, 256, 256, 8, 8, 32, 64, 0.0),
             (2, 128, 128, 4, 1, 64, 0, 50.0), (1, 1, 300, 4, 2, 64, 0, 0.0),
             (1, 1, 300, 4, 2, 64, 128, 0.0), (2, 200, 200, 2, 2, 48, 0, 0.0)]
    for cb, sq, skv, hq, hkv, d, window, softcap in cases:
        qc = torch.randn((cb, sq, hq, d), generator=gen, device=DEVICE)
        kc, vc = (torch.randn((cb, skv, hkv, d), generator=gen,
                              device=DEVICE) for _ in range(2))
        kw = dict(window=window, softcap=softcap)
        e = allclose(f"flash_attention case {sq}x{skv}",
                     flash_attention(qc, kc, vc, **kw),
                     ref.attention(qc, kc, vc, **kw), TOL_ATTN)
        rep.note_err("flash_attention", e)
    for d in HEAD_DIMS:
        qc = torch.randn((2, 300, 4, d), generator=gen, device=DEVICE)
        kc, vc = (torch.randn((2, 300, 2, d), generator=gen, device=DEVICE)
                  for _ in range(2))
        rep.note_err("flash_attention", allclose(
            f"flash_attention d={d}", flash_attention(qc, kc, vc),
            flash_plain(qc, kc, vc), TOL_ATTN))
    log(f"  flash_attention: the reference's 6 cases (GQA, window, softcap, "
        f"1 query x 300 keys, d=48) and every head dim {HEAD_DIMS} within "
        f"{TOL_ATTN}")
    check_lm_fc(rep, shapes["gemm"])
    torch.cuda.synchronize()
    return shapes


def check_gemm_rows(gemms: list, outs: dict) -> None:
    """B4's sums do not depend on m: rows 0 and m - 1 of the m = 2048
    launch equal m = 1 launches of those rows at q/k/v/o and the lm_head,
    and the first 512 rows of gate/up equal an m = 512 launch, bitwise.
    The kernel has one tiling, so no other tiling to compare."""
    from repro_torch.kernels.sa_conv import BM, BN, sa_conv_matmul
    for label, x, w, act, _ in (gemms[0], gemms[3]):
        m = x.shape[0]
        for r in (0, m - 1):
            exact(f"sa_conv_matmul {label} row {r} of m={m} == m=1",
                  outs[label][r:r + 1],
                  sa_conv_matmul(x[r:r + 1].contiguous(), w, act=act))
    label, x, w, act, _ = gemms[1]
    exact(f"sa_conv_matmul {label} rows :{LM_PROMPT} of m={x.shape[0]} == "
          f"m={LM_PROMPT}", outs[label][:LM_PROMPT],
          sa_conv_matmul(x[:LM_PROMPT].contiguous(), w, act=act))
    m = x.shape[0]
    log(f"  sa_conv_matmul: rows 0 and {m - 1} of m={m} == m=1 (q/k/v/o, "
        f"lm_head), rows :{LM_PROMPT} of gate/up == m={LM_PROMPT}, bitwise; "
        f"one tiling ({BM} x {BN}), so no other to compare")


def check_gemm_unaligned(rep: Report, w, gen) -> None:
    """B4 on x and w taken one element into their buffers (narrower w
    copies), fp32 and int8, against its plain version and, bitwise, the
    aligned launch."""
    import torch
    from repro_torch.core.quant import quantize
    from repro_torch.kernels.sa_conv import (copy_bytes, sa_conv_matmul,
                                             sa_conv_matmul_plain)
    k, n = w.shape
    x = torch.randn((300, k), generator=gen, device=DEVICE)
    qt = quantize(w)
    bias = torch.randn(n, generator=gen, device=DEVICE)
    xo = torch.empty(x.numel() + 1, device=DEVICE)[1:].view(x.shape)
    xo.copy_(x)
    errs = []
    for wt, ww, scale in (("fp32", w, None), ("int8", qt.q, qt.scale)):
        wo = torch.empty(ww.numel() + 1, dtype=ww.dtype,
                         device=DEVICE)[1:].view(ww.shape)
        wo.copy_(ww)
        got = sa_conv_matmul(xo, wo, bias, act="relu", w_scale=scale)
        e = allclose(f"sa_conv_matmul {wt} off 16-byte alignment", got,
                     sa_conv_matmul_plain(x, ww, bias, act="relu",
                                          w_scale=scale), TOL_FC)
        rep.note_err("sa_conv_matmul", e)
        exact(f"sa_conv_matmul {wt} off alignment == aligned", got,
              sa_conv_matmul(x, ww, bias, act="relu", w_scale=scale))
        cb = copy_bytes(n * ww.element_size(), wo.data_ptr())
        errs.append(f"{wt} max|d| {e:.3g} ("
                    f"{f'{cb}-byte w copies' if cb else 'w element loads'})")
    log(f"  sa_conv_matmul x and w one element into their buffers, "
        f"300x{k}x{n}: {'; '.join(errs)}; == aligned, bitwise")


def check_lm_fc(rep: Report, gemms: list) -> None:
    """B1 at the OLMo shapes it runs on the path: b = 4 (every decode step)
    and m = 512 (a lone request's prefill), with fp32 and int8 weights,
    against its plain version; row 0 at b = 4 and at b = 512 bitwise equal
    to b = 1."""
    from repro_torch.core.quant import quantize
    from repro_torch.kernels.sa_fc import fc_launch, sa_fc_matmul, sa_fc_plain
    for label, x, w, act, _ in gemms:
        k, n = w.shape
        qt = quantize(w)
        for wt, ww, scale in (("fp32", w, None), ("int8", qt.q, qt.scale)):
            one = sa_fc_matmul(x[:1].contiguous(), ww, act=act,
                               w_scale=scale)
            errs = []
            for m in (LM_BATCH, LM_PROMPT):
                h = x[:m].contiguous()
                got = sa_fc_matmul(h, ww, act=act, w_scale=scale)
                e = allclose(f"sa_fc_matmul {label} b={m} {wt}", got,
                             sa_fc_plain(h, ww, act=act, w_scale=scale),
                             TOL_FC)
                rep.note_err("sa_fc_matmul", e)
                exact(f"sa_fc_matmul {label} {wt} row 0 of b={m} == b=1",
                      got[:1], one)
                plan = fc_launch(m, k, n)
                errs.append(f"b={m} max|d| {e:.3g} ({plan.ctas} CTAs, "
                            f"S={plan.segments} "
                            f"{'split' if plan.split else 'whole'})")
            log(f"  sa_fc_matmul {label} {wt}: {'; '.join(errs)}; row 0 == "
                "b=1")
        del qt


def teacher_forced(cfg, params, prompt, output, eng, cache_dtype=None):
    """Per-step logits (len(output), V) of one request under ``eng``, fed
    the served tokens (prefill, then one decode step per output token),
    with a cache of ``cache_dtype`` (fp32 by default)."""
    import torch
    from repro_torch.serve.serve_step import decode_step, prefill_step
    tok = torch.as_tensor(prompt, dtype=torch.int64, device=DEVICE)[None]
    with eng.activate():
        logits, cache = prefill_step(cfg, params, {"tokens": tok},
                                     LM_MAX_SEQ, cache_dtype or torch.float32)
        rows = [logits[0].cpu()]
        for i in range(1, len(output)):
            t = torch.tensor([[int(output[i - 1])]], device=DEVICE)
            logits, cache = decode_step(cfg, params, cache, t,
                                        len(prompt) + i - 1)
            rows.append(logits[0].cpu())
    return torch.stack(rows)


def check_tokens(name: str, want_logits, output, tol: dict) -> int:
    """Served tokens equal the argmax of ``want_logits`` wherever its top-2
    margin exceeds the logits tolerance; returns how many steps that
    covered."""
    import numpy as np
    top2 = want_logits.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1] > 2 * tol["atol"]).numpy()
    argmax = want_logits.argmax(-1).numpy()
    if not np.array_equal(np.asarray(output)[clear], argmax[clear]):
        raise AssertionError(f"{name}: tokens differ at a clear margin")
    return int(clear.sum())


def lm_requests(cfg):
    import numpy as np
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab_size, (LM_REQUESTS, LM_PROMPT))
    return [Request(uid=i, prompt=p, max_new=LM_NEW)
            for i, p in enumerate(prompts)]


def serve_lm(rep: Report, cfg, params) -> dict:
    import numpy as np
    import torch
    from repro_torch.core.engine import Engine
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeEngine

    n_layers = cfg.n_layers
    per_pass = 7 * n_layers + 1                 # projections + lm_head
    srv = ServeEngine(cfg, params, batch_size=LM_BATCH, max_seq=LM_MAX_SEQ)
    if srv.engine.backend != "kernels":
        raise AssertionError("ServeEngine's default backend is not kernels")
    for r in lm_requests(cfg):
        srv.submit(r)
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    with srv.engine.tracing() as tr:
        done = srv.run()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    c = counters()
    full_waves = LM_REQUESTS // LM_BATCH
    decode_steps = (LM_NEW - 1) * (full_waves + 1)
    expect_counts(c, "ServeEngine.run",
                  sa_conv_matmul=per_pass * full_waves,
                  flash_attention=n_layers * (full_waves + 1),
                  sa_fc_matmul=per_pass * (1 + decode_steps))
    mm = [x for x in tr if x.regime in ("sa_conv", "sa_fc")]
    if not mm or any(x.schedule != "hit" for x in mm):
        raise AssertionError("ServeEngine.run: a matmul missed its schedule")
    if len(done) != LM_REQUESTS or not all(r.done for r in done):
        raise AssertionError(f"served {len(done)} of {LM_REQUESTS}")
    logits = np.stack([r.logits for r in done])
    if logits.shape != (LM_REQUESTS, LM_NEW, cfg.vocab_size) or \
            not np.isfinite(logits).all():
        raise AssertionError(f"logits {logits.shape} not finite or shaped")
    log(f"  served {LM_REQUESTS} requests (waves 4, 4, 1) in {first_s:.2f}s "
        f"(schedules compiled on the way); {len(mm)} matmuls, all schedule "
        f"hits; launches {c}")
    rep.detail["lm_launches_per_run"] = c

    # against the plain "torch" backend on the card, teacher-forced with the
    # served tokens: a request of a full wave and the lone request
    plain = Engine(backend="torch")
    err, covered = 0.0, 0
    for r in (done[0], done[-1]):
        want = teacher_forced(cfg, params, r.prompt, r.output, plain)
        err = max(err, allclose(f"request {r.uid} logits vs torch backend",
                                torch.from_numpy(r.logits), want, TOL_LM))
        covered += check_tokens(f"request {r.uid}", want, r.output, TOL_LM)
    rep.detail["lm_logits_max_abs_err"] = err
    log(f"  logits vs torch backend (requests 0 and 8, teacher-forced): "
        f"max|d| {err:.3g} (|logits| max {np.abs(logits).max():.3g}); tokens "
        f"equal at {covered} of {2 * LM_NEW} steps with a clear margin")

    # incremental decode == a teacher-forced full forward (the reference's
    # invariant, tests/test_serve.py), on the kernels
    r = done[-1]
    seq = np.concatenate([r.prompt, r.output[:-1]])
    with Engine(backend="kernels").activate():
        full, _, _ = T.forward(cfg, params, {"tokens": torch.as_tensor(
            seq, dtype=torch.int64, device=DEVICE)[None]})
    e = allclose("decode vs full forward", torch.from_numpy(r.logits),
                 full[0, LM_PROMPT - 1:].cpu(), TOL_LM)
    rep.detail["lm_decode_vs_forward_max_abs_err"] = e
    log(f"  incremental decode vs full forward over {len(seq)} tokens: "
        f"max|d| {e:.3g}")
    return dict(launches=c)


def lm_throughput(rep: Report, cfg, params, cache_dtype=None,
                  prefix: str = "lm") -> None:
    """Host clock around drained work after warm-up: one full-wave prefill,
    one decode step at b=4, and a whole ``ServeEngine.run`` of 9 requests
    (schedules already compiled), with a cache of ``cache_dtype`` (fp32 by
    default); the numbers go to ``rep.detail`` as ``<prefix>_*``."""
    import numpy as np
    import torch
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.serve_step import decode_step, prefill_step

    cache_dtype = cache_dtype or torch.float32
    srv = ServeEngine(cfg, params, batch_size=LM_BATCH, max_seq=LM_MAX_SEQ,
                      cache_dtype=cache_dtype)
    reqs = lm_requests(cfg)
    toks = torch.as_tensor(np.stack([r.prompt for r in reqs[:LM_BATCH]]),
                           dtype=torch.int64, device=DEVICE)
    psched = srv._schedule("prefill", LM_BATCH, LM_PROMPT)
    times = {"prefill": [], "decode": []}
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with srv.engine.with_schedule(psched).activate():
            logits, cache = prefill_step(cfg, params, {"tokens": toks},
                                         LM_MAX_SEQ, cache_dtype)
        torch.cuda.synchronize()
        times["prefill"].append(time.perf_counter() - t0)
        tok = logits.argmax(-1)[:, None]
        with srv.engine.with_schedule(srv.decode_schedule).activate():
            for i in range(LM_NEW - 1):
                t0 = time.perf_counter()
                logits, cache = decode_step(cfg, params, cache, tok,
                                            LM_PROMPT + i)
                tok = logits.argmax(-1)[:, None]
                tok.cpu()
                times["decode"].append(time.perf_counter() - t0)
    prefill_s = statistics.median(times["prefill"][1:])
    decode_s = statistics.median(times["decode"][LM_NEW - 1:])

    def prefill():
        with srv.engine.with_schedule(psched).activate():
            return prefill_step(cfg, params, {"tokens": toks}, LM_MAX_SEQ,
                                cache_dtype)

    def decode():
        with srv.engine.with_schedule(srv.decode_schedule).activate():
            decode_step(cfg, params, cache, tok, LM_PROMPT)[0].cpu()

    busy = {"prefill": device_busy(prefill, prefill_s),
            "decode": device_busy(decode, decode_s)}
    for r in reqs:
        srv.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srv.run()
    run_s = time.perf_counter() - t0
    d = rep.detail
    d[f"{prefix}_prefill_wave_ms"] = prefill_s * 1e3
    d[f"{prefix}_prefill_tokens_per_s"] = LM_BATCH * LM_PROMPT / prefill_s
    d[f"{prefix}_decode_step_ms"] = decode_s * 1e3
    d[f"{prefix}_decode_tokens_per_s"] = LM_BATCH / decode_s
    d[f"{prefix}_run_s"] = run_s
    d[f"{prefix}_run_new_tokens_per_s"] = LM_REQUESTS * LM_NEW / run_s
    d[f"{prefix}_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    d[f"{prefix}_device_busy"] = busy
    log(f"  prefill of a full wave ({LM_BATCH} x {LM_PROMPT} tokens): "
        f"{prefill_s * 1e3:.1f} ms = {d[f'{prefix}_prefill_tokens_per_s']:.0f} "
        f"tokens/s; decode step at b={LM_BATCH}: "
        f"{decode_s * 1e3:.2f} ms = {d[f'{prefix}_decode_tokens_per_s']:.1f} "
        f"tokens/s (host clock, medians)")
    for phase, b in busy.items():
        if b["device_ms"] is None:
            log(f"  {phase}: device busy time not measured (the profiler "
                "recorded no device event)")
            continue
        log(f"  {phase}: device busy {b['device_ms']:.2f} ms of "
            f"{b['wall_ms']:.2f} ms (idle share {b['idle_share']:.3f}; "
            f"torch.profiler); top kernels {b['top']}")
    log(f"  ServeEngine.run, {LM_REQUESTS} requests: {run_s:.2f} s = "
        f"{d[f'{prefix}_run_new_tokens_per_s']:.1f} new tokens/s; peak memory "
        f"{d[f'{prefix}_peak_mem_gb']:.1f} GB")


def device_busy(fn, wall_s: float, top: int = 4) -> dict:
    """Device time of one call of ``fn`` from a ``torch.profiler`` trace
    (the sum of the device-side kernel events), against ``wall_s``, the
    host-clock time of the same work measured without the profiler.
    Where the trace holds no device event, the device time is reported as
    not measured (None)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / 1e3, e.key, e.count))
    rows.sort(reverse=True)
    dev_ms = sum(r[0] for r in rows) or None
    return dict(device_ms=dev_ms, wall_ms=wall_s * 1e3,
                idle_share=None if dev_ms is None else
                max(0.0, 1 - dev_ms / (wall_s * 1e3)),
                top=[(k[:40], round(ms, 3), n) for ms, k, n in rows[:top]])


def measure_lm(rep: Report, shapes: dict) -> None:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.attention import flash_attention, flash_plain
    from repro_torch.kernels.sa_conv import (sa_conv_matmul,
                                             sa_conv_matmul_plain)
    from repro_torch.kernels.sa_fc import sa_fc_matmul, sa_fc_plain

    def row(kernel, label, ms, plain_ms, lib_ms, flops, nb, per_pass,
            phase="prefill", host=None, smi=None):
        add_row(rep, kernel, "ServeEngine.run", label, ms, plain_ms, lib_ms,
                flops, nb, per_pass=per_pass, phase=phase, host=host,
                smi=smi)

    for label, x, w, act, per_pass in shapes["gemm"]:
        m, k = x.shape
        n = w.shape[1]
        out = sa_conv_matmul(x, w, act=act)
        kern = functools.partial(sa_conv_matmul, x, w, act=act)
        row("sa_conv_matmul", f"{label} m={m}", timed(kern),
            timed(lambda: sa_conv_matmul_plain(x, w, act=act), runs=3,
                  warmup=1),
            timed(lambda: ref.apply_act(torch.mm(x, w), act)),
            2 * m * n * k, nbytes(x, w, out), per_pass, smi=smi_sample(kern))
    # flash at a full wave's prefill and a lone request's, one launch per
    # layer each
    n_layers = olmo_config().n_layers
    for phase, (q, k, v) in (("prefill", shapes["attn"]),
                             ("lone prefill", [t[-1:].contiguous()
                                               for t in shapes["attn"]])):
        b, s, h, d = q.shape
        out = flash_attention(q, k, v)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        pairs = s * (s + 1) // 2                # unmasked (query, key) pairs
        row("flash_attention", f"{tuple(q.shape)} causal, "
            f"{geometry_log(q)}",
            timed(lambda: flash_attention(q, k, v)),
            timed(lambda: flash_plain(q, k, v), runs=5, warmup=1),
            timed(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                         is_causal=True)),
            4 * b * h * pairs * d, nbytes(q, k, v, out), n_layers,
            phase=phase)

    # SA-FC at the decode shapes (b = 4), the weight stream of every step,
    # and at m = 512, every projection of a lone request's prefill
    for m, phase, plain_runs in ((LM_BATCH, "decode", 5),
                                 (LM_PROMPT, "lone prefill", 2)):
        for label, x, w, act, per_pass in shapes["gemm"]:
            h = x[:m].contiguous()
            kk, n = w.shape
            out = sa_fc_matmul(h, w, act=act)
            kern = functools.partial(sa_fc_matmul, h, w, act=act)
            row("sa_fc_matmul", f"{label} b={m}", timed(kern),
                timed(lambda: sa_fc_plain(h, w, act=act), runs=plain_runs,
                      warmup=1),
                timed(lambda: ref.apply_act(torch.mm(h, w), act)),
                2 * m * n * kk, nbytes(h, w, out), per_pass, phase=phase,
                host=host_costs(kern))


# ---------------------------------------------------------------------------
# phase 7: OLMo-1B as published (bf16 parameters, compute and cache)
# ---------------------------------------------------------------------------
def olmo_bf16_config():
    """OLMo-1B as ``configs/olmo_1b.py`` publishes it, bf16 throughout."""
    from repro_torch.configs.registry import get_config
    cfg = get_config("olmo-1b")
    if (cfg.param_dtype, cfg.compute_dtype) != ("bfloat16", "bfloat16"):
        raise AssertionError(f"olmo-1b is published in {cfg.param_dtype} / "
                             f"{cfg.compute_dtype}, not bf16")
    return cfg


def check_widened(name: str, got, kern, *args, **kw) -> None:
    """``got``, a launch on bf16 operands, equals the fp32 launch of
    ``kern`` on the widened operands rounded once to ``got``'s dtype,
    bitwise: the kernels widen bf16 exactly and keep fp32's sums and
    order."""
    import torch
    wide = [a.float() if isinstance(a, torch.Tensor) and
            a.dtype == torch.bfloat16 else a for a in args]
    exact(f"{name} == the fp32 launch on the widened operands", got,
          kern(*wide, **kw).to(got.dtype))


def check_lm_kernels_bf16(rep: Report, cfg, params) -> dict:
    """B4, B1 and B5 with bf16 activations at the served shapes: the
    GEMM at a full wave's four prefill shapes (bf16 weights; the head also
    with fp32 logits), SA-FC at b = 4 and m = 512 with bf16, int8 and fp32
    weights, flash at a full wave's and a lone request's prefill; each
    against its plain version, the bitwise batch invariants, and each
    equal to the fp32 launch on the widened operands."""
    import torch
    from repro_torch.core.quant import quantize
    from repro_torch.kernels.attention import flash_attention, flash_plain
    from repro_torch.kernels.sa_conv import (sa_conv_matmul,
                                             sa_conv_matmul_plain)
    from repro_torch.kernels.sa_fc import sa_fc_matmul, sa_fc_plain
    bf = torch.bfloat16
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    gemms = [(label, x.to(bf), w, act, per)
             for label, x, w, act, per in gemm_shapes(cfg, params, gen)]
    name = BF16_KERNELS["sa_conv_matmul"]
    outs = {}
    for label, x, w, act, _ in gemms:
        if w.dtype != bf:
            raise AssertionError(f"{label}: weights are {w.dtype}")
        got = outs[label] = sa_conv_matmul(x, w, act=act)
        if got.dtype != bf:
            raise AssertionError(f"{name} {label}: wrote {got.dtype}")
        e = allclose(f"{name} {label}", got,
                     sa_conv_matmul_plain(x, w, act=act), TOL_BF16)
        check_widened(f"{name} {label}", got, sa_conv_matmul, x, w, act=act)
        rep.note_err(name, e)
        log(f"  {name} {label} m={x.shape[0]}: max|d| {e:.3g}; == fp32 on "
            "the widened operands")
    label, x, w, _, _ = gemms[3]
    logits = sa_conv_matmul(x, w, out_dtype=torch.float32)
    rep.note_err(name, allclose(
        f"{name} {label} fp32 logits", logits,
        sa_conv_matmul_plain(x, w, out_dtype=torch.float32), TOL_BF16))
    check_widened(f"{name} {label} fp32 logits", logits, sa_conv_matmul,
                  x, w, out_dtype=torch.float32)
    del logits
    check_gemm_rows(gemms, outs)
    del outs

    name = BF16_KERNELS["sa_fc_matmul"]
    for label, x, w, act, _ in gemms:
        qt = quantize(w.float())
        for wt, ww, scale in (("bf16", w, None), ("int8", qt.q, qt.scale),
                              ("fp32", w.float(), None)):
            one = sa_fc_matmul(x[:1].contiguous(), ww, act=act,
                               w_scale=scale)
            errs = []
            for m in (LM_BATCH, LM_PROMPT):
                h = x[:m].contiguous()
                got = sa_fc_matmul(h, ww, act=act, w_scale=scale)
                e = allclose(f"{name} {label} b={m} {wt}", got,
                             sa_fc_plain(h, ww, act=act, w_scale=scale),
                             TOL_BF16)
                rep.note_err(name, e)
                exact(f"{name} {label} {wt} row 0 of b={m} == b=1", got[:1],
                      one)
                if m == LM_BATCH:
                    check_widened(f"{name} {label} b={m} {wt}", got,
                                  sa_fc_matmul, h, ww.to(bf).float()
                                  if wt == "fp32" else ww, act=act,
                                  w_scale=scale)
                errs.append(f"b={m} max|d| {e:.3g}")
            log(f"  {name} {label} {wt} weights: {'; '.join(errs)}; row 0 "
                "== b=1, b=4 == fp32 on the widened operands")
        del qt
    label, x, w, _, _ = gemms[3]
    h = x[:LM_BATCH].contiguous()
    rep.note_err(name, allclose(
        f"{name} {label} b={LM_BATCH} fp32 logits",
        sa_fc_matmul(h, w, out_dtype=torch.float32),
        sa_fc_plain(h, w, out_dtype=torch.float32), TOL_BF16))

    name = BF16_KERNELS["flash_attention"]
    q, k, v = (torch.randn((LM_BATCH, LM_PROMPT, cfg.n_heads, cfg.hd),
                           generator=gen, device=DEVICE).to(bf)
               for _ in range(3))
    full = flash_attention(q, k, v)
    e = allclose(f"{name} OLMo prefill", full, flash_plain(q, k, v),
                 TOL_BF16)
    check_widened(f"{name} OLMo prefill", full, flash_attention, q, k, v)
    one = [t[-1:].contiguous() for t in (q, k, v)]
    lone = flash_attention(*one)
    e1 = allclose(f"{name} OLMo lone prefill", lone, flash_plain(*one),
                  TOL_BF16)
    exact(f"{name} row 3 of b=4 == b=1", full[-1:], lone)
    rep.note_err(name, max(e, e1))
    log(f"  {name} {tuple(q.shape)} causal: max|d| {e:.3g}; b=1: {e1:.3g}; "
        "row 3 of b=4 == b=1 and == fp32 on the widened operands, bitwise")
    torch.cuda.synchronize()
    return {"gemm": gemms, "attn": (q, k, v)}


def schedule_launches(srv, cfg, waves: list[int]) -> dict:
    """Launches per kernel that ``ServeEngine.run`` must make for waves of
    ``waves`` requests of ``LM_PROMPT`` tokens and ``LM_NEW`` new tokens:
    each matmul of a schedule runs on its regime's kernel once per layer
    (the head once per pass), each prefill attention on flash once per
    layer."""
    kernel = {"sa_conv": "sa_conv_matmul", "sa_fc": "sa_fc_matmul"}
    out = {"sa_conv_matmul": 0, "sa_fc_matmul": 0,
           "flash_attention": cfg.n_layers * len(waves)}
    for b in waves:
        for sched, passes in (
                (srv._schedule("prefill", b, LM_PROMPT), 1),
                (srv.decode_schedule if b == srv.batch_size
                 else srv._schedule("decode", b), LM_NEW - 1)):
            for key in sched:
                per = 1 if key.name == "lm_head" else cfg.n_layers
                out[kernel[sched[key].regime]] += per * passes
    return out


def serve_lm_bf16(rep: Report, cfg, params) -> dict:
    """``ServeEngine`` with bf16 parameters, compute and cache: every
    matmul a schedule hit, launches as the schedules say, no plain version
    called; the teacher-forced logits of two requests on the kernels no
    farther from the ``"torch"`` backend's bf16 logits than those are from
    its fp32 logits (on the same weights, widened), and the lone request's
    served logits bitwise its teacher-forced ones.  A request served in a
    wave of 4 is only compared, not bounded: the plain PyTorch ops around
    the kernels (norms, decode attention) may sum in another order at b =
    4 than at b = 1, which moves bf16 roundings."""
    import numpy as np
    import torch
    from repro_torch.core.engine import Engine
    from repro_torch.serve.engine import ServeEngine

    bf = torch.bfloat16
    srv = ServeEngine(cfg, params, batch_size=LM_BATCH, max_seq=LM_MAX_SEQ,
                      cache_dtype=bf)
    if srv.engine.backend != "kernels":
        raise AssertionError("ServeEngine's default backend is not kernels")
    for r in lm_requests(cfg):
        srv.submit(r)
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    with srv.engine.tracing() as tr:
        done = srv.run()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    c = counters()
    full = LM_REQUESTS // LM_BATCH
    waves = [LM_BATCH] * full + ([LM_REQUESTS % LM_BATCH]
                                 if LM_REQUESTS % LM_BATCH else [])
    want = schedule_launches(srv, cfg, waves)
    expect_counts(c, "ServeEngine.run bf16", **want)
    mm = [x for x in tr if x.regime in ("sa_conv", "sa_fc")]
    if not mm or any(x.schedule != "hit" or x.dtype != "bfloat16"
                     or x.weight_dtype != "bfloat16" for x in mm):
        raise AssertionError("ServeEngine.run bf16: a matmul missed its "
                             "schedule or ran in another dtype")
    if len(done) != LM_REQUESTS or not all(r.done for r in done):
        raise AssertionError(f"served {len(done)} of {LM_REQUESTS}")
    logits = np.stack([r.logits for r in done])
    if logits.shape != (LM_REQUESTS, LM_NEW, cfg.vocab_size) or \
            not np.isfinite(logits).all():
        raise AssertionError(f"logits {logits.shape} not finite or shaped")
    log(f"  served {LM_REQUESTS} requests (waves {waves}) in {first_s:.2f}s "
        f"(schedules compiled on the way); {len(mm)} matmuls, all bf16 "
        f"schedule hits; launches {c} == the schedules' {want}")
    rep.detail["lm_bf16_launches_per_run"] = c

    import dataclasses
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    params32 = widen_tree(params)
    plain = Engine(backend="torch")
    err = spread = served = 0.0
    covered = 0
    sq = {"kernels_vs_torch": 0.0, "torch_bf16_vs_fp32": 0.0}
    for r in (done[0], done[-1]):
        got = teacher_forced(cfg, params, r.prompt, r.output, srv.engine, bf)
        want16 = teacher_forced(cfg, params, r.prompt, r.output, plain, bf)
        want32 = teacher_forced(cfg32, params32, r.prompt, r.output, plain)
        if not (torch.isfinite(got).all() and torch.isfinite(want16).all()):
            raise AssertionError("teacher-forced bf16 logits not finite")
        err = max(err, (got - want16).abs().max().item())
        s = (want16 - want32).abs().max().item()
        spread = max(spread, s)
        sq["kernels_vs_torch"] += (got - want16).double().pow(2).mean().item()
        sq["torch_bf16_vs_fp32"] += \
            (want16 - want32).double().pow(2).mean().item()
        covered += check_tokens(f"request {r.uid} bf16", want16, r.output,
                                dict(atol=s))
        served_r = torch.from_numpy(r.logits)
        if r is done[-1]:
            # the lone request was served at b = 1, as it is fed here
            exact(f"request {r.uid} served bf16 logits == teacher-forced",
                  served_r, got)
        served = max(served, (served_r - got).abs().max().item())
    del params32
    torch.cuda.empty_cache()
    d = rep.detail
    d["lm_bf16_logits_max_abs_err"] = err
    d["lm_bf16_vs_fp32_spread"] = spread
    d["lm_bf16_served_vs_teacher_forced"] = served
    rms = {k: (v / 2) ** 0.5 for k, v in sq.items()}
    d["lm_bf16_logits_rms"] = rms
    if not err <= spread:
        raise AssertionError(f"bf16 logits: kernels vs torch backend max|d| "
                             f"{err:.4g} > the torch backend's bf16 vs fp32 "
                             f"spread {spread:.4g}")
    log(f"  teacher-forced bf16 logits, kernels vs torch backend (requests 0 "
        f"and 8): max|d| {err:.4g} <= the torch backend's bf16 vs fp32 "
        f"spread {spread:.4g} (|logits| max {np.abs(logits).max():.3g}); "
        f"tokens equal at {covered} of {2 * LM_NEW} steps with a clear "
        f"margin; RMS {rms['kernels_vs_torch']:.4g} against "
        f"{rms['torch_bf16_vs_fp32']:.4g}; served logits vs teacher-forced: "
        f"request 8 (b = 1) bitwise, request 0 (served at b = 4) max|d| "
        f"{served:.4g}")
    return dict(launches=c)


def widen_tree(params):
    """A copy of a parameter tree with every bf16 leaf widened to fp32."""
    import torch
    from repro_torch.core import tree
    return tree.map_leaves(
        lambda t: t.float() if t.dtype == torch.bfloat16 else t, params)


def measure_lm_bf16(rep: Report, shapes: dict) -> None:
    """Card time of each bf16 kernel at its served shapes, beside its bound
    (bf16's tensor-core rate for the operations) and the bf16 library
    call: the GEMM at a full wave's prefill (and a lone request's, m =
    512), flash at both prefills, SA-FC at a decode step (b = 4)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.attention import flash_attention, flash_plain
    from repro_torch.kernels.sa_conv import (sa_conv_matmul,
                                             sa_conv_matmul_plain)
    from repro_torch.kernels.sa_fc import sa_fc_matmul, sa_fc_plain

    def row(kernel, label, ms, plain_ms, lib_ms, flops, nb, per_pass,
            phase, host=None):
        add_row(rep, kernel, "ServeEngine.run bf16", label, ms, plain_ms,
                lib_ms, flops, nb, peak=PEAK_BF16_FLOPS, per_pass=per_pass,
                phase=phase, host=host)

    name = BF16_KERNELS["sa_conv_matmul"]
    for m, phase in ((LM_BATCH * LM_PROMPT, "prefill"),
                     (LM_PROMPT, "lone prefill")):
        for label, x, w, act, per_pass in shapes["gemm"]:
            h = x[:m].contiguous()
            n, k = w.shape[1], w.shape[0]
            out = sa_conv_matmul(h, w, act=act)
            row(name, f"{label} m={m}",
                timed(lambda: sa_conv_matmul(h, w, act=act)),
                timed(lambda: sa_conv_matmul_plain(h, w, act=act), runs=3,
                      warmup=1) if phase == "prefill" else
                timed(lambda: sa_conv_matmul_plain(h, w, act=act), runs=2,
                      warmup=1),
                timed(lambda: ref.apply_act(torch.mm(h, w), act)),
                2 * m * n * k, nbytes(h, w, out), per_pass, phase)
    name = BF16_KERNELS["flash_attention"]
    n_layers = olmo_bf16_config().n_layers
    for phase, (q, k, v) in (("prefill", shapes["attn"]),
                             ("lone prefill", [t[-1:].contiguous()
                                               for t in shapes["attn"]])):
        b, s, hh, d = q.shape
        out = flash_attention(q, k, v)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        pairs = s * (s + 1) // 2
        row(name, f"{tuple(q.shape)} causal, {geometry_log(q)}",
            timed(lambda: flash_attention(q, k, v)),
            timed(lambda: flash_plain(q, k, v), runs=5, warmup=1),
            timed(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                         is_causal=True)),
            4 * b * hh * pairs * d, nbytes(q, k, v, out), n_layers, phase)
    name = BF16_KERNELS["sa_fc_matmul"]
    for label, x, w, act, per_pass in shapes["gemm"]:
        h = x[:LM_BATCH].contiguous()
        kk, n = w.shape
        out = sa_fc_matmul(h, w, act=act)
        kern = functools.partial(sa_fc_matmul, h, w, act=act)
        row(name, f"{label} b={LM_BATCH}", timed(kern),
            timed(lambda: sa_fc_plain(h, w, act=act), runs=5, warmup=1),
            timed(lambda: ref.apply_act(torch.mm(h, w), act)),
            2 * LM_BATCH * n * kk, nbytes(h, w, out), per_pass, "decode",
            host=host_costs(kern))


# ---------------------------------------------------------------------------
# phase 8: the model zoo at full width (AlexNet, VGG-16, int8 AlexNet), and
# bf16 activations through SA-CONV implicit and the pool (C6)
# ---------------------------------------------------------------------------
def zoo_launches(decisions) -> dict:
    """Launches per kernel that the executed waves of ``decisions`` must
    make, from the decisions alone: ZOO_CONVS SA-CONV launches (every pool
    fused) and ZOO_FCS SA-FC launches per wave of the variant's net, no
    pool and no GEMM launch.  Dispatch failures and timed-out waves run no
    kernel."""
    from repro_torch.configs.registry import get_zoo_model
    waves = [get_zoo_model(d.model).net for d in decisions
             if d.fault not in ("dispatch", "timeout")]
    return dict(sa_conv_implicit=sum(ZOO_CONVS[net] for net in waves),
                sa_fc_matmul=ZOO_FCS * len(waves))


def check_bf16_cnn(rep: Report, models: dict, images: dict) -> dict:
    """C6 on the card: SA-CONV implicit in bf16 at AlexNet conv1-conv5 and
    VGG-16 conv1_2, conv3_3, conv5_3 (b = 64, fp32 and int8 filters, pools
    fused and unfused), the pool in bf16 at every ``POOL_SWEEP`` map.  Each
    within TOL_BF16 of its plain version and bitwise the fp32 launch on
    the widened operands, rounded once; fused == conv -> pool kernel and
    rows of b = 64 == b = 1, bitwise.  Then the two bf16 paths the kernels
    line reads: AlexNet's forward with bf16 activations (b = 64; its
    fc1-fc3 within TOL_BF16 of sa_fc_plain and bitwise the fp32 launch on
    the widened operands, its logits within TOL_BF16 of the torch
    backend's bf16 forward) and the declined-fusion dispatch in bf16.
    Returns their launches and the inputs each kernel sees, for timing."""
    import torch
    from repro_torch.core.dataflow import PoolSpec
    from repro_torch.core.engine import Engine
    from repro_torch.core.quant import quantize
    from repro_torch.kernels import ref
    from repro_torch.kernels.pool_act import maxpool_act
    from repro_torch.kernels.sa_conv_implicit import (sa_conv_implicit,
                                                      sa_conv_plain)
    from repro_torch.kernels.sa_fc import sa_fc_matmul, sa_fc_plain
    from repro_torch.models import cnn
    bf16 = torch.bfloat16
    conv_name = CNN_BF16_KERNELS["sa_conv_implicit"]
    pool_name = CNN_BF16_KERNELS["maxpool_act"]
    out: dict = {"conv": [], "pool": None}
    for net, layers in BF16_CONV_LAYERS.items():
        chain, _, _ = layer_chain(net, models[net].params, images[net])
        for label, xin, p, _, conv_kw in chain:
            if label not in layers:
                continue
            xb = xin.to(bf16)
            pw, ps = conv_kw["pool_window"], conv_kw["pool_stride"]
            pool = pw > 0
            kw = dict(stride=conv_kw["stride"], act=conv_kw["act"])
            qt = quantize(p["f"])
            for wdtype, f, scale, wide in (
                    ("fp32", p["f"], None, p["f"].to(bf16).float()),
                    ("int8", qt.q, qt.scale, qt.q.float())):
                unfused = None
                for k in ([dict(kw, pool_window=pw, pool_stride=ps), kw]
                          if pool else [kw]):
                    what = (f"{net} {label} bf16 {wdtype}"
                            f"{' pool' if k.get('pool_window') else ''}")
                    got = sa_conv_implicit(xb, f, p["b"], w_scale=scale,
                                           **k)
                    if got.dtype != bf16:
                        raise AssertionError(f"{what}: wrote {got.dtype}")
                    rep.note_err(conv_name, allclose(
                        what, got.float(), sa_conv_plain(
                            xb, f, p["b"], w_scale=scale, **k).float(),
                        TOL_BF16))
                    exact(f"{what} == fp32 on the widened operands",
                          got, sa_conv_implicit(xb.float(), wide, p["b"],
                                                w_scale=scale, **k).to(bf16))
                    for lo, hi in ((0, 1), (63, 64)):
                        exact(f"{what} rows {lo}:{hi} of b=64 == b=1",
                              got[lo:hi], sa_conv_implicit(
                                  xb[lo:hi].contiguous(), f, p["b"],
                                  w_scale=scale, **k))
                    if k is kw:
                        unfused = got
                    else:
                        fused = got
                if pool:
                    exact(f"{net} {label} bf16 {wdtype} fused == conv -> "
                          "pool", fused, maxpool_act(unfused, window=pw,
                                                     stride=ps, act="none"))
                    if net == "alexnet" and label == "conv2" and \
                            wdtype == "fp32":
                        out["pool"] = unfused
            if net == "alexnet":
                out["conv"].append((label, xb, p, None, conv_kw))
            log(f"  {net} {label} bf16, in {tuple(xb.shape)}: fp32 and int8 "
                f"filters{', pool fused and unfused' if pool else ''}: "
                "within TOL_BF16 of the plain version; == the fp32 launch "
                "on the widened operands, rows == b=1"
                f"{', fused == conv -> pool' if pool else ''}, bitwise")
            del xb
        del chain
        torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for label, hw, c, window, dtype in POOL_SWEEP:
        if dtype != "fp32":
            continue
        x = pool_map(hw, c, "fp32", gen).to(bf16)
        kw = dict(window=window, stride=2)
        for act in ("none", "relu", "silu"):
            got = maxpool_act(x, act=act, **kw)
            if act == "silu":
                rep.note_err(pool_name, allclose(
                    f"maxpool_act {label} bf16 silu", got.float(),
                    ref.maxpool_act(x, act=act, **kw).float(), TOL_BF16))
                continue
            exact(f"maxpool_act {label} bf16 {act}", got,
                  ref.maxpool_act(x, act=act, **kw))
            exact(f"maxpool_act {label} bf16 {act} == fp32 widened", got,
                  maxpool_act(x.float(), act=act, **kw).to(bf16))
        del x
    log("  maxpool_act bf16 at the POOL_SWEEP maps (b = 64): none and relu "
        "bitwise the plain version and the fp32 kernel on the widened map; "
        "silu within TOL_BF16")

    # the bf16 paths of the kernels line
    params = models["alexnet"].params
    x = images["alexnet"].to(bf16)
    eng = Engine(backend="kernels")
    reset_counters()
    logits = cnn.cnn_forward("alexnet", params, x, eng=eng)
    out["launches"] = counters()
    expect_counts(out["launches"], "AlexNet forward, bf16 activations",
                  sa_conv_implicit=5, sa_fc_matmul=3)
    if logits.dtype != bf16 or tuple(logits.shape) != (64, 1000) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"bf16 AlexNet logits {logits.dtype} "
                             f"{tuple(logits.shape)}")
    for i in (0, 63):
        exact(f"bf16 AlexNet logits row {i} of b=64 == b=1",
              logits[i:i + 1], cnn.cnn_forward(
                  "alexnet", params, x[i:i + 1].contiguous(), eng=eng))
    # SA-FC in bf16 at the path's shapes: fc1-fc3 of the same forward
    _, fcs, chained = layer_chain("alexnet", params, x)
    exact("bf16 AlexNet: the layer chain == cnn_forward", chained, logits)
    for label, h, p, _, act in fcs:
        got = sa_fc_matmul(h, p["w"], p["b"], act=act)
        rep.note_err(BF16_KERNELS["sa_fc_matmul"], allclose(
            f"bf16 AlexNet {label} b=64", got.float(),
            sa_fc_plain(h, p["w"], p["b"], act=act).float(), TOL_BF16))
        # the fp32 weight is rounded to bf16 first, as the reference does
        check_widened(f"bf16 AlexNet {label} b=64", got, sa_fc_matmul, h,
                      p["w"].to(bf16), p["b"], act=act)
    want = cnn.cnn_forward("alexnet", params, x, eng=Engine(backend="torch"))
    err = allclose("bf16 AlexNet logits vs the torch backend's bf16",
                   logits.float(), want.float(), TOL_BF16)
    fp32 = cnn.cnn_forward("alexnet", params, images["alexnet"], eng=eng)
    rep.detail["alexnet_bf16_logits_vs_torch"] = err
    log(f"  AlexNet forward, bf16 activations, b=64: 5 SA-CONV + 3 SA-FC "
        f"launches, rows 0 and 63 == b=1 bitwise; fc1-fc3 within TOL_BF16 "
        f"of sa_fc_plain and == the fp32 launch on the widened operands; "
        f"logits within TOL_BF16 of the torch backend's bf16 forward "
        f"(max|d| {err:.3g}); max|bf16 - fp32 logits| "
        f"{(logits.float() - fp32).abs().max().item():.3g} (|logits| max "
        f"{fp32.abs().max().item():.3g})")
    del chained, fcs, want
    conv2_in = out["conv"][1][1]
    reset_counters()
    with eng.tracing() as tr:
        got = eng.conv2d(conv2_in, params[2]["f"], params[2]["b"],
                         act="silu", pool=PoolSpec(3, 2), name="c")
    out["declined_launches"] = counters()
    if tr[0].conv_plan.fuse_pool:
        raise AssertionError("bf16 declined fusion: the planner fused")
    expect_counts(out["declined_launches"], "bf16 declined fusion",
                  sa_conv_implicit=1, maxpool_act=1)
    want = Engine(backend="torch").conv2d(conv2_in, params[2]["f"],
                                          params[2]["b"], act="silu",
                                          pool=PoolSpec(3, 2), name="c")
    rep.note_err(conv_name, allclose("bf16 silu conv + pool", got.float(),
                                     want.float(), TOL_BF16))
    log("  engine conv2d(bf16, act=silu, pool 3/2): fusion declined, "
        "maxpool_act launched in bf16, within TOL_BF16 of the torch backend")
    del logits, fp32, x
    return out


def check_zoo_serving(rep: Report, models: dict) -> dict:
    """The example's three-tenant trace (``launch/zoo.py::make_requests``,
    ZOO_PER_TENANT requests a tenant) at full width and native resolution
    under fifo, smf and edf: every request served once, its logits bitwise
    its model's single-request forward on the kernels, within TOL_LOGITS
    of the torch backend; every dispatch a schedule hit; launches equal to
    the stage schedules' ops, no plain call.  Returns the fifo run's
    launches."""
    import numpy as np
    import torch
    from repro_torch.core.engine import Engine
    from repro_torch.launch import zoo as zl
    from repro_torch.models import cnn
    from repro_torch.serve.zoo import POLICIES, ModelZooServer
    refs: dict = {}
    launches = {}
    for policy in ("fifo", "smf", "edf"):
        zoo = ModelZooServer(zl.fresh(list(models.values())),
                             policy=POLICIES[policy]())
        reqs = zl.make_requests(ZOO_PER_TENANT, ZOO_RES, seed=SEED)
        for r in reqs:
            zoo.submit(r)
        reset_counters()
        t0 = time.perf_counter()
        report = zoo.serve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = counters()
        expect_counts(c, f"zoo {policy}",
                      **zoo_launches(report.decisions))
        launches[policy] = c
        if report.unaccounted or len(report.served) != len(reqs):
            raise AssertionError(f"zoo {policy}: {len(report.served)} of "
                                 f"{len(reqs)} served, unaccounted "
                                 f"{[r.uid for r in report.unaccounted]}")
        if report.events:
            raise AssertionError(f"zoo {policy}: events {report.events}")
        for m in zoo.models.values():
            for w in m.server.waves:
                if w.schedule_hits != len(w.trace):
                    raise AssertionError(
                        f"zoo {policy} {m.name} wave {w.wave}: "
                        f"{w.schedule_hits} hits of {len(w.trace)}")
        for r in report.requests:
            m = zoo.models[r.model]
            if r.uid not in refs:
                x = torch.from_numpy(r.image[None]).cuda()
                refs[r.uid] = cnn.cnn_forward(
                    m.spec.net, m.params, x,
                    eng=m.server.engine).cpu().numpy()[0]
            if r.logits is None or not np.array_equal(r.logits,
                                                      refs[r.uid]):
                raise AssertionError(f"zoo {policy} uid {r.uid} "
                                     f"({r.model}): logits != its single-"
                                     "request forward")
        waves = {m: sum(d.model == m for d in report.decisions)
                 for m in models}
        log(f"  {policy}: {len(reqs)} requests in {len(report.decisions)} "
            f"waves {waves} ({wall:.2f} s, first serve of the policy); "
            f"logits == single-request forward, bitwise; every dispatch a "
            f"schedule hit; launches {c}")
        rep.detail[f"zoo_{policy}_waves"] = [
            (d.model, d.batch) for d in report.decisions]
    errs = []
    reqs = {r.uid: r for r in zl.make_requests(ZOO_PER_TENANT, ZOO_RES,
                                               seed=SEED)}
    for m in models.values():
        uids = [u for u, r in reqs.items() if r.model == m.name][:4]
        x = torch.from_numpy(np.stack([reqs[u].image for u in uids])).cuda()
        plain = cnn.cnn_forward(m.spec.net, m.params, x,
                                eng=Engine(backend="torch")).cpu()
        errs.append(allclose(
            f"zoo {m.name} logits vs torch backend",
            torch.from_numpy(np.stack([refs[u] for u in uids])), plain,
            TOL_LOGITS))
    rep.detail["zoo_logits_max_abs_err"] = max(errs)
    log(f"  logits vs the torch backend (4 requests a variant): max|d| "
        f"{max(errs):.3g}")
    return launches["fifo"]


def check_zoo_chaos(rep: Report, models: dict) -> None:
    """The chaos benchmark's full tier trace (a copy in ``launch/zoo.py``)
    under edf with admission control and the seeded fault mix, executed:
    statuses, quarantined uids, degraded serves and events equal to the
    same server's modeled schedule.  No request may be quarantined by an
    executor exception or a genuine non-finite row (such quarantines are
    stamped at -1 s): a guard that caught a failing kernel fails here."""
    import numpy as np
    from repro_torch.launch import zoo as zl
    modeled = zl.chaos_server(zl.fresh(list(models.values())),
                              protected=True)
    for r in zl.chaos_trace("full", ZOO_RES):
        modeled.submit(r)
    want = modeled.serve(execute=False)
    zoo = zl.chaos_server(zl.fresh(list(models.values())), protected=True)
    for r in zl.chaos_trace("full", ZOO_RES):
        zoo.submit(r)
    reset_counters()
    got = zoo.serve()
    c = counters()
    caught = [e for e in got.events if e.t_s == -1.0]
    if caught:
        raise AssertionError(f"chaos: execution-side quarantines {caught}")
    if zl.outcome(got) != zl.outcome(want):
        raise AssertionError("chaos: the executed run differs from its "
                             "modeled schedule")
    expect_counts(c, "zoo chaos", **zoo_launches(got.decisions))
    if not all(np.isfinite(r.logits).all() for r in got.served):
        raise AssertionError("chaos: a served request has non-finite logits")
    kinds = sorted({e.kind for e in got.events})
    rep.detail["zoo_chaos"] = dict(
        requests=len(got.requests), served=len(got.served),
        shed=len(got.shed), quarantined=[r.uid for r in got.quarantined],
        degraded_served=got.degraded_served, retries=got.retry_count,
        waves=len(got.decisions), event_kinds=kinds)
    log(f"  chaos (edf, admission control, seed {zl.CHAOS['seed']}): "
        f"{len(got.requests)} requests, served {len(got.served)}, shed "
        f"{len(got.shed)}, quarantined {len(got.quarantined)}, degraded "
        f"{got.degraded_served}, retries {got.retry_count}, "
        f"{len(got.decisions)} wave attempts, events {kinds}; == its "
        f"modeled schedule, no execution-side quarantine; launches {c}")


def measure_zoo(rep: Report, models: dict, images: dict,
                bf16_shapes: dict) -> None:
    """Phase 8's numbers: images/s of each policy's ``serve()`` (host
    clock, warm schedules), the card time of one b = 64 wave of each
    variant, every VGG-16 layer (SA-CONV and SA-FC, fp32) held against its
    plain version, then timed beside its bound, its plain version and its
    library call, and the bf16 kernels at AlexNet's convs and the
    declined-fusion pool map."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.pool_act import maxpool_act
    from repro_torch.launch import zoo as zl
    from repro_torch.models import cnn
    from repro_torch.serve.zoo import POLICIES, ModelZooServer

    for policy in ("fifo", "smf", "edf"):
        zoo = ModelZooServer(zl.fresh(list(models.values())),
                             policy=POLICIES[policy]())
        reqs = zl.make_requests(ZOO_PER_TENANT, ZOO_RES, seed=SEED)
        for r in reqs:
            zoo.submit(r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        report = zoo.serve()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        rep.detail[f"zoo_images_per_s_{policy}"] = len(report.served) / sec
        log(f"  zoo {policy}: {len(report.served)} images in "
            f"{sec * 1e3:.1f} ms = {len(report.served) / sec:.1f} images/s "
            "(host clock)")
    for m in models.values():
        x = images[m.spec.net]
        eng = m.server.engine
        ms = timed(lambda: cnn.cnn_forward(m.spec.net, m.params, x,
                                           eng=eng), runs=10)
        cost = m.wave_cost(64)
        rep.detail[f"zoo_wave_ms_{m.name}"] = ms
        log(f"  {m.name} b=64 wave: {ms:.4f} ms card time; modeled TPU "
            f"wave cost (the reference's cost model, not a card time): "
            f"conv {cost.conv_s * 1e3:.4f} ms, fc {cost.fc_s * 1e3:.4f} ms")

    convs, fcs, _ = layer_chain("vgg16", models["vgg16"].params,
                                images["vgg16"])
    cnn_layer_rows(rep, "ModelZooServer.serve vgg16", convs, fcs,
                   plain_runs=5)
    del convs, fcs
    torch.cuda.empty_cache()
    cnn_layer_rows(rep, "cnn_forward bf16", bf16_shapes["conv"], [],
                   plain_runs=10)
    t = bf16_shapes["pool"]
    out = maxpool_act(t, window=3, stride=2, act="none")
    tc = t.permute(0, 3, 1, 2)
    add_row(rep, CNN_BF16_KERNELS["maxpool_act"],
            "Engine.conv2d bf16, pool fusion declined",
            f"conv2 map {tuple(t.shape)} 3/2 bf16",
            timed(lambda: maxpool_act(t, window=3, stride=2, act="none")),
            timed(lambda: ref.maxpool_act(t, window=3, stride=2,
                                          act="none")),
            timed(lambda: F.max_pool2d(tc, 3, 2)), out.numel() * 9,
            nbytes(t, out))


def zoo_phase(rep: Report) -> dict:
    """Phase 8: build the zoo, check C6, serve, chaos, numbers.  Returns
    the launches of the zoo's fifo run and of the two bf16 paths."""
    import numpy as np
    import torch
    from repro_torch.serve.zoo import build_zoo
    models = {m.name: m for m in build_zoo(ZOO_MODELS, seed=SEED,
                                           in_res=ZOO_RES, width_mult=1.0,
                                           max_batch=ZOO_BATCH)}
    for m in models.values():
        if m.microbatch != ZOO_BATCH:
            raise AssertionError(f"{m.name}: micro-batch {m.microbatch}")
        log(f"  {m.name}: {m.spec.net} {m.spec.weight_dtype} at "
            f"{m.server.in_res}^2, micro-batch {m.microbatch}")
    rng = np.random.default_rng(SEED)
    images = {net: torch.from_numpy(rng.standard_normal(
        (ZOO_BATCH, res, res, 3)).astype(np.float32)).cuda()
        for net, res in ZOO_RES.items()}
    log("  C6: bf16 activations through SA-CONV implicit and the pool")
    bf16 = check_bf16_cnn(rep, models, images)
    log("  the three-tenant trace under fifo, smf and edf")
    zoo_launches_fifo = check_zoo_serving(rep, models)
    log("  chaos")
    check_zoo_chaos(rep, models)
    log("  times (CUDA events, L2 flushed, card held busy; bf16 bound at "
        "989 TFLOP/s)")
    measure_zoo(rep, models, images, bf16)
    return dict(zoo=zoo_launches_fifo, bf16=bf16["launches"],
                declined_bf16=bf16["declined_launches"], models=models)


# ---------------------------------------------------------------------------
# phase 9: the replica fleet at full width (launch/fleet.py's seven
# configurations over the zoo, four replicas sharing the card)
# ---------------------------------------------------------------------------
def fleet_launches(decisions, models: dict) -> dict:
    """Launches per kernel that the executed attempts of ``decisions`` must
    make on one card, from the decisions alone: one forward per
    per-replica wave, one per ``cooperative_blocks`` piece of a
    cooperative wave (every participant is on the card), each ZOO_CONVS
    SA-CONV and ZOO_FCS SA-FC launches; attempts lost to a dead replica
    or a timeout run nothing; no pool and no GEMM launch."""
    from repro_torch.serve.fleet import cooperative_blocks
    convs = fcs = 0
    for d in decisions:
        if d.fault in ("replica_dead", "timeout"):
            continue
        m = models[d.model]
        k = len(cooperative_blocks(d.batch, len(d.shards), m.microbatch)) \
            if d.shards else 1
        convs += ZOO_CONVS[m.spec.net] * k
        fcs += ZOO_FCS * k
    return dict(sa_conv_implicit=convs, sa_fc_matmul=fcs)


def check_int8_cooperative_wave(rep: Report, fleet, report, models: dict,
                                images_np) -> None:
    """The int8 AlexNet cooperative wave of ``sharded_r4`` (more rows than
    the int8 FC flip batches, 145-300): its forwards, read from the
    dispatch traces, hold at most a micro-batch each and keep every FC on
    SA-FC.  Then, as evidence of why, ONE forward over the whole wave:
    where the planner puts its FC layers, and how many of its rows differ
    from the unbatched forward (not part of any served path)."""
    import numpy as np
    import torch
    from repro_torch.models import cnn
    m = models["alexnet-int8"]
    d = max((d for d in report.decisions if d.sharded
             and d.model == "alexnet-int8"
             and d.fault not in ("replica_dead", "timeout")),
            key=lambda d: d.batch)
    if d.batch <= 158:
        raise AssertionError(f"int8 cooperative wave of {d.batch} rows")
    traces = [tr for tr in fleet.shard_traces if tr[0].wave == d.index]
    rows = [tr[0].conv_shape[0] for tr in traces]
    regimes = {r.regime for tr in traces for r in tr if r.conv_plan is None}
    if sum(rows) != d.batch or max(rows) > m.microbatch or \
            regimes != {"sa_fc"}:
        raise AssertionError(f"int8 cooperative wave: forwards of {rows} "
                             f"rows, FC regimes {regimes}")
    eng = m.server.engine
    x = torch.from_numpy(images_np[:d.batch]).cuda()
    with eng.tracing() as tr:
        whole = cnn.cnn_forward("alexnet", m.params, x, eng=eng)
    fc = [(r.name, r.regime) for r in tr if r.conv_plan is None]
    differ = 0
    for i in range(d.batch):
        one = cnn.cnn_forward("alexnet", m.params, x[i:i + 1], eng=eng)
        differ += not torch.equal(one, whole[i:i + 1])
    rep.detail["fleet_int8_wave"] = dict(
        rows=d.batch, forwards=rows, whole_wave_fc=fc,
        whole_wave_rows_differing=differ)
    log(f"  int8 cooperative wave of {d.batch} rows over {len(d.shards)} "
        f"replicas: forwards of {rows} rows, every FC on SA-FC.  One "
        f"forward over all {d.batch} rows would plan the FCs as {fc}, and "
        f"{differ} of its {d.batch} rows differ from the unbatched forward")


def fleet_phase(rep: Report, models: dict) -> dict:
    """Phase 9: ``launch/fleet.py``'s seven configurations over the zoo at
    full width (four replicas on the one card).  Modeled ones: zero
    unaccounted, healthy_r1 == the zoo's decisions, modeled scaling >=
    1.5x from 1 to 4 replicas, replays bit-identical.  Executed ones
    (chaos_r4, sharded_r4, sharded_chaos_r4): every served row finite and
    bitwise its model's unbatched forward on the card, no
    execution-side quarantine, the kill, drain, replan, partition,
    shard_abort and reshard events, launches as the decisions imply (no
    GEMM, no pool, no plain call).  Returns the executed runs' launches
    summed."""
    import numpy as np
    import torch
    from repro_torch.launch import fleet as fl
    ms = list(models.values())
    streams = fl.traces(ms, FLEET_TIER, ZOO_RES)
    kill = fl.shard_kill_time(fl.run_config(ms, streams["burst"],
                                            n_replicas=4, shard_waves=True))
    log(f"  streams ({FLEET_TIER} tier): {len(streams['dense'])} requests "
        f"(dense, {fl.density(ms)}x the reference's), "
        f"{len(streams['reference'])} (the reference's, chaos_r4), bursts "
        f"{fl.burst_sizes(ms, FLEET_TIER)} (sharded); sharded_chaos_r4 "
        f"kills r2 at {kill!r} s (modeled), halfway through the first "
        "cooperative wave")
    rep.detail["fleet_kill_s"] = kill
    rep.detail["fleet_bursts"] = fl.burst_sizes(ms, FLEET_TIER)
    kwargs = fl.config_kwargs(kill)
    reports, total = {}, {k: 0 for k in _wrappers()}
    refs = {k: {} for k in streams}
    for name, kw in kwargs.items():
        tr = fl.CONFIG_TRACE[name]
        execute = name in fl.EXECUTED
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        fleet = fl.build_fleet(ms, **kw)
        for r in fl.requests(streams[tr]):
            fleet.submit(r)
        report = fleet.serve(execute=execute)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = counters()
        reports[name] = report
        if not execute:
            expect_counts(c, f"fleet {name} (modeled)")
            log(f"  {name}: {len(report.decisions)} waves, modeled TPU "
                f"makespan {report.makespan_s * 1e6:.3f} us")
            continue
        expect_counts(c, f"fleet {name}",
                      **fleet_launches(report.decisions, models))
        for k in total:
            total[k] += c[k]
        bad = fl.parity_failures(report, fl.unbatched_logits(ms, report,
                                                             refs[tr]))
        if bad:
            raise AssertionError(f"fleet {name}: uids {bad[:8]} not finite "
                                 "and bitwise their unbatched forward, or "
                                 "quarantined by the executor")
        coop = [(d.model, d.batch, len(d.shards), d.fault)
                for d in report.decisions if d.sharded]
        rep.detail[f"fleet_{name}"] = dict(
            served=len(report.served), waves=len(report.decisions),
            cooperative=coop, wall_s=wall,
            images_per_s=len(report.served) / wall,
            events=sorted({e.kind for e in report.events}), launches=c)
        log(f"  {name}: {len(report.served)} served in "
            f"{len(report.decisions)} waves ({len(coop)} cooperative: "
            f"{coop}), every row bitwise its unbatched forward; "
            f"{wall:.3f} s = {len(report.served) / wall:.1f} images/s "
            f"(host clock, first serve); launches {c}")
        if name == "sharded_r4":
            rng = np.random.default_rng(SEED)
            check_int8_cooperative_wave(
                rep, fleet, report, models, rng.standard_normal(
                    (4 * models["alexnet-int8"].microbatch, ZOO_RES["alexnet"], ZOO_RES["alexnet"], 3)
                ).astype(np.float32))
    replays = {name: fl.run_config(ms, streams[fl.CONFIG_TRACE[name]],
                                   **kwargs[name])
               for name in ("chaos_r4", "sharded_r4")}
    n = {name: len(streams[tr]) for name, tr in fl.CONFIG_TRACE.items()}
    checks = fl.fleet_checks(reports, fl.zoo_witness(ms, streams["dense"]),
                             replays, n)
    failed = [c for c in checks if not c[1]]
    if failed:
        raise AssertionError(f"fleet checks failed: {failed}")
    rep.detail["fleet_checks"] = checks
    log(f"  {len(checks)} fleet checks passed: " + "; ".join(
        f"{name}{f' ({detail})' if detail else ''}"
        for name, _, detail in checks if "unaccounted" not in name))
    fleet_busy(rep, ms)
    return total


def fleet_busy(rep: Report, ms: list) -> None:
    """The device's busy share over one full cooperative wave: an int8
    burst of ``sharded_microbatch(4)`` requests through a fresh
    four-replica fleet (one cooperative wave), host clock against the
    profiler's device time; then images/s of the same drain."""
    import numpy as np
    import torch
    from repro_torch.launch import fleet as fl
    from repro_torch.serve.zoo import ZooRequest
    m = next(x for x in ms if x.name == "alexnet-int8")
    rows = m.sharded_microbatch(fl.SHARD_DATA)
    rng = np.random.default_rng(SEED)
    images = rng.standard_normal((rows, ZOO_RES["alexnet"], ZOO_RES["alexnet"], 3)).astype(np.float32)

    def drain():
        fleet = fl.build_fleet(ms, n_replicas=4, shard_waves=True)
        for u in range(rows):
            fleet.submit(ZooRequest(uid=u, model=m.name, image=images[u]))
        report = fleet.serve()
        if [d.batch for d in report.decisions] != [rows]:
            raise AssertionError("not one cooperative wave")
        return report
    drain()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        drain()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    busy = device_busy(drain, wall)
    rep.detail["fleet_cooperative_wave_busy"] = busy
    share = "not measured" if busy["device_ms"] is None else \
        f"{1 - busy['idle_share']:.3f}"
    log(f"  one int8 cooperative wave of {rows} rows: {wall * 1e3:.2f} ms "
        f"host clock (median of 3, {rows / wall:.1f} images/s), device "
        f"busy share {share} (device "
        f"{busy['device_ms'] if busy['device_ms'] is None else round(busy['device_ms'], 3)} "
        f"ms; top {busy['top']})")


# ---------------------------------------------------------------------------
# phase 10: training OLMo-1B as published
# ---------------------------------------------------------------------------
def _leaf(tree, path: str):
    """The tensor at a dotted ``path`` of a parameter tree (list indices as
    numbers); a trailing ``[i]`` picks layer ``i`` of a stacked leaf."""
    path, _, layer = path.partition("[")
    for key in path.split("."):
        tree = tree[int(key)] if isinstance(tree, list) else tree[key]
    return tree if not layer else tree[int(layer.rstrip("]"))]


def train_launches(cfg, sched, steps: int, remat: bool) -> dict:
    """Launches per kernel (and plain attention calls) that ``steps`` train
    steps of ``cfg`` must make under ``sched``: each matmul runs on its
    regime's kernel once forward, once more in the remat recompute (the
    blocks', not the head's), once for ``pre`` where its activation is not
    linear and once for ``dx``; its ``dw`` runs on the SA-CONV GEMM.
    Attention: flash forward (and recompute), the plain version once in
    the backward."""
    kernel = {"sa_conv": "sa_conv_matmul", "sa_fc": "sa_fc_matmul"}
    out = {k: 0 for k in _wrappers()}
    for key, plan in sched.items():
        per = 1 if key.name == "lm_head" else cfg.n_layers
        runs = 1 + (remat and key.name != "lm_head") + \
            (key.name in ACT_MATMULS) + 1
        out[kernel[plan.regime]] += per * runs * steps
        out["sa_conv_matmul"] += per * steps
    out["flash_attention"] = cfg.n_layers * (1 + remat) * steps
    out["plain.attention"] = cfg.n_layers * steps
    return out


def expect_train_counts(c: dict, what: str, want: dict) -> None:
    """``c`` equals ``want`` for every kernel and plain version (those
    ``want`` does not name: 0)."""
    full = {k: want.get(k, 0) for k in c}
    if c != full:
        raise AssertionError(f"{what}: launch counts {c} != {full}")


def check_train_functions(rep: Report, cfg) -> dict:
    """The kernels backend's autograd Functions on the card against torch
    autograd through the plain versions (the ``"torch"`` backend), same
    inputs and cotangent: SA-FC at b = 4 rows and the SA-CONV GEMM at m =
    TRAIN_BATCH x TRAIN_SEQ, OLMo-1B widths, fp32 and bf16, with bias and
    without, act none and silu (dx, dw, db), an int8 weight on SA-FC (dx,
    db), then flash attention's forward with the plain backward at a full
    wave.  Each gradient is compared relative to its RMS
    (:func:`allclose_rms`); each Function's launches are counted."""
    import torch
    from repro_torch.core.engine import DispatchPolicy, Engine
    from repro_torch.core.quant import QTensor, quantize
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    bf, f32 = torch.bfloat16, torch.float32

    def rand(shape, scale=1.0, dtype=f32):
        return (torch.randn(shape, generator=gen, device=DEVICE)
                * scale).to(dtype)

    def grads(eng, x, w, b, act, cot):
        """(dx, dw[, db]), or (dx[, db]) for a QTensor ``w``."""
        frozen = isinstance(w, QTensor)
        live = [t.detach().requires_grad_() for t in
                ((x, b) if frozen else (x, w, b)) if t is not None]
        y = eng.matmul(live[0], w if frozen else live[1],
                       live[-1] if b is not None else None, act=act)
        return torch.autograd.grad((y.float() * cot).sum(), live)

    plain = Engine(backend="torch")
    d, ff = cfg.d_model, cfg.d_ff
    cases = ((d, d, "none", False), (d, ff, "silu", False),
             (d, ff, "silu", True), (ff, d, "none", True))
    errs: dict = {}
    m_gemm = TRAIN_BATCH * TRAIN_SEQ
    for regime, m, kern in (("sa_fc", LM_BATCH, "sa_fc_matmul"),
                            ("sa_conv", m_gemm, "sa_conv_matmul")):
        eng = Engine(backend="kernels",
                     policy=DispatchPolicy(force_regime=regime))
        for dt, tol in ((f32, TOL_FC), (bf, TOL_BF16)):
            for k, n, act, with_bias in cases:
                x, w = rand((m, k), dtype=dt), rand((k, n), k ** -0.5, dt)
                b = rand((n,), dtype=dt) if with_bias else None
                cot = rand((m, n))
                reset_counters()
                got = grads(eng, x, w, b, act, cot)
                c = counters()
                want_c = {kern: 2 + (act != "none")}
                want_c["sa_conv_matmul"] = want_c.get("sa_conv_matmul", 0) + 1
                expect_train_counts(c, f"{regime} Function", want_c)
                want = grads(plain, x, w, b, act, cot)
                label = (f"{kern} Function {dtype_tag(dt)} ({m}x{k})@({k}x"
                         f"{n}) {act}{' +bias' if with_bias else ''}")
                for name, g, wv in zip(("dx", "dw", "db"), got, want):
                    e = allclose_rms(f"{label} {name}", g, wv, tol)
                    errs[f"{label} {name}"] = e
        if regime == "sa_fc":
            x, b = rand((m, d)), rand((ff,))
            qt = quantize(rand((d, ff), d ** -0.5))
            cot = rand((m, ff))
            reset_counters()
            got = grads(eng, x, qt, b, "silu", cot)
            expect_train_counts(counters(), "int8 Function",
                                {"sa_fc_matmul": 3})
            want = grads(plain, x, qt, b, "silu", cot)
            for name, g, wv in zip(("dx", "db"), got, want):
                errs[f"sa_fc_matmul Function int8 ({m}x{d})@({d}x{ff}) "
                     f"silu +bias {name}"] = allclose_rms(
                    f"int8 Function {name}", g, wv, TOL_FC)
    kernels = Engine(backend="kernels")
    for dt, tol in ((f32, TOL_ATTN), (bf, TOL_BF16)):
        q, k, v = (rand((TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads, cfg.hd),
                        dtype=dt) for _ in range(3))
        cot = rand(q.shape)
        res = []
        for eng in (kernels, plain):
            live = [t.detach().requires_grad_() for t in (q, k, v)]
            reset_counters()
            out = eng.attention(*live)
            res.append(torch.autograd.grad((out.float() * cot).sum(), live))
            if eng is kernels:
                expect_train_counts(counters(), "flash Function",
                                    {"flash_attention": 1,
                                     "plain.attention": 1})
        for name, g, wv in zip(("dq", "dk", "dv"), *res):
            errs[f"flash_attention Function {dtype_tag(dt)} "
                 f"{tuple(q.shape)} {name}"] = allclose_rms(
                f"flash Function {name}", g, wv, tol)
    torch.cuda.synchronize()
    worst = max(errs.items(), key=lambda kv: kv[1])
    log(f"  {len(errs)} gradients of the autograd Functions within the "
        f"reference's tolerances (3e-4 fp32, 3e-2 bf16, relative to each "
        f"gradient's RMS) of torch autograd through the plain versions; "
        f"largest max|d|/RMS {worst[1]:.3g} ({worst[0]}); launches per "
        f"Function as the backward implies")
    rep.detail["train_function_errs"] = errs
    rep.note_err("sa_conv_matmul[train]", max(
        e for key, e in errs.items() if key.startswith("sa_conv_matmul")))
    rep.note_err("flash_attention[train]", max(
        e for key, e in errs.items() if key.startswith("flash")))
    return errs


def dtype_tag(dt) -> str:
    import torch
    return "bf16" if dt == torch.bfloat16 else "fp32"


def check_train_grads(rep: Report, cfg, tc, params, batch) -> None:
    """Step-0 gradients of ``TRAIN_LEAVES``: the kernels backend's bf16
    ones within ``TRAIN_BF16_SPREAD`` times (L2) the torch backend's own
    bf16-vs-fp32 spread of the torch backend's bf16 ones, and the kernels
    backend's fp32 ones within ``TRAIN_FP32_REL_L2`` (relative L2) of the
    torch backend's fp32 ones.  The torch backend runs without remat: the
    same gradient, half the plain forwards."""
    import dataclasses
    import torch
    from repro_torch.core.engine import Engine
    from repro_torch.train import train_step as TS

    def leaves_of(cfg, tc, params, backend):
        t0 = time.perf_counter()
        loss, g = TS.make_grad_fn(cfg, tc, engine=Engine(backend=backend))(
            params, batch)
        out = {p: _leaf(g, p).float().clone() for p in TRAIN_LEAVES}
        del g
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        if not (torch.isfinite(loss) and all(
                torch.isfinite(t).all() for t in out.values())):
            raise AssertionError(f"step-0 {backend} gradients not finite")
        return float(loss), out, time.perf_counter() - t0

    plain_tc = dataclasses.replace(tc, remat="none")
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    runs = {"kernels bf16": leaves_of(cfg, tc, params, "kernels"),
            "torch bf16": leaves_of(cfg, plain_tc, params, "torch")}
    params32 = widen_tree(params)
    runs["torch fp32"] = leaves_of(cfg32, plain_tc, params32, "torch")
    runs["kernels fp32"] = leaves_of(cfg32, tc, params32, "kernels")
    del params32
    torch.cuda.empty_cache()
    k16, t16, t32, k32 = (runs[k][1] for k in ("kernels bf16", "torch bf16",
                                               "torch fp32",
                                               "kernels fp32"))
    rows = {}
    for p in TRAIN_LEAVES:
        d16 = (k16[p] - t16[p]).norm().item()
        spread = (t16[p] - t32[p]).norm().item()
        rel32 = ((k32[p] - t32[p]).norm() / t32[p].norm()).item()
        rows[p] = dict(
            kernels_vs_torch_bf16_l2=d16, torch_bf16_vs_fp32_l2=spread,
            kernels_bf16_vs_torch_fp32_l2=(k16[p] - t32[p]).norm().item(),
            kernels_vs_torch_bf16_max=(k16[p] - t16[p]).abs().max().item(),
            torch_bf16_vs_fp32_max=(t16[p] - t32[p]).abs().max().item(),
            fp32_rel_l2=rel32, norm=t32[p].norm().item())
        log(f"  step-0 gradient {p} (|g| {rows[p]['norm']:.4g}): bf16 "
            f"kernels vs torch L2 {d16:.4g} = {d16 / spread:.3f} x torch "
            f"bf16 vs fp32 {spread:.4g} (kernels bf16 vs torch fp32 "
            f"{rows[p]['kernels_bf16_vs_torch_fp32_l2']:.4g}; max|d| "
            f"{rows[p]['kernels_vs_torch_bf16_max']:.3g} vs "
            f"{rows[p]['torch_bf16_vs_fp32_max']:.3g}); fp32 kernels vs "
            f"torch relative L2 {rel32:.3g}")
        if not d16 <= TRAIN_BF16_SPREAD * spread:
            raise AssertionError(
                f"step-0 gradient {p}: kernels vs torch backend bf16 L2 "
                f"{d16:.4g} > {TRAIN_BF16_SPREAD:.4f} x the torch backend's "
                f"bf16 vs fp32 spread {spread:.4g}")
        if not rel32 <= TRAIN_FP32_REL_L2:
            raise AssertionError(
                f"step-0 fp32 gradient {p}: relative L2 {rel32:.3g} > "
                f"{TRAIN_FP32_REL_L2}")
    rep.detail["train_step0_grads"] = dict(
        leaves=rows, losses={k: v[0] for k, v in runs.items()},
        seconds={k: v[2] for k, v in runs.items()})
    log("  step-0 losses: " + ", ".join(
        f"{k} {v[0]:.5f} ({v[2]:.1f} s)" for k, v in runs.items()))


def train_rows(rep: Report, cfg, sched, steps_per: dict) -> None:
    """Card time of one train step's kernel work, per shape and role: the
    SA-CONV GEMM forward (and recompute, and ``pre``), ``dx`` against
    ``w.T`` and ``dw = x.T dpre``, each at its shapes in bf16 beside its
    bound, plain version and ``torch.mm``; flash's forward at the step's
    wave."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.attention import flash_attention, flash_plain
    from repro_torch.kernels.sa_conv import (sa_conv_matmul,
                                             sa_conv_matmul_plain)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    bf = torch.bfloat16

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE).to(bf)

    for key, plan in sched.items():
        if plan.regime != "sa_conv":
            raise AssertionError(f"{key.name}: not on the SA-CONV GEMM")
        m, n, k = key.m, key.n, key.k
        per = 1 if key.name == "lm_head" else cfg.n_layers
        act = "silu" if key.name in ACT_MATMULS else "none"
        x, w, dpre = rand(m, k), rand(k, n) * k ** -0.5, rand(m, n)
        roles = (("forward", x, w, act, per * (
            1 + (key.name != "lm_head") + (act != "none"))),
            ("dx", dpre, w.t().contiguous(), "none", per),
            ("dw", x.t().contiguous(), dpre, "none", per))
        for role, a, b, ac, count in roles:
            out = sa_conv_matmul(a, b, act=ac)
            add_row(rep, "sa_conv_matmul[train]", "trainer.run",
                    f"{key.name} {role} ({a.shape[0]}x{a.shape[1]})@"
                    f"({b.shape[0]}x{b.shape[1]})",
                    timed(lambda: sa_conv_matmul(a, b, act=ac)),
                    timed(lambda: sa_conv_matmul_plain(a, b, act=ac),
                          runs=1, warmup=0),
                    timed(lambda: ref.apply_act(torch.mm(a, b), ac)),
                    2 * a.shape[0] * a.shape[1] * b.shape[1],
                    nbytes(a, b, out), peak=PEAK_BF16_FLOPS, per_pass=count,
                    phase="train step")
        del x, w, dpre
    q, k, v = (rand(TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads, cfg.hd)
               for _ in range(3))
    out = flash_attention(q, k, v)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    pairs = TRAIN_SEQ * (TRAIN_SEQ + 1) // 2
    add_row(rep, "flash_attention[train]", "trainer.run",
            f"{tuple(q.shape)} causal forward",
            timed(lambda: flash_attention(q, k, v)),
            timed(lambda: flash_plain(q, k, v), runs=5, warmup=1),
            timed(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                         is_causal=True)),
            4 * TRAIN_BATCH * cfg.n_heads * pairs * cfg.hd,
            nbytes(q, k, v, out), peak=PEAK_BF16_FLOPS,
            per_pass=steps_per["flash_attention"], phase="train step")
    torch.cuda.synchronize()


def train_phase(rep: Report, smi: str, cfg=None) -> dict:
    """Phase 10: OLMo-1B as published (bf16, full width and depth) trains
    through ``trainer.run`` on the kernels backend.  The autograd
    Functions against torch autograd through the plain versions; the
    step-0 gradients against the torch backend's (bf16 within its own
    bf16-vs-fp32 spread, fp32 within ``TRAIN_FP32_REL_L2``); then
    ``TRAIN_STEPS`` steps with an async checkpoint at ``TRAIN_CKPT``:
    every loss finite, every dispatch a schedule hit, launches as the
    train schedule implies, the checkpoint restored bitwise into a fresh
    state and the trainer resuming from it; host and device time of a
    step, tokens/s, idle share, peak memory.  Returns the 4-step run's
    launches."""
    import shutil
    import torch
    from repro_torch.checkpoint.checkpoint import Checkpointer
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import tree
    from repro_torch.core.engine import Engine
    from repro_torch.core.schedule import LayerSchedule
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import transformer as T
    from repro_torch.train import train_step as TS
    from repro_torch.train import trainer

    cfg = cfg if cfg is not None else olmo_bf16_config()
    t_phase = time.perf_counter()
    check_train_functions(rep, cfg)
    tc = TrainConfig(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                     total_steps=TRAIN_STEPS, warmup_steps=1, remat="block")
    data = SyntheticLM(DataConfig(cfg.vocab_size, tc.seq_len,
                                  tc.global_batch, seed=tc.seed))
    pending = [TS.init_train_state(cfg, tc, tc.seed, device=DEVICE)]
    check_train_grads(rep, cfg, tc, pending[0][0], data.batch_at(0))

    eng = Engine(backend="kernels")
    step_fn = TS.make_train_step(cfg, tc, engine=eng)
    snapshot = {}

    def stepping(params, opt, cs, batch):
        out = step_fn(params, opt, cs, batch)
        stepping.calls += 1
        if stepping.calls == TRAIN_CKPT:       # the state saved at CKPT
            snapshot["state"] = tree.map_leaves(
                torch.clone, (T.trainable(out[0]), out[1], out[2]))
        return out
    stepping.calls = 0

    ckpt_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    with eng.tracing() as tr:
        run = trainer.run(cfg, tc, ckpt_dir=str(ckpt_dir),
                          ckpt_every=TRAIN_CKPT, train_step_fn=stepping,
                          state=pending.pop(), data=data, log_every=1,
                          log=lambda s: log(f"  {s}"))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    c = counters()
    sched = LayerSchedule.compile(cfg, "train", batch=TRAIN_BATCH,
                                  seq=TRAIN_SEQ, policy=eng.policy)
    want = train_launches(cfg, sched, TRAIN_STEPS, remat=True)
    expect_train_counts(c, "trainer.run", want)
    per_step = train_launches(cfg, sched, 1, remat=True)
    mm = [r for r in tr if r.regime in ("sa_conv", "sa_fc")]
    per_forward = sum(1 if key.name == "lm_head" else cfg.n_layers
                      for key in sched)
    if len(mm) != TRAIN_STEPS * per_forward or \
            len(tr) != len(mm) + TRAIN_STEPS * cfg.n_layers or \
            any(r.schedule != "hit" for r in mm):
        raise AssertionError("trainer.run: a matmul missed its schedule, or "
                             "the trace holds other records than one "
                             "forward's a step (remat and the backward "
                             "record nothing)")
    if len(run.losses) != TRAIN_STEPS or not all(
            l == l and abs(l) < float("inf") for l in run.losses):
        raise AssertionError(f"trainer.run losses {run.losses}")
    log(f"  trainer.run: {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"tokens in {run_s:.2f} s (schedule compiled, checkpoints written); "
        f"losses {[round(l, 5) for l in run.losses]}, all finite; "
        f"{len(mm)} matmul dispatches, all schedule hits; launches {c} == "
        f"the train schedule's")

    # the async checkpoint at TRAIN_CKPT, restored into a fresh state
    saved = snapshot.pop("state")
    fresh = tree.map_leaves(torch.empty_like, saved)
    t0 = time.perf_counter()
    restored, step, _ = Checkpointer(str(ckpt_dir)).restore(fresh,
                                                            step=TRAIN_CKPT)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    del fresh
    leaves = tree.leaves(restored)
    if step != TRAIN_CKPT or not all(
            a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(leaves, tree.leaves(saved))):
        raise AssertionError("the step-2 checkpoint restored is not bitwise "
                             "the state saved")
    ckpt_bytes = nbytes(*leaves)
    del saved
    log(f"  checkpoint at step {TRAIN_CKPT} ({len(leaves)} leaves, "
        f"{ckpt_bytes / 1e9:.2f} GB) restored into a fresh state in "
        f"{restore_s:.2f} s: bitwise the state saved")

    # steps from the restored state with no checkpoint in flight (the
    # trainer's steps 2 and 3 overlap the async write of step 2's): host
    # clock to the loss on the host, median of 3; peak memory; one
    # profiled step
    tp, opt, cs = restored
    del restored, leaves
    params = T.with_head_copy(cfg, tp)
    batch = data.batch_at(TRAIN_CKPT)
    trainer_s = statistics.median(run.step_seconds[1:])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        float(step_fn(params, opt, cs, batch)[3]["loss"])
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.median(walls)
    busy = device_busy(lambda: step_fn(params, opt, cs, batch), step_s,
                       top=12)
    del params, tp, opt, cs
    torch.cuda.empty_cache()

    # the trainer resumes from the async checkpoint
    shutil.rmtree(ckpt_dir / f"step_{TRAIN_STEPS:08d}")
    resumed = trainer.run(cfg, tc, ckpt_dir=str(ckpt_dir),
                          ckpt_every=TRAIN_CKPT, data=data, log_every=1,
                          log=lambda s: log(f"  {s}"), device=DEVICE,
                          engine=eng)
    if resumed.resumed_from != TRAIN_CKPT or \
            resumed.steps_run != TRAIN_STEPS - TRAIN_CKPT or not all(
                abs(l) < float("inf") for l in resumed.losses):
        raise AssertionError(f"resume: from {resumed.resumed_from}, "
                             f"{resumed.steps_run} steps, losses "
                             f"{resumed.losses}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    same = resumed.losses == run.losses[TRAIN_CKPT:]
    log(f"  trainer.run resumed from step {resumed.resumed_from}: losses "
        f"{resumed.losses} against the uninterrupted run's "
        f"{run.losses[TRAIN_CKPT:]}: {'' if same else 'not '}bitwise "
        "equal (reported, not required)")

    train_rows(rep, cfg, sched, per_step)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    b4 = [r for r in rep.rows if r["kernel"] == "sa_conv_matmul[train]"]
    by_role = {role: sum(r["ms"] * r["per_pass"] for r in b4
                         if f" {role} " in r["shape"])
               for role in ("forward", "dx", "dw")}
    flash_ms = sum(r["ms"] * r["per_pass"] for r in rep.rows
                   if r["kernel"] == "flash_attention[train]")
    detail = dict(
        card=smi, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        losses=run.losses, resumed_losses=resumed.losses,
        resumed_bitwise=same,
        trainer_step_seconds=run.step_seconds,
        trainer_step_s_median=trainer_s, step_seconds=walls,
        step_s_median=step_s, tokens_per_s=tokens / step_s, launches=c, launches_per_step=per_step,
        b4_ms_per_step=by_role, flash_ms_per_step=flash_ms,
        device=busy, peak_bytes=peak, state_bytes=base,
        checkpoint_bytes=ckpt_bytes, restore_s=restore_s,
        phase_s=time.perf_counter() - t_phase)
    rep.detail["train"] = detail
    dev = "not measured" if busy["device_ms"] is None else \
        f"{busy['device_ms']:.2f} ms"
    idle = "not measured" if busy["idle_share"] is None else \
        f"{busy['idle_share']:.3f}"
    log(f"  [{smi}] bf16 train step of {tokens} tokens: {step_s * 1e3:.1f} "
        f"ms host clock (median of 3 with no checkpoint in flight) = "
        f"{tokens / step_s:.0f} trained tokens/s; trainer.run's steps "
        f"1-{TRAIN_STEPS - 1}: median {trainer_s * 1e3:.1f} ms (steps "
        f"{TRAIN_CKPT}-{TRAIN_STEPS - 1} overlap the async checkpoint's "
        f"write); device {dev} (torch.profiler), idle share {idle}; top "
        f"{busy['top']}")
    log(f"  [{smi}] one step's launches {per_step}; SA-CONV GEMM card ms "
        f"forward {by_role['forward']:.2f} (with the recompute and pre), dx "
        f"{by_role['dx']:.2f}, dw {by_role['dw']:.2f}; flash forward "
        f"{flash_ms:.3f} ms; peak memory {peak / 1e9:.2f} GB "
        f"(torch.cuda.max_memory_allocated over one step, state "
        f"{base / 1e9:.2f} GB); phase {detail['phase_s']:.1f} s")
    return c


# ---------------------------------------------------------------------------
# phase 11: the static checks against the card
# ---------------------------------------------------------------------------
#: what phase 11 runs of ``python -m repro_torch.analysis``
ANALYSIS_ARGS = ("--net", "alexnet", "--net", "vgg16", "--all-zoo-variants")
#: the kernel of each library, as ptxas names its entry functions
KERNEL_SYMBOLS = {"sa_fc": "sa_fc_kernel",
                  "sa_conv_implicit": "sa_conv_kernel",
                  "pool_act": "pool_act_kernel",
                  "sa_conv": "sa_conv_gemm_kernel",
                  "attention": "flash_kernel"}


def ptxas_static(text: str, symbol: str) -> list[tuple[int, int]]:
    """(static shared memory bytes, spill bytes) of every instantiation of
    ``symbol`` in ptxas's -v output."""
    out = []
    for block in text.split("Compiling entry function")[1:]:
        if symbol not in block.split("\n", 1)[0]:
            continue
        used = re.search(r"Used \d+ registers[^\n]*", block)
        if used is None:
            continue
        smem = re.search(r"(\d+) bytes smem", used.group(0))
        out.append((int(smem.group(1)) if smem else 0,
                    sum(int(v) for v in
                        re.findall(r"(\d+) bytes spill", block))))
    return out


def analysis_launches() -> list:
    """Every CUDA launch the zoo variants (as ``ANALYSIS_ARGS`` registers
    them, and AlexNet and VGG-16 at b = 1) and the LM configs make."""
    from repro_torch.analysis import launch as L
    from repro_torch.analysis.__main__ import zoo_variant_pairs
    from repro_torch.core.schedule import ScheduleRegistry
    reg = ScheduleRegistry()
    pairs = [reg.register(net, batch=1) for net in ("alexnet", "vgg16")]
    pairs += [pair for _, pair in zoo_variant_pairs(8)]
    out = [lau for pair in pairs for sched in pair
           for lau in L.schedule_launches(sched)]
    return out + L.lm_launches()


def nan_primed(numel: int, dtype) -> int:
    """Fill a block of ``numel`` elements with NaN and free it: the caching
    allocator hands it to the next request of that size.  Its address."""
    import torch
    t = torch.full((numel,), float("nan"), dtype=dtype, device="cuda")
    ptr = t.data_ptr()
    del t
    return ptr


def edge_call(lau, gen):
    """(kernel call, plain version's output, tolerance) of one edge launch
    of ``analysis/launch.py``, on operands drawn from ``gen``."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.attention import flash_attention, flash_plain
    from repro_torch.kernels.pool_act import maxpool_act
    from repro_torch.kernels.sa_conv import (sa_conv_matmul,
                                             sa_conv_matmul_plain)
    from repro_torch.kernels.sa_conv_implicit import (sa_conv_implicit,
                                                      sa_conv_plain)
    from repro_torch.kernels.sa_fc import sa_fc_matmul, sa_fc_plain

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    types = {0: torch.float32, 1: torch.int8, 2: torch.bfloat16}
    if lau.kernel in ("sa_fc", "sa_conv"):
        if lau.kernel == "sa_fc":
            b, k, n, w_kind, x_kind = lau.shape
            kern, plain = sa_fc_matmul, sa_fc_plain
        else:
            b, n, k, w_kind, x_kind = lau.shape
            kern, plain = sa_conv_matmul, sa_conv_matmul_plain
        x = randn(b, k, dtype=types[x_kind])
        scale = None
        if w_kind == 1:
            w = torch.randint(-127, 128, (k, n), generator=gen,
                              device="cuda").to(torch.int8)
            scale = randn(n).abs() * k ** -0.5 / 64
        else:
            w = (randn(k, n) * k ** -0.5).to(types[w_kind])
        bias = randn(n)
        kw = dict(act="relu", w_scale=scale)
        tol = TOL_FC if x_kind == 0 else TOL_BF16
        return (lambda: kern(x, w, bias, **kw)), plain(x, w, bias, **kw), tol
    if lau.kernel == "sa_conv_implicit":
        batch, h, w, ci, p, q, co, stride, _ = lau.shape
        x = randn(batch, h, w, ci)
        f = randn(p, q, ci, co) * (p * q * ci) ** -0.5
        bias = randn(co)
        kw = dict(stride=stride, act="relu", pool_window=lau.pool[0],
                  pool_stride=lau.pool[1])
        return ((lambda: sa_conv_implicit(x, f, bias, **kw)),
                sa_conv_plain(x, f, bias, **kw), TOL_CONV)
    if lau.kernel == "pool_act":
        n, h, w, c, itemsize, window, stride = lau.shape
        x = randn(n, h, w, c, dtype=torch.float32 if itemsize == 4
                  else torch.bfloat16)
        kw = dict(window=window, stride=stride, act="relu")
        return (lambda: maxpool_act(x, **kw)), ref.maxpool_act(x, **kw), None
    b, sq, skv, hq, hkv, d, causal, window, _ = lau.shape
    q_, k_, v_ = randn(b, sq, hq, d), randn(b, skv, hkv, d), \
        randn(b, skv, hkv, d)
    kw = dict(causal=causal, window=window)
    return ((lambda: flash_attention(q_, k_, v_, **kw)),
            flash_plain(q_, k_, v_, **kw), TOL_ATTN)


def edge_phase(rep: Report) -> list[dict]:
    """Each edge launch of ``analysis/launch.py`` (after the launch pass
    holds it): the output's block first filled with NaN through a freed
    tensor of its size, then the kernel against its plain version (the
    pool bitwise), no NaN left where the plain version has none."""
    import torch
    from repro_torch.analysis import launch as L
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for lau in L.edge_launches():
        bad = L.check_launch(lau)
        if bad:
            raise AssertionError(f"{lau.op}: " + "; ".join(map(str, bad)))
        call, want, tol = edge_call(lau, gen)
        torch.cuda.synchronize()
        ptr = nan_primed(want.numel(), want.dtype)
        got = call()
        torch.cuda.synchronize()
        reused = got.data_ptr() == ptr
        nan_left = int((torch.isnan(got) & ~torch.isnan(want)).sum())
        if nan_left:
            raise AssertionError(f"{lau.op}: {nan_left} outputs left NaN "
                                 "where the plain version has none")
        err = 0.0
        if tol is None:
            exact(lau.op, got, want)
        else:
            err = allclose(lau.op, got, want, tol)
        rows.append(dict(op=lau.op, kernel=lau.kernel, shape=lau.shape,
                         geometry=[str(g) for g in lau.geoms],
                         nan_block_reused=reused, max_abs_err=err))
        log(f"  {lau.op} {lau.shape}: max|d| {err:.3g}, NaN-filled block "
            f"{'reused' if reused else 'not reused'}, no NaN left")
    return rows


def analysis_phase(rep: Report, smi: str) -> dict:
    """Phase 11: ``python -m repro_torch.analysis`` in process (exit 0;
    ops and findings per pass), the launch pass over the LM configs, the
    card's SMs and opt-in shared memory against the constants the
    geometry was derived from, every kernel's static shared memory from
    ptxas and its dynamic shared memory from its exported query against
    the launch pass, for every launch of the zoo variants and the LM
    configs, then the edge launches."""
    import contextlib
    import io
    from repro_torch.analysis import launch as L
    from repro_torch.analysis.__main__ import main as analysis_main
    from repro_torch.core.accelerator import gpu_card
    from repro_torch.kernels import _build
    from repro_torch.kernels import sa_conv_implicit as conv
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = analysis_main(list(ANALYSIS_ARGS))
    text = buf.getvalue()
    for line in text.splitlines():
        if line.startswith("["):
            log(f"  {line}")
    if rc != 0:
        raise AssertionError(f"repro_torch.analysis {' '.join(ANALYSIS_ARGS)}"
                             f" exited {rc}:\n{text}")
    ops = int(re.search(r"\[repro_torch\.analysis\] OK: (\d+) op",
                        text).group(1))
    per_pass = {p: 0 for p in ("coverage", "residency", "race", "accounting",
                               "determinism", "launch")}
    for m in re.finditer(r"^  \[(\w+)\] ", text, re.M):
        per_pass[m.group(1)] += 1
    lm = L.lm_launches()
    lm_rep = L.verify_launches(lm, label="lm launches")
    log(f"  {lm_rep.summary()}")
    if not lm_rep.ok:
        raise AssertionError(lm_rep.summary())
    per_pass["launch"] += len(lm_rep.findings)

    card = gpu_card()
    if card.smem_per_block_optin != conv.SMEM_MAX + conv.SMEM_STATIC or \
            card.smem_per_block_optin != L.SMEM_OPTIN:
        raise AssertionError(
            f"opt-in shared memory per CTA: the card {card.smem_per_block_optin}"
            f" B, the geometry's SMEM_MAX + SMEM_STATIC "
            f"{conv.SMEM_MAX + conv.SMEM_STATIC} B, the launch pass's "
            f"{L.SMEM_OPTIN} B")
    if card.sm_count != conv.SM_COUNT:
        log(f"  WARNING: {card.sm_count} SMs, the geometry costs "
            f"{conv.SM_COUNT} (costs change, results do not)")

    static, faults = {}, []
    for lib, symbol in KERNEL_SYMBOLS.items():
        insts = ptxas_static(_build.build_log(lib), symbol)
        want = (L.STATIC_SMEM[lib], 0)
        found = sorted(set(insts))
        static[lib] = dict(instantiations=len(insts),
                           static_bytes=sorted({v[0] for v in insts}),
                           spill_bytes=sorted({v[1] for v in insts}))
        log(f"  ptxas {lib}: {len(insts)} instantiations, (static shared "
            f"memory B, spill B) {found}; the launch pass: {want}")
        if not insts or found != [want]:
            faults.append(f"ptxas {lib}: {found} over {len(insts)} "
                          f"instantiations, the launch pass {want}")
    if faults:
        raise AssertionError("; ".join(faults))

    dynamic: dict[tuple, int] = {}
    launches = analysis_launches()
    for lau in launches:
        for lib, args, derived in L.smem_queries(lau):
            if (lib, args) in dynamic:
                continue
            got = _build.smem_query(lib, *args)
            if got != derived:
                raise AssertionError(
                    f"{lau.op}: {lib}'s query says {got} B of dynamic "
                    f"shared memory for {args}, the launch pass {derived} B")
            dynamic[(lib, args)] = got
    by_lib: dict[str, list[int]] = {}
    for (lib, _), v in dynamic.items():
        by_lib.setdefault(lib, []).append(v)
    for lib, vals in sorted(by_lib.items()):
        log(f"  {lib}: {len(vals)} distinct launches' dynamic shared memory "
            f"== the launch pass ({min(vals)}..{max(vals)} B)")

    edges = edge_phase(rep)
    card_line = dict(name=card.name, smi=smi, sm_count=card.sm_count,
                     smem_per_block_optin=card.smem_per_block_optin)
    out = dict(ops=ops, lm_launches=len(lm), findings=per_pass,
               card=card_line, static_smem=static,
               dynamic_smem={lib: dict(queries=len(v), min=min(v),
                                       max=max(v))
                             for lib, v in sorted(by_lib.items())},
               launches_checked=len(launches), edges=edges,
               wall_s=time.perf_counter() - t0)
    rep.detail["analysis"] = out
    log(f"  [{smi}] phase 11: {ops} ops and {len(lm)} LM launches checked, "
        f"findings {per_pass}; {len(dynamic)} shared-memory queries, "
        f"{len(edges)} edge launches; {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# conv2d_im2col: the patch matrix on the SA-CONV GEMM (B4), a benchmark
# reference beside the implicit-GEMM SA-CONV (B2)
# ---------------------------------------------------------------------------
def check_im2col(rep: Report, shapes: dict) -> None:
    """``conv2d_im2col`` against ``conv2d_mpna`` at AlexNet conv2-conv5 (b
    = 64, fp32, their padded inputs, relu, no pool): within the conv
    tolerance, one GEMM launch each (and one SA-CONV launch for the shim),
    timed beside SA-CONV and beside the GEMM alone on the patch matrix."""
    import torch
    from repro_torch.kernels.conv2d import (conv2d_im2col, conv2d_mpna,
                                            im2col)
    from repro_torch.kernels.sa_conv import sa_conv_matmul
    for name, xin, p, _, kw in shapes["conv"][1:]:
        f, b, s = p["f"], p["b"], kw["stride"]
        reset_counters()
        got = conv2d_im2col(xin, f, b, stride=s, act="relu")
        expect_counts(counters(), f"conv2d_im2col {name}", sa_conv_matmul=1)
        reset_counters()
        want = conv2d_mpna(xin, f, b, stride=s, act="relu")
        expect_counts(counters(), f"conv2d_mpna {name}", sa_conv_implicit=1)
        e = allclose(f"conv2d_im2col {name} vs conv2d_mpna", got, want,
                     TOL_CONV)
        rep.note_err("sa_conv_matmul", e)
        pp, qq, ci, co = f.shape
        lhs = im2col(xin, pp, qq, s)
        rhs = f.permute(2, 0, 1, 3).reshape(ci * pp * qq, co)
        flops = 2 * lhs.shape[0] * lhs.shape[1] * co
        ms = timed(lambda: conv2d_im2col(xin, f, b, stride=s, act="relu"))
        gemm_ms = timed(lambda: sa_conv_matmul(lhs, rhs, b, act="relu"))
        mpna_ms = timed(lambda: conv2d_mpna(xin, f, b, stride=s, act="relu"))
        rep.rows.append(dict(
            kernel="sa_conv_matmul", shape=f"conv2d_im2col {name} "
            f"{tuple(xin.shape)} patches {tuple(lhs.shape)}", ms=ms,
            gemm_ms=gemm_ms, conv2d_mpna_ms=mpna_ms, flops=flops,
            patch_bytes=nbytes(lhs), path="conv2d_im2col", per_pass=1,
            max_abs_err=e))
        log(f"  conv2d_im2col {name}: patches {tuple(lhs.shape)} "
            f"({nbytes(lhs) / 1e6:.0f} MB), max|d| vs conv2d_mpna {e:.3g}; "
            f"{ms:.4f} ms (GEMM alone {gemm_ms:.4f}) vs SA-CONV "
            f"{mpna_ms:.4f} ms; 1 GEMM launch")
        del lhs, rhs, got, want
    torch.cuda.synchronize()


def geometry_log(q) -> str:
    """The tiling flash_geometry picks for causal self-attention on q."""
    from repro_torch.kernels.attention import flash_geometry
    b, s, h, d = q.shape
    g = flash_geometry(b, s, s, h, h, d, True, 0)
    return (f"{g.bq}-row tiles{', paired' if g.paired else ''}, "
            f"{g.ctas} CTAs")


def kernels_line(rep: Report, cnn: dict, declined: dict, lm: dict,
                 lm_bf16: dict, zoo: dict, cnn_bf16: dict,
                 fleet: dict, train: dict) -> dict:
    """One entry per kernel, read on the path it is reported for:
    ``CNNServer.run`` (130 requests) for SA-CONV implicit and SA-FC, the
    declined-fusion dispatch for the pool kernel, ``ServeEngine.run`` (9
    OLMo-1B requests, fp32) for the SA-CONV GEMM and flash attention.
    Times sum one unit of that path at its shapes: a b=64 CNN wave, or a
    full-wave OLMo prefill (each shape times its launches per prefill).
    Then one entry per bf16 kernel (``<kernel>[bf16]``), read on the bf16
    ``ServeEngine.run`` (OLMo-1B as published): a full-wave prefill for
    the GEMM and flash, a decode step at b = 4 for SA-FC, bounded by bf16's
    tensor-core rate; and one per CNN kernel with bf16 activations (C6):
    SA-CONV implicit summed over AlexNet's five convs at b = 64 on AlexNet's
    forward with bf16 activations, the pool at the bf16 declined-fusion
    dispatch.  Then one entry per kernel of the train path
    (``<kernel>[train]``), read on phase 10's ``trainer.run`` (OLMo-1B as
    published, 4 steps): one step's work, the GEMM's forward, remat
    recompute, ``pre``, ``dx`` and ``dw`` launches and flash's forward
    ones, bounded by bf16's rate.  ``launches_by_path`` gives every path's
    count (the zoo's ``ModelZooServer.serve``, the bf16 ``CNNServer.run``,
    ``fleet``, the fleet's three executed configurations, and
    ``trainer.run`` among them);
    ``host_ms``, where measured (SA-FC), sums the same unit timed with the
    card drained before each call."""
    def entry(name, kernel, path, launches, rows, peak):
        if not rows:
            raise AssertionError(f"{name}: no timing on {path}")

        def total(key):
            return sum(r[key] * r["per_pass"] for r in rows)

        lib = [r["library_ms"] for r in rows]
        t_ops = total("flops") / peak * 1e3
        t_bytes = total("bytes") / PEAK_BYTES_PER_S * 1e3
        source, replaces = SOURCES[kernel]
        return dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches, path=path,
            launches_by_path={p: c[kernel] for p, c in paths.items()},
            max_abs_err=rep.err[name],
            ms=total("ms"), plain_ms=total("plain_ms"),
            host_ms=None if any(r.get("host_ms") is None for r in rows)
            else total("host_ms"),
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=None if any(v is None for v in lib) else
            sum(v * r["per_pass"] for v, r in zip(lib, rows)))

    paths = {"CNNServer.run": cnn,
             "Engine.conv2d, pool fusion declined": declined,
             "ServeEngine.run": lm, "ServeEngine.run bf16": lm_bf16,
             "ModelZooServer.serve": zoo["zoo"],
             "cnn_forward bf16": zoo["bf16"],
             "Engine.conv2d bf16, pool fusion declined":
                 zoo["declined_bf16"],
             "CNNServer.run bf16": cnn_bf16, "fleet": fleet,
             "trainer.run": train}
    out = []
    for kernel in SOURCES:
        if kernel == "maxpool_act":
            path, launches = "Engine.conv2d, pool fusion declined", declined
        elif kernel in CNN_KERNELS:
            path, launches = "CNNServer.run", cnn
        else:
            path, launches = "ServeEngine.run", lm
        timing = "CNNServer.run" if kernel in CNN_KERNELS else path
        rows = [r for r in rep.rows if r["kernel"] == kernel
                and r["path"] == timing and not r["shape"].endswith("int8")
                and r.get("phase", "prefill") == "prefill"]
        out.append(entry(kernel, kernel, path, launches[kernel], rows,
                         PEAK_FP32_FLOPS))
    for kernel, name in BF16_KERNELS.items():
        phase = "decode" if kernel == "sa_fc_matmul" else "prefill"
        rows = [r for r in rep.rows if r["kernel"] == name
                and r["path"] == "ServeEngine.run bf16"
                and r["phase"] == phase]
        out.append(entry(name, kernel, "ServeEngine.run bf16",
                         lm_bf16[kernel], rows, PEAK_BF16_FLOPS))
    for kernel, name in CNN_BF16_KERNELS.items():
        path = "cnn_forward bf16" if kernel == "sa_conv_implicit" else \
            "Engine.conv2d bf16, pool fusion declined"
        rows = [r for r in rep.rows if r["kernel"] == name
                and r["path"] == path]
        out.append(entry(name, kernel, path, paths[path][kernel], rows,
                         PEAK_BF16_FLOPS))
    for kernel, name in TRAIN_KERNELS.items():
        rows = [r for r in rep.rows if r["kernel"] == name
                and r["path"] == "trainer.run"]
        out.append(entry(name, kernel, "trainer.run", train[kernel], rows,
                         PEAK_BF16_FLOPS))
    return {"kernels": out}


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.core.quant import quantize_cnn_params
    from repro_torch.models.cnn import init_cnn

    t_start = time.perf_counter()
    rep = Report()
    log("== phase 1: environment")
    smi = environment(rep)
    log("== phase 2: build")
    build(rep)

    torch.set_grad_enabled(False)
    params = init_cnn("alexnet", SEED)                       # on the card
    qparams = quantize_cnn_params(params)
    rng = np.random.default_rng(SEED)
    images_np = rng.standard_normal((N_REQUESTS, 227, 227, 3)).astype(
        np.float32)
    log("== phase 3: kernels against their plain versions (b=64 chain)")
    shapes = check_kernels(rep, params, qparams,
                           torch.from_numpy(images_np[:64]).cuda())
    log("== phase 4: CNNServer, full-width AlexNet at 227x227")
    served = serve(rep, params, qparams, images_np)
    served_bf16 = serve_bf16(rep, params, images_np)
    log("== phase 5: times (median of 25, CUDA events, L2 flushed, card "
        "held busy)")
    measure(rep, shapes, params, images_np)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        check_im2col(rep, shapes)
    del params, qparams, shapes["conv"], shapes["fc"], shapes["pool"]
    torch.cuda.empty_cache()

    from repro_torch.models import transformer as T
    from repro_torch.serve.kvcache import cache_bytes
    log("== phase 6: ServeEngine, full-width OLMo-1B in fp32")
    cfg = olmo_config()
    lm_params = T.init_params(cfg, SEED, device=DEVICE)
    log(f"  OLMo-1B: {cfg.n_params() / 1e9:.3f} B parameters, "
        f"{cache_bytes(lm_params) / 1e9:.2f} GB on the card (with the "
        "contiguous tied-head copy)")
    lm_shapes = check_lm_kernels(rep, cfg, lm_params)
    lm_served = serve_lm(rep, cfg, lm_params)
    lm_throughput(rep, cfg, lm_params)
    log("  times (median of 25, CUDA events, L2 flushed, card held busy; plain: "
        "fewer runs)")
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        measure_lm(rep, lm_shapes)
    del lm_params, lm_shapes
    torch.cuda.empty_cache()

    log("== phase 7: ServeEngine, full-width OLMo-1B as published (bf16 "
        "parameters, compute and cache)")
    cfg16 = olmo_bf16_config()
    params16 = T.init_params(cfg16, SEED, device=DEVICE)
    log(f"  OLMo-1B bf16: {cfg16.n_params() / 1e9:.3f} B parameters, "
        f"{cache_bytes(params16) / 1e9:.2f} GB on the card (with the "
        "contiguous tied-head copy)")
    bf16_shapes = check_lm_kernels_bf16(rep, cfg16, params16)
    bf16_served = serve_lm_bf16(rep, cfg16, params16)
    lm_throughput(rep, cfg16, params16, torch.bfloat16, prefix="lm_bf16")
    log("  bf16 times (median of 25, CUDA events, L2 flushed, card held "
        "busy; bound: bf16 operations at 989 TFLOP/s or bytes)")
    measure_lm_bf16(rep, bf16_shapes)
    del params16, bf16_shapes
    torch.cuda.empty_cache()

    log("== phase 8: ModelZooServer, full-width AlexNet, VGG-16 and int8 "
        "AlexNet; bf16 activations in SA-CONV implicit and the pool (C6)")
    zoo = zoo_phase(rep)
    log("== phase 9: FleetServer, the zoo at full width on four replicas "
        "(launch/fleet.py's seven configurations)")
    fleet = fleet_phase(rep, zoo["models"])
    del zoo["models"]
    torch.cuda.empty_cache()

    log("== phase 10: training, full-width OLMo-1B as published (bf16), "
        "trainer.run on the kernels backend")
    with torch.enable_grad():
        train = train_phase(rep, smi)
    torch.cuda.empty_cache()

    log("== phase 11: the static checks against the card "
        "(python -m repro_torch.analysis, shared memory, edge launches)")
    analysis = analysis_phase(rep, smi)

    line = kernels_line(rep, served["launches"], shapes["declined_launches"],
                        lm_served["launches"], bf16_served["launches"], zoo,
                        served_bf16, fleet, train)
    rep.detail["rows"] = rep.rows
    rep.detail["kernels"] = line["kernels"]
    rep.detail["total_s"] = time.perf_counter() - t_start
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(rep.detail,
                                                        indent=1))
    log(f"total {rep.detail['total_s']:.1f}s")
    print(json.dumps({"analysis": {
        k: analysis[k] for k in ("ops", "lm_launches", "findings", "card",
                                 "static_smem", "dynamic_smem",
                                 "launches_checked", "wall_s")}
        | {"edges": len(analysis["edges"])}}))
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
