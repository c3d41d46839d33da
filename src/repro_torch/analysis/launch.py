"""The ``launch`` pass: what the port's CUDA kernels launch, checked
statically.

In the reference the plan's tiles *are* the Pallas launch (the kernels
build their ``BlockSpec``\\ s from :mod:`repro_torch.kernels.geometry`'s
counterpart), so the four schedule passes certify what runs.  The port's
CUDA kernels pick their own tiles from the op's shape:
:func:`~repro_torch.kernels.sa_fc.fc_launch`,
:func:`~repro_torch.kernels.sa_conv.gemm_geometry`,
:func:`~repro_torch.kernels.sa_conv_implicit.conv_geometry` with
``conv_tiles`` and ``column_strips``,
:func:`~repro_torch.kernels.pool_act.pool_geometry` and
:func:`~repro_torch.kernels.attention.flash_geometry`.  This module builds,
for each schedule entry, the launch the kernels backend makes for it (as
:class:`Launch`, built the way each wrapper builds it) and checks four
invariants of it, all under the pass name ``launch``:

* **coverage** — every output element is written by exactly one CTA and
  one thread (the kernels' masks for partial tiles included); SA-FC's
  tensor-core kernel runs every (column tile, k segment, row tile) unit
  once; conv bands
  never split a pool window and compute every conv row the emitted map
  needs; column strips cover the emitted columns once and read exactly
  the input columns they need; SA-FC's segments cover k once (the last
  may be shorter); the kv tiles a query tile loops over include every key
  any of its rows may see;
* **residency** — each kernel's dynamic plus static shared memory is at
  most what a CTA may opt into on an H100, and the CTAs an SM must hold
  fit its shared memory; the dynamic figure is re-derived here from the
  tile's fields and must equal the figure the geometry passes to the
  kernel; SA-CONV's staged rows and segments fit its static tables;
* **race** — no two CTAs write one output; a split SA-FC launch gives
  each (segment, row, column) partial slot and each (column tile, row
  tile) arrival counter one writer, its scratch holds what the kernel
  indexes, and the scratch is kept per (device, stream); a tensor-core
  launch runs each unit on one warp (narrow: a warp of the CTA that owns
  the tile's segments; wide: its split launches on the same scratch);
* **order** — every output sums its terms in an order that depends only
  on the contraction's shape, never on the batch, ``m``, the CTA or the
  thread, checked over every batch from 1 to the entry's: SA-FC's split
  over k (both kernels; the tensor-core kernel runs every bf16 x launch,
  the FMA kernel every fp32 one, and within a row tile its unit
  assignment does not follow b), the GEMM's k order, SA-CONV's tile and channel grouping (fused
  pool or not), and the kv tiles each query row sums for every query-tile
  height and pairing.  Rows == m = 1, batched == unbatched and fused ==
  unfused pool rest on this.

Flash attention is never scheduled: :func:`lm_launches` checks it at the
attention shapes of every LM config the port runs, causal or not (an
encoder's self-attention and cross-attention to it are not).  Nothing here launches
a kernel or touches a device: the launches are built with the wrappers' own
Python geometry functions, called through their modules (so a test can
replace one with a faulty version and see the pass catch it).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.analysis.report import AnalysisReport, Finding
from repro_torch.core.dataflow import ConvPlan
from repro_torch.kernels import attention, pool_act, sa_conv, sa_fc
from repro_torch.kernels import sa_conv_implicit as conv

#: shared memory of an H100 (the CUDA programming guide's Hopper figures;
#: phase 11 of chip_smoke.py holds the opt-in against the card): what one
#: CTA may opt into, what one SM holds, and what the system keeps of it
#: for each resident CTA
SMEM_OPTIN = 232448
SMEM_PER_SM = 233472
SMEM_RESERVED = 1024

#: each kernel's static shared memory, as ptxas must report it: its
#: static variables, counted up to the 16-byte alignment of the dynamic
#: buffer that follows them -- SA-FC's ``__shared__ int last``; SA-CONV
#: implicit's row table (MAX_ROWS ints), segment table (MAX_SEGMENTS x 7
#: fields) and its 3 counts (csrc/sa_conv_implicit.cu); none for the others
SG_FIELDS = 7


def _static(var_bytes: int) -> int:
    return -(-var_bytes // 16) * 16


STATIC_SMEM = {
    "sa_fc": _static(4),
    "sa_fc_tc": 0,
    "sa_conv": 0,
    "sa_conv_implicit": _static(4 * (conv.MAX_ROWS
                                     + SG_FIELDS * conv.MAX_SEGMENTS + 3)),
    # bf16 x's tensor-core kernel keeps its tables in dynamic memory
    "sa_conv_implicit[tc]": 0,
    "pool_act": 0,
    "attention": 0,
}

#: codes of the kernels' operand types (csrc/common.cuh Kind)
W_KIND = {"float32": 0, "int8": 1, "bfloat16": 2}
X_KIND = {"float32": 0, "bfloat16": 2}
KIND_BYTES = {0: 4, 1: 1, 2: 2}

#: the pool kernel's type code of a map of each element size (the maps
#: the engine pools: fp32, bf16, int8)
POOL_DTYPE = {4: 0, 2: 4, 1: 1}
#: base alignments a pool operand may have: the pool kernel's vector
#: follows the pointers, so its coverage is checked at each
POOL_ALIGNS = (16, 8, 4, 2, 1)

#: LM shapes whose launches :func:`lm_launches` checks, as (phase, batch,
#: sequence): chip_smoke.py phases 6 and 7 (waves of 4 and a lone request
#: of 512 prompt tokens, decode at 4 slots), phases 10, 14 and 15
#: (training on 4 x 512 tokens) and launch/serve.py (prompts of 8 tokens,
#: waves of 4)
LM_SHAPES = (("prefill", 4, 512), ("prefill", 1, 512), ("decode", 4, 512),
             ("train", 4, 512), ("prefill", 4, 8))
#: the KV cache depth of chip_smoke.py's ServeEngine
LM_MAX_SEQ = 640
#: the serving shapes of the encoder-decoder and vision configs, served by
#: ``greedy_generate`` in chip_smoke.py phase 13 (seamless: 4 requests of
#: 16 tokens; llava: 2 of 32 behind its vision tokens), checked with
#: LM_SHAPES' serving shapes; the audio frames are the config's own
FRONTEND_SHAPES = (("prefill", 4, 16), ("decode", 4, 16),
                   ("prefill", 2, 32), ("decode", 2, 32))


@dataclass(frozen=True)
class Launch:
    """What a kernel wrapper launches for one op, as data.

    ``geoms`` holds one geometry per kernel launch: one, or one per column
    strip for SA-CONV (``strips``), or, for the pool, the launch at each
    base alignment a pointer may have.  ``shape`` is the wrapper's
    arguments: SA-FC ``(b, k, n, w_kind, x_kind)`` (kernel ``"sa_fc"`` or
    ``"sa_fc_tc"``, as the wrapper routes it); the GEMM ``(m, n, k,
    w_kind, x_kind)``; SA-CONV ``(batch, h, w, ci, p, q, co, stride,
    x_kind)`` with ``pool`` the fused ``(window, stride)`` or ``(0, 0)``;
    the pool ``(n, h, w, c, itemsize, window, stride)``; flash ``(b, sq,
    skv, hq, hkv, d, causal, window, itemsize)``."""
    op: str
    kernel: str
    shape: tuple
    geoms: tuple
    strips: tuple = ()
    pool: tuple[int, int] = (0, 0)


# ---------------------------------------------------------------------------
# launches: each wrapper's geometry, built as the wrapper builds it
# ---------------------------------------------------------------------------
#: the torch dtype of each operand code
KIND_DTYPE = {0: torch.float32, 1: torch.int8, 2: torch.bfloat16}


def fc_launch(op: str, b: int, k: int, n: int, w_kind: int,
              x_kind: int) -> Launch:
    """:func:`~repro_torch.kernels.sa_fc.sa_fc_matmul` on (b, k) @ (k, n):
    the tensor-core kernel where ``tc_route`` says so (bf16 x), else the
    FMA kernel."""
    shape = (b, k, n, w_kind, x_kind)
    if sa_fc.tc_route(KIND_DTYPE[x_kind]):
        return Launch(op, "sa_fc_tc", shape,
                      (sa_fc.tc_launch(b, k, n, KIND_BYTES[w_kind]),))
    return Launch(op, "sa_fc", shape, (sa_fc.fc_launch(b, k, n),))


def gemm_launch(op: str, m: int, n: int, k: int, w_kind: int,
                x_kind: int) -> Launch:
    """:func:`~repro_torch.kernels.sa_conv.sa_conv_matmul` on (m, k) @
    (k, n)."""
    return Launch(op, "sa_conv", (m, n, k, w_kind, x_kind),
                  (sa_conv.gemm_geometry(m, n, k, w_kind, x_kind),))


def conv_launch(op: str, batch: int, h: int, w: int, ci: int, p: int,
                q: int, co: int, stride: int, pool_window: int,
                pool_stride: int, x_kind: int) -> Launch:
    """:func:`~repro_torch.kernels.sa_conv_implicit.sa_conv_implicit` on a
    padded (batch, h, w, ci) input, pool fused when ``pool_window``: one
    launch over the whole width, or one per column strip."""
    kw = dict(stride=stride, pool_window=pool_window,
              pool_stride=pool_stride, x_bytes=KIND_BYTES[x_kind])
    strips = conv.column_strips(h, w, ci, p, q, co, **kw)
    if len(strips) == 1:
        geoms = (conv.conv_geometry(h, w, ci, p, q, co, **kw),)
    else:
        geoms = tuple(conv.conv_geometry(h, x1 - x0, ci, p, q, co, **kw)
                      for _, _, x0, x1 in strips)
    pool = (pool_window, pool_stride or pool_window) if pool_window \
        else (0, 0)
    return Launch(op, "sa_conv_implicit",
                  (batch, h, w, ci, p, q, co, stride, x_kind), geoms, strips,
                  pool)


def pool_launch(op: str, n: int, h: int, w: int, c: int, itemsize: int,
                window: int, stride: int) -> Launch:
    """:func:`~repro_torch.kernels.pool_act.maxpool_act` on an (n, h, w, c)
    map, at every base alignment (each vector width the wrapper may
    pick)."""
    geoms = {}
    for align in POOL_ALIGNS:
        g = pool_act.pool_geometry(n, h, w, c, itemsize, window, stride,
                                   align)
        geoms.setdefault(g.vec_bytes, g)
    return Launch(op, "pool_act", (n, h, w, c, itemsize, window, stride),
                  tuple(geoms.values()))


def flash_launch(op: str, b: int, sq: int, skv: int, hq: int, hkv: int,
                 d: int, causal: bool, window: int,
                 itemsize: int) -> Launch:
    """:func:`~repro_torch.kernels.attention.flash_attention` on q (b, sq,
    hq, d) and k/v (b, skv, hkv, d)."""
    g = attention.flash_geometry(b, sq, skv, hq, hkv, d, causal, window,
                                 itemsize)
    return Launch(op, "attention",
                  (b, sq, skv, hq, hkv, d, causal, window, itemsize), (g,))


def launches_for(key, plan) -> list[Launch]:
    """The launches the kernels backend makes for one schedule entry, as
    :class:`~repro_torch.core.engine.Engine` dispatches it: a conv on
    SA-CONV (its pool fused, or then on the pool kernel when the planner
    declined to fuse it), a matmul on SA-FC in the ``sa_fc`` regime and on
    the GEMM otherwise."""
    if isinstance(plan, ConvPlan):
        x_kind = X_KIND[key.dtype]
        out = [conv_launch(f"{key.name} [sa_conv_implicit]", key.batch,
                           key.h, key.w, key.ci, key.p, key.q, key.co,
                           key.stride,
                           plan.pool_window if plan.fuse_pool else 0,
                           plan.pool_stride, x_kind)]
        if key.pool_window and not plan.fuse_pool:
            oh = (key.h - key.p) // key.stride + 1
            ow = (key.w - key.q) // key.stride + 1
            out.append(pool_launch(f"{key.name}.pool [pool_act]", key.batch,
                                   oh, ow, key.co, KIND_BYTES[x_kind],
                                   key.pool_window, key.pool_stride))
        return out
    kinds = (W_KIND[key.weight_dtype], X_KIND[key.dtype])
    if plan.regime == "sa_fc":
        return [fc_launch(f"{key.name} [sa_fc]", key.m, key.k, key.n,
                          *kinds)]
    return [gemm_launch(f"{key.name} [sa_conv]", key.m, key.n, key.k,
                        *kinds)]


def backward_launches(key, plan) -> list[Launch]:
    """The launches of one train-schedule matmul's backward on the kernels
    backend (``core/engine.py``'s ``_MatmulFn``, ``_QuantMatmulFn``):
    ``dx = dpre @ w.T`` on the forward's regime kernel and ``dw = x.T @
    dpre`` on the GEMM, ``dpre`` in the activation's dtype; frozen int8
    weights make ``dx`` alone, against ``q.T``.  A non-linear activation's
    recompute of the pre-activation is the forward's launch again."""
    x_kind = X_KIND[key.dtype]
    w_kind = W_KIND[key.weight_dtype]
    if plan.regime == "sa_fc":
        out = [fc_launch(f"{key.name} dx [sa_fc]", key.m, key.n, key.k,
                         w_kind, x_kind)]
    else:
        out = [gemm_launch(f"{key.name} dx [sa_conv]", key.m, key.k, key.n,
                           w_kind, x_kind)]
    if key.weight_dtype != "int8":
        out.append(gemm_launch(f"{key.name} dw [sa_conv]", key.k, key.n,
                               key.m, W_KIND[key.dtype], x_kind))
    return out


def schedule_launches(schedule) -> list[Launch]:
    """Every launch of a compiled schedule, conv entries first."""
    out = []
    for key, plan in schedule.conv_entries.items():
        out.extend(launches_for(key, plan))
    for key, plan in schedule.items():
        out.extend(launches_for(key, plan))
    return out


def lm_configs() -> dict[str, Any]:
    """The LM configs the port runs (those ``check_supported`` accepts), as
    published, and OLMo-1B (chip_smoke.py phase 6), seamless-m4t and
    llava-next (phase 13's fp32 copies) in fp32 as ``"<name>@fp32"``."""
    from repro_torch.configs.registry import all_lm_configs, get_config
    from repro_torch.models.transformer import check_supported
    out = {}
    for name, cfg in sorted(all_lm_configs().items()):
        try:
            check_supported(cfg)
        except NotImplementedError:
            continue
        out[name] = cfg
    for name in ("olmo-1b", "seamless-m4t-large-v2", "llava-next-34b"):
        out[f"{name}@fp32"] = dataclasses.replace(
            get_config(name), param_dtype="float32", compute_dtype="float32")
    return out


def _frontend_inputs(cfg, batch: int, device) -> dict:
    """The stubbed frontends' inputs of a batch: the config's audio frames
    (enc-dec) or vision tokens."""
    shape = (batch, cfg.audio_frames if cfg.enc_dec else cfg.vision_tokens,
             cfg.frontend_dim)
    return {"audio_embeds" if cfg.enc_dec else "vision_embeds":
            torch.empty(shape, dtype=getattr(torch, cfg.compute_dtype),
                        device=device)}


def traced_entries(cfg, phase: str, batch: int, seq: int) -> dict:
    """The matmul entries (as a schedule holds them) of one step of an
    encoder-decoder or vision config with its frontend inputs, from the
    engine's dispatch records of ``prefill_step``, ``decode_step`` or, in
    ``"train"``, the forward of ``loss_fn`` on meta tensors: such a
    config's serving steps are what ``greedy_generate`` runs, its train
    step's matmuls run over the frames or the vision prefix, and a
    compiled schedule cannot hold them (an enc-dec config has none; a
    vision config's is text-only)."""
    from repro_torch.core.engine import Engine
    from repro_torch.core.schedule import _entries_from_trace
    from repro_torch.models import transformer as T
    from repro_torch.serve import kvcache as KC
    from repro_torch.serve.serve_step import decode_step, prefill_step
    params = T.init_params(cfg, 0, device="meta")
    cache_dtype = getattr(torch, cfg.compute_dtype)
    eng = Engine(backend="torch")
    with eng.tracing() as tr, eng.activate():
        if phase == "train":
            tokens = torch.empty((batch, seq), dtype=torch.int64,
                                 device="meta")
            T.loss_fn(cfg, params, {"tokens": tokens,
                                    **_frontend_inputs(cfg, batch, "meta")})
        elif phase == "prefill":
            tokens = torch.empty((batch, seq), dtype=torch.int64,
                                 device="meta")
            prefill_step(cfg, params, {"tokens": tokens,
                                       **_frontend_inputs(cfg, batch,
                                                          "meta")},
                         LM_MAX_SEQ, cache_dtype)
        elif phase == "decode":
            cache = KC.init_cache(cfg, batch, LM_MAX_SEQ,
                                  enc_len=cfg.audio_frames,
                                  dtype=cache_dtype, device="meta")
            tok = torch.empty((batch, 1), dtype=torch.int64, device="meta")
            decode_step(cfg, params, cache, tok, seq)
        else:
            raise ValueError(f"no traced {phase!r} step")
    return _entries_from_trace(tr)[0]


def attention_shapes(cfg, phase: str, batch: int, seq: int) -> list[tuple]:
    """(label, flash arguments) of each kind of flash launch one step of
    ``cfg`` makes on ``batch`` x ``seq`` tokens: none in decode (decode
    attention is plain); else the decoder's causal self-attention per
    window (global; sliding-window with the config's window) over the
    vision tokens and the text, and an enc-dec config's encoder (frames x
    frames) and cross-attention (text x frames), both non-causal."""
    from repro_torch.configs.base import ATTN_LOCAL, MAMBA
    if phase == "decode":
        return []
    itemsize = getattr(torch, cfg.compute_dtype).itemsize
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.hd)
    s = seq + cfg.vision_tokens
    out = [(f"attn window {w}", (batch, s, s, *heads, True, w, itemsize))
           for w in sorted({cfg.sliding_window if ak == ATTN_LOCAL else 0
                            for ak, _ in cfg.block_kinds() if ak != MAMBA})]
    if cfg.enc_dec:
        f = cfg.audio_frames
        out += [("encoder attn", (batch, f, f, *heads, False, 0, itemsize)),
                ("cross attn", (batch, seq, f, *heads, False, 0, itemsize))]
    return out


def lm_launches(configs: dict[str, Any] | None = None,
                shapes=LM_SHAPES) -> list[Launch]:
    """The launches of LM serving and training: every matmul of each
    config's compiled schedule at ``shapes`` (SA-FC or the GEMM), its
    backward's at the train shapes (:func:`backward_launches`), and flash
    attention at each prefill and train shape, once per kind
    (:func:`attention_shapes`).  Encoder-decoder and vision configs run
    with their frontend inputs (served by ``greedy_generate``, trained on
    the frames or behind the vision prefix): their matmuls come from
    :func:`traced_entries` at ``shapes`` and, served, at
    :data:`FRONTEND_SHAPES`.  Each config runs one layer pattern deep (and
    one encoder layer): every period of the pattern makes the same
    launches."""
    from repro_torch.core.schedule import LayerSchedule
    configs = lm_configs() if configs is None else configs
    out: list[Launch] = []
    for name, cfg in configs.items():
        cfg = dataclasses.replace(cfg, n_layers=len(cfg.pattern),
                                  n_enc_layers=min(cfg.n_enc_layers, 1))
        frontend = cfg.enc_dec or cfg.vision_tokens
        seen = set()
        for phase, batch, seq in (*shapes, *FRONTEND_SHAPES) if frontend \
                else shapes:
            entries = traced_entries(cfg, phase, batch, seq) if frontend \
                else dict(LayerSchedule.compile(
                    cfg, phase, batch=batch, seq=seq, max_seq=LM_MAX_SEQ,
                    cache_dtype=getattr(torch, cfg.compute_dtype)).items())
            launches = [lau for key, plan in entries.items()
                        for lau in launches_for(key, plan)]
            if phase == "train":
                launches += [lau for key, plan in entries.items()
                             for lau in backward_launches(key, plan)]
            for lau in launches:
                if (lau.kernel, lau.shape) not in seen:
                    seen.add((lau.kernel, lau.shape))
                    out.append(dataclasses.replace(
                        lau, op=f"{name} {phase} b{batch}x{seq}: {lau.op}"))
            for label, shape in attention_shapes(cfg, phase, batch, seq):
                if ("attention", shape) in seen:
                    continue
                seen.add(("attention", shape))
                out.append(flash_launch(
                    f"{name} {phase} b{batch}x{seq}: {label} [attention]",
                    *shape))
    return out


def edge_launches() -> list[Launch]:
    """The edge geometries phase 11 of chip_smoke.py launches on the card
    (each must pass this pass first): partial last tiles in m and n (the
    bf16 GEMM through both producers: TMA; cp.async with element x loads
    and 4-byte w pieces, and with fp32 and int8 weights rounded into its
    tiles); SA-FC
    split over k with a short, ragged last segment at b = 1 and one row
    past a 64-row tile, and its tensor-core kernel at b = 1, 5 and 8 with
    odd k, odd n and n off 16 bytes (element and 4-byte copies), over 313
    segments of 40 and of 4104 columns (wide at k = 20000), over 125
    one-chunk segments of 8 columns at b = 8 (narrow, the most partials
    its shared memory holds), with fp32 weights at b = 65 in nine row
    tiles of 8 (18 segments) and narrow at b = 2, with int8 weights and
    odd n at b = 37 (row tiles of 8), in three row tiles of 64 at b = 130;
    SA-CONV flat tiles that cross image boundaries and pooled bands whose last band is short, fp32 and bf16 (the tensor cores:
    ragged co, both tiles, 16-byte gathers and, at ci = 3 and ci = 5, the
    channels padded to 4 and 8 first); the pool at 16-, 8- and 4-byte
    vectors and a single bf16 element; flash with paired CTAs over an odd
    number of query tiles (a partial last one), without and with a window
    that kills each tile's leading kv tiles; and the non-causal flash sweep
    of phase 13 (:func:`noncausal_edge_launches`)."""
    f32, bf16 = X_KIND["float32"], X_KIND["bfloat16"]
    return [
        fc_launch("edge b=1 [sa_fc]", 1, 3999, 1000, W_KIND["float32"], f32),
        fc_launch("edge b=65 [sa_fc]", 65, 3999, 1000, W_KIND["int8"], f32),
        fc_launch("edge tc b=1 odd k [sa_fc_tc]", 1, 3999, 1000,
                  W_KIND["bfloat16"], bf16),
        fc_launch("edge tc b=8 odd n [sa_fc_tc]", 8, 4000, 1001,
                  W_KIND["bfloat16"], bf16),
        fc_launch("edge tc b=5 n off 16 B [sa_fc_tc]", 5, 4097, 262,
                  W_KIND["bfloat16"], bf16),
        fc_launch("edge tc b=8 313 segments [sa_fc_tc]", 8, 20000, 40,
                  W_KIND["bfloat16"], bf16),
        fc_launch("edge tc wide b=3 odd n [sa_fc_tc]", 3, 3999, 5001,
                  W_KIND["bfloat16"], bf16),
        fc_launch("edge tc wide b=8 313 segments [sa_fc_tc]", 8, 20000,
                  4104, W_KIND["bfloat16"], bf16),
        fc_launch("edge tc b=8 125 segments [sa_fc_tc]", 8, 4000, 8,
                  W_KIND["bfloat16"], bf16),
        fc_launch("edge tc b=65 fp32 w [sa_fc_tc]", 65, 3999, 1000,
                  W_KIND["float32"], bf16),
        fc_launch("edge tc b=2 fp32 w narrow [sa_fc_tc]", 2, 4096, 1000,
                  W_KIND["float32"], bf16),
        fc_launch("edge tc b=37 int8 w odd n [sa_fc_tc]", 37, 4000, 1001,
                  W_KIND["int8"], bf16),
        fc_launch("edge tc b=130 64-row tiles [sa_fc_tc]", 130, 1000, 5000,
                  W_KIND["bfloat16"], bf16),
        gemm_launch("edge 130x200 [sa_conv]", 130, 200, 1000,
                    W_KIND["float32"], f32),
        gemm_launch("edge 130x200 bf16 [sa_conv]", 130, 200, 1000,
                    W_KIND["bfloat16"], bf16),
        gemm_launch("edge 130x202 bf16 cp.async [sa_conv]", 130, 202, 1001,
                    W_KIND["bfloat16"], bf16),
        gemm_launch("edge 130x200 bf16 x fp32 w [sa_conv]", 130, 200, 1000,
                    W_KIND["float32"], bf16),
        gemm_launch("edge 130x201 bf16 x int8 w [sa_conv]", 130, 201, 999,
                    W_KIND["int8"], bf16),
        conv_launch("edge flat [sa_conv_implicit]", 3, 15, 15, 16, 3, 3, 40,
                    1, 0, 0, f32),
        conv_launch("edge bands [sa_conv_implicit]", 3, 25, 25, 64, 3, 3, 96,
                    1, 3, 2, f32),
        conv_launch("edge flat bf16 [sa_conv_implicit]", 3, 15, 15, 16, 3, 3,
                    40, 1, 0, 0, bf16),
        conv_launch("edge bands bf16 [sa_conv_implicit]", 3, 25, 25, 64, 3,
                    3, 96, 1, 3, 2, bf16),
        conv_launch("edge bands 512 bf16 [sa_conv_implicit]", 2, 31, 31, 24,
                    5, 5, 40, 1, 3, 2, bf16),
        conv_launch("edge ci=3 stride 4 bf16 [sa_conv_implicit]", 3, 47, 47,
                    3, 11, 11, 24, 4, 3, 2, bf16),
        conv_launch("edge ci=3 flat 512 bf16 [sa_conv_implicit]", 3, 33, 33,
                    3, 3, 3, 24, 1, 0, 0, bf16),
        conv_launch("edge ci=5 flat bf16 [sa_conv_implicit]", 3, 13, 13, 5, 3,
                    3, 24, 1, 0, 0, bf16),
        pool_launch("edge 16 B [pool_act]", 2, 13, 13, 64, 4, 3, 2),
        pool_launch("edge 8 B [pool_act]", 2, 13, 13, 66, 4, 3, 2),
        pool_launch("edge 4 B [pool_act]", 2, 13, 13, 65, 4, 3, 2),
        pool_launch("edge bf16 element [pool_act]", 2, 13, 13, 65, 2, 2, 2),
        flash_launch("edge paired [attention]", 1, 392, 392, 128, 32, 64,
                     True, 0, 4),
        flash_launch("edge paired window [attention]", 1, 392, 392, 128, 32,
                     64, True, 100, 4),
        *noncausal_edge_launches(),
    ]


def noncausal_edge_launches() -> list[Launch]:
    """Non-causal flash (an encoder's self-attention, cross-attention),
    which chip_smoke.py phase 13 launches on the card: fewer, as many and
    more queries than keys (queries aligned to the end of the keys, so the
    first tile's rows sit before key 0 when sq > skv), each over an odd
    number of query tiles with a partial last one, paired and unpaired as
    ``flash_geometry`` picks them, at head dims 64 and 128 (GQA groups of
    1, 2, 4 and 7), fp32 and bf16."""
    nc = dict(causal=False, window=0)
    cases = (("sq<skv paired", (1, 1055, 1500, 16, 16, 64), 4),
             ("sq<skv unpaired", (1, 392, 1024, 16, 16, 64), 2),
             ("sq==skv paired g7", (2, 608, 608, 56, 8, 128), 4),
             ("sq==skv paired g7", (2, 608, 608, 56, 8, 128), 2),
             ("sq==skv unpaired", (1, 392, 392, 2, 1, 64), 2),
             ("sq>skv paired g7", (1, 278, 100, 56, 8, 128), 2),
             ("sq>skv unpaired", (1, 520, 100, 8, 2, 64), 4),
             ("sq>skv unpaired", (1, 3000, 200, 1, 1, 128), 4))
    return [flash_launch(f"edge non-causal {what} d{shape[5]} "
                         f"{'fp32' if itemsize == 4 else 'bf16'} "
                         "[attention]", *shape, itemsize=itemsize, **nc)
            for what, shape, itemsize in cases]


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------
def _spans(what: str, spans, extent: int) -> list[tuple[str, str]]:
    """(sub-check, message) for half-open ``spans`` that do not tile
    ``[0, extent)`` exactly once: a gap is a coverage fault, an overlap a
    race, a span past the end an unmasked write."""
    out = []
    at = 0
    for lo, hi in sorted(spans):
        if hi <= lo:
            out.append(("coverage", f"{what} [{lo}, {hi}) is empty"))
            continue
        if lo > at:
            out.append(("coverage", f"{what} [{at}, {lo}) written by no "
                                    "CTA"))
        elif lo < at:
            out.append(("race", f"{what} [{lo}, {min(at, hi)}) written by "
                                "more than one CTA"))
        at = max(at, hi)
    if at < extent:
        out.append(("coverage", f"{what} [{at}, {extent}) written by no "
                                "CTA"))
    elif at > extent:
        out.append(("coverage", f"{what} [{extent}, {at}) past the extent "
                                f"{extent} is written"))
    return out


def _tiles(extent: int, tile: int, count: int) -> list[tuple[int, int]]:
    """The unmasked spans of ``count`` tiles of ``tile`` over ``extent``."""
    return [(i * tile, min((i + 1) * tile, extent)) for i in range(count)]


def _residency(kernel: str, what: str, derived: int, stated: int,
               per_sm: int = 1) -> list[tuple[str, str]]:
    """Shared memory of a launch: the figure re-derived from the tile
    against the one the geometry passes, and the card's limits."""
    out = []
    static = STATIC_SMEM[kernel]
    if derived != stated:
        out.append(("residency", f"{what}: dynamic shared memory re-derived "
                                 f"from the tile {derived} B != the "
                                 f"geometry's {stated} B — launch and "
                                 "geometry disagree"))
    total = max(derived, stated) + static
    if total > SMEM_OPTIN:
        out.append(("residency", f"{what}: {total} B of shared memory "
                                 f"({static} B static) over the "
                                 f"{SMEM_OPTIN} B a CTA may opt into"))
    elif per_sm * (total + SMEM_RESERVED) > SMEM_PER_SM:
        out.append(("residency", f"{what}: {per_sm} CTAs of {total} B do "
                                 f"not fit an SM's {SMEM_PER_SM} B"))
    return out


def _thread_map(what: str, cells: np.ndarray, size: int
                ) -> list[tuple[str, str]]:
    """Every cell of a CTA's tile owned by exactly one thread."""
    counts = np.bincount(cells, minlength=size)
    out = []
    if (counts == 0).any():
        out.append(("coverage", f"{what}: {(counts == 0).sum()} outputs of "
                                "the CTA's tile owned by no thread"))
    if (counts > 1).any():
        out.append(("race", f"{what}: {(counts > 1).sum()} outputs of the "
                            "CTA's tile owned by more than one thread"))
    return out


# ---------------------------------------------------------------------------
# SA-FC
# ---------------------------------------------------------------------------
def _fc_smem(rows: int, cols: int, w_bytes: int) -> int:
    """A CTA's dynamic shared memory from its tile: a ring of stages (6 at
    up to 8 rows, else 4), each a chunk of 32 k of fp32 x (each row padded
    to 36 elements) and of w, then 4 k-lanes' sums and a running total of
    the tile in fp32."""
    ring = (6 if rows <= 8 else 4) * (rows * 36 * 4 + 32 * cols * w_bytes)
    return ring + 5 * rows * cols * 4


def _scratch_fits(fl, b: int, n: int, nseg: int) -> list[tuple[str, str]]:
    """The split launch's scratch, as the wrapper asks for it: enough
    arrival counters and partial floats for what the kernel indexes, kept
    per (device, stream)."""
    out = []
    dev = torch.device("meta")
    streams = (-1, -2)
    saved = {s: sa_fc._SCRATCH.pop((dev, s), None) for s in streams}
    try:
        arrivals, part = sa_fc._scratch(dev, streams[0],
                                        fl.grid[0] * fl.grid[1],
                                        fl.segments * b * n)
        other, _ = sa_fc._scratch(dev, streams[1], 1, 1)
        keyed = (dev, streams[0]) in sa_fc._SCRATCH and \
            (dev, streams[1]) in sa_fc._SCRATCH and other is not arrivals
    finally:
        for s, v in saved.items():
            sa_fc._SCRATCH.pop((dev, s), None)
            if v is not None:
                sa_fc._SCRATCH[(dev, s)] = v
    tiles = fl.grid[0] * fl.grid[1]
    if arrivals.numel() < tiles:
        out.append(("race", f"arrival counters: {arrivals.numel()} < "
                            f"{tiles}, one per (column tile, row tile) — "
                            "CTAs of different tiles share a counter"))
    if part.numel() < nseg * b * n:
        out.append(("race", f"partials workspace: {part.numel()} floats < "
                            f"{nseg} segments x {b} x {n} — partial slots "
                            "past its end"))
    if not keyed:
        out.append(("race", "split-k scratch is not kept per (device, "
                            "stream): launches on two streams would share "
                            "counters and partials"))
    return out


def check_fc(lau: Launch) -> list[tuple[str, str]]:
    b, k, n, w_kind, x_kind = lau.shape
    (fl,) = lau.geoms
    out: list[tuple[str, str]] = []
    if sa_fc.tc_route(KIND_DTYPE[x_kind]):
        out.append(("order", f"out: b={b} with bf16 x on the FMA kernel — "
                             "the wrapper runs it on the tensor-core "
                             "kernel"))
    rows, cols = fl.rows, fl.cols
    # coverage and races of the outputs: CTA (x, y) writes rows [y rb, ...)
    # and columns [x bn, ...) of out, masked at b and n
    out += _spans("out rows", _tiles(b, rows, fl.grid[1]), b)
    out += _spans("out columns", _tiles(n, cols, fl.grid[0]), n)
    # the epilogue: thread t takes outputs t + threads i of the tile (k-lanes
    # x row groups of up to 8 rows x column groups of 4 columns)
    threads = 4 * (rows // min(rows, 8)) * (cols // 4)
    per = rows * cols // threads
    e = np.arange(threads)[:, None] + threads * np.arange(per)[None, :]
    out += _thread_map("out epilogue", e.ravel(), rows * cols)
    # the split over k, as the kernel derives it from seg_k
    chunks = -(-k // sa_fc.K_CHUNK)
    seg_chunks = fl.seg_k // sa_fc.K_CHUNK
    if fl.seg_k % sa_fc.K_CHUNK or seg_chunks < 1:
        out.append(("coverage", f"k segments: seg_k {fl.seg_k} is not a "
                                f"whole number of {sa_fc.K_CHUNK}-k chunks"))
        return out
    nseg = -(-chunks // seg_chunks) if chunks > seg_chunks else 1
    if fl.segments != nseg:
        out.append(("coverage", f"k segments: fc_launch says "
                                f"{fl.segments}, the kernel derives {nseg} "
                                f"from seg_k {fl.seg_k}"))
    out += _spans("k segments", _tiles(k, fl.seg_k, nseg), k)
    if fl.split:
        # CTA (x, y, z) writes segment z's partials of its tile, slot (z b
        # + row) n + col: with rows and columns tiled once and one z per
        # segment, each slot has one writer; the last CTA to arrive on
        # counter y gx + x adds them
        if fl.grid[2] != nseg:
            out.append(("coverage", f"k segments: grid z {fl.grid[2]} != "
                                    f"{nseg} segments"))
        out += _scratch_fits(fl, b, n, nseg)
    elif fl.grid[2] != 1:
        out.append(("race", f"grid z {fl.grid[2]} on a whole launch: every "
                            "CTA of a tile writes its outputs"))
    # residency
    w_bytes = KIND_BYTES[w_kind]
    out += _residency("sa_fc", f"{rows} x {cols} tile",
                      _fc_smem(rows, cols, w_bytes),
                      sa_fc.fc_smem_bytes(rows, w_bytes))
    # order: the split over k at every batch up to b
    for bb in range(1, b + 1):
        other = sa_fc.fc_launch(bb, k, n)
        if (other.segments, other.seg_k) != (fl.segments, fl.seg_k):
            out.append(("order", f"out sums k in {other.segments} segments "
                                 f"of {other.seg_k} at b={bb} but "
                                 f"{fl.segments} of {fl.seg_k} at b={b}: "
                                 "the split over k must be a function of "
                                 "(k, n) alone"))
            break
    return out


def _fc_tc_smem(narrow: bool, rows: int, w_bytes: int, segments: int,
                span: int) -> int:
    """A tensor-core CTA's dynamic shared memory from its geometry.
    Narrow: 16 warps' rings of 6 stages (4 for fp32 weights), a stage 32 k
    rows of 16 columns of w then 32 k of 8 x rows in bf16; then, where k
    is split, a partial per (group, segment, row, column) of the CTA's
    units in fp32.  Wide: 1024 bytes to align the rings to the swizzle's
    period; 8 warps' rings (4 above 16 rows) of 4 stages, a stage 32 k
    rows of the unit's columns of w (4 KB at up to 16 rows, 2 KB of int8;
    2048 / rows columns above) then 32 k of the tile's x rows, rounded up
    to 1024 bytes; a scratch a warp of its unit's outputs in fp32, rows
    padded by 4 floats; 4 mbarriers a warp."""
    if narrow:
        part = span * segments * 8 * 16 * 4 if segments > 1 else 0
        depth = 4 if w_bytes == 4 else 6
        return 16 * depth * (32 * 16 * w_bytes + 8 * 64) + part
    cols = 2048 // rows if rows > 16 else 4096 // (32 * max(w_bytes, 2))
    warps = 4 if rows > 16 else 8
    stage = -(-(32 * cols * w_bytes + rows * 64) // 1024) * 1024
    return (1024 + warps * 4 * stage + warps * rows * (cols + 4) * 4
            + warps * 4 * 8)


def check_fc_tc(lau: Launch) -> list[tuple[str, str]]:
    b, k, n, w_kind, x_kind = lau.shape
    (d,) = lau.geoms
    out: list[tuple[str, str]] = []
    w_bytes = KIND_BYTES[w_kind]
    if not sa_fc.tc_route(KIND_DTYPE[x_kind]):
        out.append(("order", f"out: the tensor-core kernel runs b={b}, x "
                             f"kind {x_kind} — it takes bf16 x alone"))
    rows = 8 if d.segments >= 8 else next(t for t in (8, 16, 32, 64)
                                          if t >= min(b, 64))
    if d.rows != rows or d.row_tiles != -(-b // rows):
        out.append(("coverage", f"out rows: {d.row_tiles} tiles of "
                                f"{d.rows} rows for b={b}"))
    narrow = b <= 8 and k <= sa_fc.NARROW_MAX and n <= sa_fc.NARROW_MAX
    cols = 16 if narrow else 2048 // d.rows if d.rows > 16 else 4096 // (
        32 * max(w_bytes, 2))
    if d.narrow != narrow or d.cols != cols:
        out.append(("coverage", f"out columns: {d.cols}-column "
                                f"{'narrow' if d.narrow else 'wide'} tiles "
                                f"at b={b}, k={k}, n={n}, where the kernel "
                                "picks narrow tiles of 16 at b <= 8 for k "
                                "and n up to 4096 and wide tiles "
                                "otherwise"))
    # coverage of the outputs: tiles masked at b and n; in a unit, lane (g,
    # t) of the warp holds rows 8 sl + 2 t (+1) and columns 16 j + g (+8)
    # of each n8 slice sl and m16 tile j
    out += _spans("out rows", _tiles(b, d.rows, d.row_tiles), b)
    out += _spans("out columns", _tiles(n, d.cols, d.tiles), n)
    j, sl, g, t, e = np.meshgrid(np.arange(d.cols // 16),
                                 np.arange(d.rows // 8), np.arange(8),
                                 np.arange(4), np.arange(4), indexing="ij")
    cells = (8 * sl + 2 * t + (e & 1)) * d.cols + 16 * j + g + 8 * (e >> 1)
    out += _thread_map("out unit fragments", cells.ravel(), d.rows * d.cols)
    # the k split, as the kernel derives it from seg_k
    chunks = -(-k // sa_fc.K_CHUNK)
    seg_chunks = d.seg_k // sa_fc.K_CHUNK
    if d.seg_k % sa_fc.K_CHUNK or seg_chunks < 1:
        out.append(("coverage", f"k segments: seg_k {d.seg_k} is not a "
                                f"whole number of {sa_fc.K_CHUNK}-k chunks"))
        return out
    nseg = -(-chunks // seg_chunks) if chunks > seg_chunks else 1
    if d.segments != nseg:
        out.append(("coverage", f"k segments: the launch says {d.segments},"
                                f" the kernel derives {nseg} from seg_k "
                                f"{d.seg_k}"))
    out += _spans("k segments", _tiles(k, d.seg_k, nseg), k)
    # every (tile, segment, row tile) unit run by one warp: one writer of
    # its partials or outputs (and, wide, one arrival on its tile's
    # counter); a narrow CTA runs every segment of its tiles
    runs: dict[tuple[int, int, int], int] = {}
    if d.narrow:
        out += _spans("out column tiles", [d.cta_tiles(c)
                                           for c in range(d.ctas)], d.tiles)
    for c in range(d.ctas):
        t0, t1 = d.cta_tiles(c) if d.narrow else (0, d.tiles)
        if d.narrow and t1 - t0 > d.span:
            out.append(("race", f"CTA {c}: {t1 - t0} tiles over the span "
                                f"{d.span} its partial region holds"))
        for i in range(d.workers):
            for unit in d.worker_units(c, i):
                if not t0 <= unit[0] < t1:
                    out.append(("race", f"unit {unit}: run by CTA {c}, which"
                                        f" does not own tile {unit[0]} — "
                                        "two CTAs write its outputs"))
                runs[unit] = runs.get(unit, 0) + 1
    twice = [u for u, v in runs.items() if v > 1]
    if twice:
        out.append(("race", f"units {twice[:3]}: run by more than one warp "
                            "— their partials and outputs have two "
                            "writers"))
    missed = [(t, s, r) for t in range(d.tiles) for s in range(nseg)
              for r in range(d.row_tiles) if (t, s, r) not in runs]
    stray = [u for u in runs if not (0 <= u[0] < d.tiles and 0 <= u[1] < nseg
                                     and 0 <= u[2] < d.row_tiles)]
    if missed:
        out.append(("coverage", f"units {missed[:3]} ({len(missed)} in all)"
                                " run by no worker — a k segment or a column "
                                "tile is never summed"))
    if stray:
        out.append(("coverage", f"units {stray[:3]} past the tiles, the "
                                "segments or the row tiles"))
    # the grid, shared memory, and what the kernel indexes past it
    derived = _fc_tc_smem(d.narrow, d.rows, w_bytes, d.segments, d.span)
    if d.narrow:
        if not 1 <= d.ctas <= min(d.tiles, sa_fc.SM_COUNT) or \
                d.span != -(-d.tiles // d.ctas):
            out.append(("residency", f"grid {d.ctas}, span {d.span}: past "
                                     "the tiles or one CTA an SM"))
        out += _residency("sa_fc_tc", f"{d.rows}-row narrow CTA", derived,
                          d.smem)
        part = derived - _fc_tc_smem(True, d.rows, w_bytes, 1, d.span)
        if part > sa_fc.PART_SMEM_MAX:
            out.append(("residency", f"partials: {part} B over the "
                                     f"{sa_fc.PART_SMEM_MAX} B the kernel "
                                     "keeps (it refuses the launch)"))
        threads = 16 * 32
        outs = d.span * 8 * 16
        e = (np.arange(threads)[:, None]
             + threads * np.arange(-(-outs // threads))[None, :]).ravel()
        out += _thread_map("out segment sum", e[e < outs], outs)
    else:
        units = d.row_tiles * d.tiles * nseg
        if not 1 <= d.ctas <= min(units, sa_fc.SM_COUNT):
            out.append(("residency", f"grid {d.ctas}: past the units or "
                                     f"one CTA on each of {sa_fc.SM_COUNT} "
                                     "SMs"))
        out += _residency("sa_fc_tc", f"{d.rows}-row wide CTA", derived,
                          d.smem)
        if d.split:
            out += _scratch_fits(dataclasses.replace(
                sa_fc.fc_launch(b, k, n), grid=(d.tiles, d.row_tiles, nseg)),
                b, n, nseg)
    # order: the split over k at every batch up to b, and, within the row
    # tile, one unit assignment at every batch
    units = {(c, i): d.worker_units(c, i) for c in range(d.ctas)
             for i in range(d.workers)} if b <= d.rows else None
    for bb in range(1, b + 1):
        other = sa_fc.tc_launch(bb, k, n, w_bytes)
        if (other.segments, other.seg_k) != (d.segments, d.seg_k):
            out.append(("order", f"out sums k in {other.segments} segments "
                                 f"of {other.seg_k} at b={bb} but "
                                 f"{d.segments} of {d.seg_k} at b={b}: the "
                                 "split over k must be a function of (k, n) "
                                 "alone"))
            break
        if units is None or other.rows != d.rows:
            continue
        if (other.narrow, other.ctas, other.tiles) != (
                d.narrow, d.ctas, d.tiles) or any(
                    other.worker_units(c, i) != u
                    for (c, i), u in units.items()):
            out.append(("order", f"out: the units at b={bb} differ from "
                                 f"b={b}'s — within a row tile the "
                                 "assignment must follow (k, n) alone"))
            break
    return out


# ---------------------------------------------------------------------------
# SA-CONV GEMM
# ---------------------------------------------------------------------------
def _gemm_smem(w_bytes: int, x_kind: int) -> int:
    """A CTA's dynamic shared memory from its tile.  fp32 x (the FMA loop):
    a ring of 4 stages of an x tile (k-major, rows of BM + 4 floats) and a
    w tile of BK k.  bf16 x (the tensor cores): 1024 bytes to align the
    ring to the swizzle's period, a ring of 4 stages of a bf16 x tile and
    a bf16 w tile of TC_BK k, TC_RAW_STAGES raw w tiles for weights that
    are not bf16, and two 8-byte mbarriers a stage."""
    g = sa_conv
    if x_kind == 0:
        return g.STAGES * (g.BK * (g.BM + 4) * 4 + g.BK * g.BN * w_bytes)
    raw = 0 if w_bytes == 2 else g.TC_RAW_STAGES * g.TC_BK * g.TC_BN * w_bytes
    return (1024 + g.TC_STAGES * 2 * g.TC_BK * (g.TC_BM + g.TC_BN) + raw
            + 2 * g.TC_STAGES * 8)


def check_gemm(lau: Launch) -> list[tuple[str, str]]:
    m, n, k, w_kind, x_kind = lau.shape
    (g,) = lau.geoms
    bm, bn = g.bm, g.bn
    out: list[tuple[str, str]] = []
    if g.tensor_cores != (x_kind == X_KIND["bfloat16"]):
        where = "the tensor cores" if g.tensor_cores else "the FMA loop"
        out.append(("order", f"out: {'bf16' if x_kind else 'fp32'} x on "
                             f"{where} — bf16 x runs on the tensor cores, "
                             "fp32 x (no TF32) on the FMA loop"))
    if g.tensor_cores and g.producer != (
            "tma" if sa_conv.tma_ok(k, n, w_kind) else "cp.async"):
        out.append(("coverage", f"out: the {g.producer} producer where "
                                "tma_ok says otherwise — TMA needs bf16 w and "
                                "16-byte rows (k % 8 == 0, n % 8 == 0)"))
    origins: dict[tuple[int, int], int] = {}
    for c in range(g.ctas):
        o = g.cta_origin(c)
        if o in origins:
            out.append(("race", f"out tile at {o}: CTAs {origins[o]} and "
                                f"{c} both write it"))
            break
        origins[o] = c
    r0s = sorted({o[0] for o in origins})
    c0s = sorted({o[1] for o in origins})
    out += _spans("out rows", [(r, min(r + bm, m)) for r in r0s], m)
    out += _spans("out columns", [(c, min(c + bn, n)) for c in c0s], n)
    if len(origins) != len(r0s) * len(c0s):
        out.append(("coverage", f"out: {len(origins)} CTA tiles do not "
                                f"span the {len(r0s)} x {len(c0s)} grid "
                                "of row and column tiles"))
    cells = []
    for t in range(g.threads):
        rows, cols = g.thread_outputs(t)
        cells += [r * bn + c for r in rows for c in cols]
    out += _thread_map("out", np.asarray(cells), bm * bn)
    out += _residency("sa_conv", f"{'fp32' if x_kind == 0 else 'bf16'} x",
                      _gemm_smem(KIND_BYTES[w_kind], x_kind), g.smem_bytes,
                      per_sm=g.per_sm)
    # order: every real k of an output summed in increasing order (one
    # thread's fmaf chain, or one accumulator's wgmma steps), the
    # zero-filled tail after them; the launch differs by m only in its
    # row tiles
    order = g.k_order(k)
    pad = len(order) - k
    if order[:k] != list(range(k)) or any(v != -1 for v in order[k:]) \
            or not 0 <= pad < g.bk:
        out.append(("order", f"out: k_order({k}) is not 0..{k - 1} in "
                             "increasing order followed by fewer than "
                             f"{g.bk} zero-filled terms"))
    for mm in range(1, m + 1):
        other = sa_conv.gemm_geometry(mm, n, k, w_kind, x_kind)
        diff = [f.name for f in dataclasses.fields(g) if f.name != "row_tiles"
                and getattr(g, f.name) != getattr(other, f.name)]
        if diff:
            out.append(("order", f"out: the launch at m={mm} differs from "
                                 f"m={m} in {diff}"))
            break
    return out


# ---------------------------------------------------------------------------
# SA-CONV implicit
# ---------------------------------------------------------------------------
#: ring stages of the tensor-core tiles by their pixel slots
#: (csrc/sa_conv_implicit.cu TcTile)
TC_STAGES = {256: 4, 512: 3}


def _conv_smem(g, w: int, ci: int, p: int, q: int, stride: int) -> int:
    """A CTA's dynamic shared memory from its tile.  The FMA loop: the
    larger of the staging ring (one stage, or two when ci takes several
    chunks; a stage is ng groups of rin staged rows of wst pixels of 16
    bytes, and of the filter's taps x cpg channels x bco output channels
    plus a quarter of that for int8's copies) and the epilogue's tile
    (pixels x bco + 1 floats).  The tensor cores: 1024 bytes to align the
    ring, the ring (a stage: 64 k of bf16 for each pixel slot and each
    channel), a long long a slot, the segment table (SG_FIELDS ints a
    segment), 16 bytes of counts and two 8-byte mbarriers a stage; the
    parked tile (pixels x bco + 4 floats) must fit the ring."""
    if g.mb:
        stages = TC_STAGES[g.pixels]
        ring = stages * 64 * 2 * (g.pixels + g.bco)
        if g.pixels * (g.bco + 4) * 4 > ring:
            return -1
        return (1024 + ring + 8 * g.pixels + 4 * SG_FIELDS * conv.MAX_SEGMENTS
                + 16 + 2 * 8 * stages)
    split = (p, q, stride) == (11, 11, 4)
    wst = stride * -(-w // stride) if split else w
    taps = p * q
    words = g.ng * (g.rin * wst * 4 + taps * g.cpg * g.bco
                    + taps * g.cpg * g.bco // 4)
    stages = 2 if -(-ci // (conv.GROUP * g.ng)) > 1 else 1
    return 4 * max(stages * words, g.pixels * (g.bco + 1))


def _conv_order(g, ci: int, p: int, q: int, stride: int) -> tuple:
    """What fixes an output's summation order.  The FMA loop: channel
    groups of cpg in order, taps in (p, q) order (by stride phase at stride
    4), the group's channels in order.  The tensor cores: k = (dp q + dq)
    cp + c in 16-wide steps, cp = ci padded by ``tc_channels``, whatever
    the tile."""
    if g.mb:
        return (ci, p, q, stride, "tensor cores")
    return (ci, p, q, stride, g.cpg)


def _conv_segments(g, batch: int, pool: tuple[int, int], oh: int, ow: int,
                   stride: int, p: int, what: str
                   ) -> list[tuple[str, str]]:
    out: list[tuple[str, str]] = []
    pw, ps = pool if pool[0] else (1, 1)
    poh = (oh - pw) // ps + 1
    spans = []
    bad_band = None
    for tile in range(g.pixel_tiles(batch)):
        segs = conv.conv_tiles(g, batch, tile)
        # the tensor cores' flat tiles address pixels without segments
        if not (g.mb and not g.bands) and \
                not 1 <= len(segs) <= conv.MAX_SEGMENTS:
            out.append(("residency", f"{what} CTA {tile}: {len(segs)} "
                                     f"segments (1..{conv.MAX_SEGMENTS} "
                                     "fit the segment table)"))
        pixels = sum(b - a for _, _, _, a, b, _, _ in segs)
        staged = sum((nr - 1) * stride + p for _, _, nr, *_ in segs)
        if pixels > g.pixels:
            out.append(("coverage", f"{what} CTA {tile}: {pixels} conv "
                                    f"pixels > its {g.pixels} slots"))
        if not g.mb and staged > g.rin:
            out.append(("residency", f"{what} CTA {tile}: stages {staged} "
                                     f"input rows > rin {g.rin}"))
        for img, r0, nr, a, b, pr0, npr in segs:
            if not g.bands:
                spans.append((img * oh * ow + r0 * ow + a,
                              img * oh * ow + r0 * ow + b))
                continue
            spans.append((img * poh + pr0, img * poh + pr0 + npr))
            lo, hi = pr0 * ps, (pr0 + npr - 1) * ps + pw
            if (lo < r0 or hi > r0 + nr or r0 + nr > oh) and bad_band is None:
                bad_band = (f"{what} band of image {img}, emitted rows "
                            f"[{pr0}, {pr0 + npr}): computes conv rows "
                            f"[{r0}, {r0 + nr}) but its {pw}/{ps} pool "
                            f"windows need [{lo}, {hi}) of {oh} — the band "
                            "splits a pool window")
    if bad_band:
        out.append(("coverage", bad_band))
    if g.bands:
        out += _spans(f"{what} emitted rows (image-major)", spans,
                      batch * poh)
    else:
        out += _spans(f"{what} conv pixels (image-major)", spans,
                      batch * oh * ow)
    return out


def check_conv(lau: Launch) -> list[tuple[str, str]]:
    batch, h, w, ci, p, q, co, stride, x_kind = lau.shape
    out: list[tuple[str, str]] = []
    pw, ps = lau.pool if lau.pool[0] else (1, 1)
    oh = (h - p) // stride + 1
    ow = (w - q) // stride + 1
    pow_ = (ow - pw) // ps + 1
    # column strips: whole pool windows, every emitted column once, each
    # reading exactly the input columns its windows need
    out += _spans("out columns (strips)", [s[:2] for s in lau.strips], pow_)
    for j0, j1, x0, x1 in lau.strips:
        need = (j0 * ps * stride, ((j1 - 1) * ps + pw - 1) * stride + q)
        if (x0, x1) != need or x1 > w:
            out.append(("coverage", f"strip [{j0}, {j1}): reads input "
                                    f"columns [{x0}, {x1}), needs "
                                    f"[{need[0]}, {need[1]}) of {w}"))
    if STATIC_SMEM["sa_conv_implicit"] != conv.SMEM_STATIC:
        out.append(("residency", f"static tables "
                                 f"{STATIC_SMEM['sa_conv_implicit']} B != "
                                 f"the geometry's SMEM_STATIC "
                                 f"{conv.SMEM_STATIC} B"))
    one = len(lau.strips) == 1
    for (j0, j1, x0, x1), g in zip(lau.strips, lau.geoms):
        ws = w if one else x1 - x0
        what = "out" if one else f"out strip [{j0}, {j1})"
        ows = (ws - q) // stride + 1
        if (g.conv_h, g.conv_w) != (oh, ows) or \
                (g.pool_window, g.pool_stride) != (pw, ps) or \
                g.out_w < j1 - j0:
            out.append(("coverage", f"{what}: the tile is built for a "
                                    f"{g.conv_h}x{g.conv_w} conv map with a "
                                    f"{g.pool_window}/{g.pool_stride} pool "
                                    f"emitting {g.out_w} columns; the op "
                                    f"has {oh}x{ows}, {pw}/{ps}, "
                                    f"{j1 - j0}"))
        if g.mb:
            if (g.mb, g.bco) not in conv.TC_TILES or g.pixels != 128 * g.mb \
                    or x_kind != X_KIND["bfloat16"]:
                out.append(("coverage", f"{what}: {g.pixels} pixel slots x "
                                        f"{g.bco} channels are not two "
                                        f"warpgroups' {g.mb} m64 blocks of "
                                        "a tensor-core tile of bf16 x"))
        elif g.pixels != conv.THREADS // g.groups * g.tpx or \
                g.bco != g.tco * g.groups or x_kind != X_KIND["float32"]:
            out.append(("coverage", f"{what}: {g.pixels} pixel slots x "
                                    f"{g.bco} channels are not the "
                                    f"{conv.THREADS} threads' {g.tpx} x "
                                    f"{g.tco} in {g.groups} groups of fp32 "
                                    "x"))
        out += _spans(f"{what} channels",
                      _tiles(co, g.bco, g.co_tiles(co)), co)
        if not g.mb and g.rin > conv.MAX_ROWS:
            out.append(("residency", f"{what}: rin {g.rin} > MAX_ROWS "
                                     f"{conv.MAX_ROWS}"))
        for bb in sorted({1, batch}):
            out += _conv_segments(g, bb, lau.pool, oh, ows, stride, p,
                                  f"{what} at batch {bb}")
        out += _residency("sa_conv_implicit[tc]" if g.mb
                          else "sa_conv_implicit", what,
                          _conv_smem(g, ws, ci, p, q, stride), g.smem_bytes)
    # order: one grouping of channels and taps for every strip, for the
    # unfused conv, and for the launch at every batch up to the op's
    orders = {_conv_order(g, ci, p, q, stride) for g in lau.geoms}
    plain = conv_launch(lau.op, batch, h, w, ci, p, q, co, stride, 0, 0,
                        x_kind)
    plain_orders = {_conv_order(g, ci, p, q, stride) for g in plain.geoms}
    if len(orders) != 1 or orders != plain_orders:
        out.append(("order", f"out: channel grouping {sorted(orders)} "
                             f"(fused) vs {sorted(plain_orders)} (unfused) "
                             "— fused and unfused pool would sum in "
                             "different orders"))
    for bb in range(1, batch + 1):
        other = conv_launch(lau.op, bb, h, w, ci, p, q, co, stride,
                            lau.pool[0], lau.pool[1], x_kind)
        if other.geoms != lau.geoms or other.strips != lau.strips:
            out.append(("order", f"out: the tile at batch {bb} differs from "
                                 f"batch {batch}: the tiling must come from "
                                 "the layer's shape alone"))
            break
    return out


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------
def check_pool(lau: Launch) -> list[tuple[str, str]]:
    n, h, w, c, itemsize, window, stride = lau.shape
    out: list[tuple[str, str]] = []
    oh = (h - window) // stride + 1
    ow = (w - window) // stride + 1
    if n > pool_act.MAX_IMAGES:
        out.append(("coverage", f"out: {n} images > the grid's "
                                f"{pool_act.MAX_IMAGES}"))
    for g in lau.geoms:
        what = f"out at {g.vec_bytes}-byte vectors"
        vb = g.vec_bytes
        legal = vb in (16, 8, 4) or vb == itemsize
        if not legal or (c * itemsize) % vb or vb < itemsize:
            out.append(("coverage", f"{what}: a {vb}-byte vector does not "
                                    f"divide a {c * itemsize}-byte pixel "
                                    f"of {itemsize}-byte elements"))
            continue
        vecs = c * itemsize // vb
        per_image = oh * ow * vecs
        if g.per_image != per_image or g.vecs != vecs:
            out.append(("coverage", f"{what}: {g.per_image} threads an "
                                    f"image, {per_image} outputs"))
        if g.blocks * pool_act.THREADS < per_image or \
                (g.blocks - 1) * pool_act.THREADS >= per_image:
            out.append(("coverage", f"{what}: {g.blocks} CTAs of "
                                    f"{pool_act.THREADS} threads for "
                                    f"{per_image} outputs an image"))
        vec, oy, ox = g.outputs()
        cells = (oy * ow + ox) * vecs + vec
        if len(cells) and (cells.min() < 0 or cells.max() >= per_image):
            out.append(("coverage", f"{what}: a thread writes past the "
                                    "image's outputs"))
            continue
        out += _thread_map(what, cells, per_image)
        out += _residency("pool_act", what, 0, 0)
    # order: the window's maxes run in (dp, dq) order in every launch; the
    # launch differs by batch only in its images
    for bb in range(1, n + 1):
        other = pool_launch(lau.op, bb, h, w, c, itemsize, window, stride)
        if [dataclasses.replace(g, n=n) for g in other.geoms] != \
                list(lau.geoms):
            out.append(("order", f"out: the launch at batch {bb} differs "
                                 f"from batch {n} beyond its images"))
            break
    return out


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
def _flash_smem(bq: int, d: int, itemsize: int) -> int:
    """A CTA's dynamic shared memory from its tile.  fp32 (the FMA loop):
    the Q tile and two stages of K and V, rows padded by 4 floats, and 8
    warps' P slices of 2 x bq / 16 rows of 32 + 4 floats.  bf16 (the
    tensor cores): 1024 bytes to align to the 128-byte swizzle's period,
    two Q tiles of bq rows and TC_STAGES stages of a K and a V tile of BKV
    rows, every row d rounded up to whole 128-byte atoms of 64 bf16, then
    8-byte mbarriers, a full and an empty one a stage and one a Q tile."""
    if itemsize == 2:
        row = -(-d // 64) * 128
        stages = attention.TC_STAGES
        return (1024 + 2 * bq * row + stages * 2 * attention.BKV * row
                + (2 * stages + 2) * 8)
    return (4 * bq * (d + 4) + 4 * 2 * 2 * attention.BKV * (d + 4)
            + 4 * 8 * (2 * bq // 16) * (32 + 4))


def _visible(rows: np.ndarray, sq: int, skv: int, causal: bool,
             window: int) -> tuple[np.ndarray, np.ndarray]:
    """(first, last) key each query row sees (last < first: none), as the
    plain version masks: causal ``kpos <= qpos``, window ``kpos > qpos -
    window``, queries aligned to the end of the keys."""
    qpos = rows + skv - sq
    last = np.minimum(skv - 1, qpos) if causal else \
        np.full_like(rows, skv - 1)
    first = np.maximum(0, qpos - window + 1) if window > 0 else \
        np.zeros_like(rows)
    return first, last


def _kv_sequences(bq: int, sq: int, skv: int, causal: bool, window: int
                  ) -> tuple[list[tuple[int, ...]], str | None]:
    """The kv tiles each query row sums (those of its tile's loop in which
    it sees a key, in loop order) at query tiles of ``bq`` rows, and the
    first row whose loop misses a tile holding a key it sees."""
    rows = np.arange(sq)
    first, last = _visible(rows, sq, skv, causal, window)
    bkv = attention.BKV
    seqs: list[tuple[int, ...]] = []
    missed = None
    for iq in range(-(-sq // bq)):
        loop = list(attention.live_tiles(iq, sq, skv, causal=causal,
                                         window=window, bq=bq))
        for r in range(iq * bq, min((iq + 1) * bq, sq)):
            need = range(first[r] // bkv, last[r] // bkv + 1) \
                if first[r] <= last[r] else range(0)
            if missed is None and not set(need) <= set(loop):
                missed = (f"query row {r} (tile {iq} of {bq}) sees keys "
                          f"[{first[r]}, {last[r]}] in kv tiles "
                          f"{list(need)}, the tile's loop runs "
                          f"{loop[:1]}..{loop[-1:]}")
            seqs.append(tuple(t for t in loop if t in need))
    return seqs, missed


def check_flash(lau: Launch) -> list[tuple[str, str]]:
    b, sq, skv, hq, hkv, d, causal, window, itemsize = lau.shape
    (g,) = lau.geoms
    out: list[tuple[str, str]] = []
    if d not in attention.HEAD_DIMS or hq % hkv or g.bq not in attention.BQ:
        out.append(("coverage", f"out: no instantiation for head dim {d}, "
                                f"{hq}/{hkv} heads, {g.bq}-row tiles"))
        return out
    if g.heads != b * hq:
        out.append(("coverage", f"out: {g.heads} (batch, head) pairs, the "
                                f"launch has {b * hq}"))
    if g.q_tiles != -(-sq // g.bq):
        out.append(("coverage", f"out rows: {g.q_tiles} query tiles of "
                                f"{g.bq} for {sq} rows"))
    # every (batch x head, query tile) once, with the launch's pairing and
    # with the other (pairing changes which CTA computes a tile, not how)
    for paired in (g.paired, not g.paired):
        pg = dataclasses.replace(g, paired=paired)
        what = f"out ({'paired' if paired else 'unpaired'} CTAs)"
        seen = np.zeros((pg.heads, pg.q_tiles), dtype=np.int64)
        for c in range(pg.ctas):
            bh, tiles = pg.cta_tiles(c)
            for t in tiles:
                if 0 <= bh < pg.heads and 0 <= t < pg.q_tiles:
                    seen[bh, t] += 1
        if (seen == 0).any():
            bh, t = np.argwhere(seen == 0)[0]
            out.append(("coverage", f"{what}: query tile {t} of (batch, "
                                    f"head) {bh} written by no CTA "
                                    f"({(seen == 0).sum()} such tiles)"))
        if (seen > 1).any():
            bh, t = np.argwhere(seen > 1)[0]
            out.append(("race", f"{what}: query tile {t} of (batch, head) "
                                f"{bh} written by more than one CTA"))
    if g.tensor_cores != (itemsize == 2):
        where = "the tensor cores" if g.tensor_cores else "the FMA loop"
        out.append(("order", f"out: {'bf16' if itemsize == 2 else 'fp32'} "
                             f"on {where} — bf16 runs on the tensor cores, "
                             "fp32 (no TF32) on the FMA loop"))
    # each thread's (row, column) of a query tile: the FMA kernel's warp
    # and half-warp rows, or wgmma's accumulator fragment (a consumer
    # warpgroup a 64 rows), as the kernel that runs stores them
    cells = []
    for t in range(g.threads):
        rows, cols = g.thread_outputs(t, d)
        cells += [r * d + c for r in rows for c in cols]
    cells = np.asarray(cells)
    if len(cells) and (cells.min() < 0 or cells.max() >= g.bq * d):
        out.append(("coverage", f"out: a thread stores past its {g.bq} x "
                                f"{d} query tile"))
        cells = cells[(cells >= 0) & (cells < g.bq * d)]
    out += _thread_map("out", cells, g.bq * d)
    out += _residency("attention", f"{g.bq}-row tiles, d {d}",
                      _flash_smem(g.bq, d, itemsize), g.smem_bytes)
    # coverage of keys and order: each row sums the same kv tiles in the
    # same order at every tile height the launch may pick
    seqs = {}
    for bq in attention.BQ:
        seqs[bq], missed = _kv_sequences(bq, sq, skv, causal, window)
        if missed:
            out.append(("coverage", f"keys: {missed} — live_tiles drops a "
                                    "visible kv tile"))
    for r in range(sq):
        if len({seqs[bq][r] for bq in attention.BQ}) > 1:
            out.append(("order", f"out row {r}: kv tiles "
                                 + ", ".join(f"{list(seqs[bq][r])} at "
                                             f"bq={bq}"
                                             for bq in attention.BQ)))
            break
    for bb in range(1, b + 1):
        other = attention.flash_geometry(bb, sq, skv, hq, hkv, d, causal,
                                         window, itemsize)
        if other.bq not in attention.BQ:
            out.append(("order", f"out: {other.bq}-row tiles at b={bb}"))
            break
    return out


CHECKS = {"sa_fc": check_fc, "sa_fc_tc": check_fc_tc,
          "sa_conv": check_gemm,
          "sa_conv_implicit": check_conv, "pool_act": check_pool,
          "attention": check_flash}


def check_launch(lau: Launch) -> list[Finding]:
    """Every launch invariant of one launch, as findings of the ``launch``
    pass whose message names the kernel, the sub-check and the operand."""
    return [Finding("launch", lau.op, f"{lau.kernel} {sub}: {msg}")
            for sub, msg in CHECKS[lau.kernel](lau)]


def verify_launches(launches, *, label: str = "launch") -> AnalysisReport:
    report = AnalysisReport(label=label)
    for lau in launches:
        report.add(check_launch(lau))
        report.checked_ops += 1
    return report


def smem_queries(lau: Launch) -> list[tuple[str, tuple, int]]:
    """(library, arguments of its exported shared-memory query, the bytes
    this pass derives) for each kernel launch of ``lau``: what phase 11 of
    chip_smoke.py asks the built kernels."""
    if lau.kernel == "sa_fc":
        _, _, _, w_kind, x_kind = lau.shape
        (fl,) = lau.geoms
        return [("sa_fc", (w_kind, x_kind, fl.rows),
                 _fc_smem(fl.rows, fl.cols, KIND_BYTES[w_kind]))]
    if lau.kernel == "sa_fc_tc":
        b, k, n, w_kind, _ = lau.shape
        (d,) = lau.geoms
        return [("sa_fc_tc", (w_kind, b, k, n, d.rows, d.segments, d.span),
                 _fc_tc_smem(d.narrow, d.rows, KIND_BYTES[w_kind],
                             d.segments, d.span))]
    if lau.kernel == "sa_conv":
        _, _, _, w_kind, x_kind = lau.shape
        return [("sa_conv", (w_kind, x_kind),
                 _gemm_smem(KIND_BYTES[w_kind], x_kind))]
    if lau.kernel == "sa_conv_implicit":
        _, _, w, ci, p, q, _, stride, x_kind = lau.shape
        out = []
        for (_, _, x0, x1), g in zip(lau.strips, lau.geoms):
            ws = w if len(lau.strips) == 1 else x1 - x0
            tile = conv.TC_TILES.index((g.mb, g.bco)) if g.mb else \
                conv.TILES.index((g.tpx, g.tco, g.groups))
            out.append(("sa_conv_implicit",
                        (tile, x_kind, ws, ci, p, q, stride, g.rin, g.ng),
                        _conv_smem(g, ws, ci, p, q, stride)))
        return out
    if lau.kernel == "pool_act":
        itemsize = lau.shape[4]
        return [("pool_act", (POOL_DTYPE[itemsize], g.vec_bytes), 0)
                for g in lau.geoms]
    b, sq, skv, hq, hkv, d, causal, window, itemsize = lau.shape
    (g,) = lau.geoms
    return [("attention", (d, g.bq, X_KIND["float32" if itemsize == 4
                                           else "bfloat16"]),
             _flash_smem(g.bq, d, itemsize))]
