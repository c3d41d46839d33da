"""Multi-pod dry run: trace every (architecture x input shape x mesh) cell
of the port on ``meta`` tensors against the production mesh and record
what one chip would hold and do: argument bytes, the peak of live bytes,
operations, HBM traffic, wire bytes and the three-term roofline
(:mod:`repro_torch.core.roofline`) on the card (``H100_SXM`` by default).

The JAX package lowers and compiles each cell with XLA over 512 host
devices and reads the partitioned program.  The port has no partitioner:
it builds the parameters, the AdamW state, the cache and the batch on
``meta`` (nothing is allocated, no card is touched) and runs its own
``make_train_step``, ``prefill_step`` or ``decode_step`` under a
:class:`~repro_torch.core.roofline.MetaCount`.  One chip's figures:

* **arguments** — exact: every leaf's shard shape under the ported specs
  (:mod:`repro_torch.distributed.sharding`) times its element size.  The
  port's tied models also hold ``embed_t`` (laid out as an untied head);
  ``embed_t_bytes`` says how much of the figure it is.
* **compute and activations** — the step runs at one chip's share of the
  batch (``global_batch / dp``, as the batch spec splits it; a cache
  sharded over the sequence at its share of the sequence), under the
  per-chip view of the mesh (:func:`chip_view`: the data axes of size 1,
  the model axis whole): the chip holds one of the data-parallel groups,
  so an MoE block routes one group, as each chip of the reference does.
* **tensor parallelism** — the trace keeps every weight whole; the model
  axis then divides each kernel call's operations and bytes when the
  specs shard that op's weight over it (attention when its heads shard),
  and every other op's as Megatron splits heads and experts.  Compute the
  reference replicates over the model axis (heads that do not divide)
  is not counted again.  Live bytes (:func:`_byte_scale`): parameter-
  shaped tensors (gradients, optimizer temporaries) at their parameter's
  shard; ``d_model``-wide activations (the residual, the norms, the
  row-parallel outputs) whole, as Megatron keeps them, the rest over the
  model axis; what a ``constrain`` site names, as its spec lays it out
  (``SP_CARRY``'s residual over the model axis).  Held against the
  reference's compiled temporaries on a (2, 4) mesh within a factor of
  1.4 (``tests/test_torch_dryrun.py``, fp32).
* **traffic** — ``hbm_bytes_per_chip`` counts every op's operands and
  result, nothing fused: an upper bound on traffic, which the reference's
  HLO-op bytes are too, so ``bound_s`` and ``roofline_fraction`` are
  loose where memory dominates.  ``compulsory_bytes_per_chip`` is the
  floor: every argument read once and every result written once, and in
  training each gradient and each block's input written and read once;
  ``compulsory_bound_s`` and ``compulsory_roofline_fraction`` use it.
* **wire bytes** — analytic from the specs with the reference's ring
  factors: an all-gather of each data-sharded weight per forward pass and
  another per recompute, a reduce-scatter of its gradient, an all-reduce
  of the gradients of leaves replicated over a data axis, and the
  Megatron all-reduce of each row-parallel output in the forward pass and
  again in the backward pass; split by mesh axis, each crossing its own
  link (``H100_SXM.link_bandwidth``).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \\
        --shape decode_32k --multi-pod

Results land in ``build/dryrun/`` (one JSON a cell, reused while
``CODE_VERSION`` and the chip match; ``--force`` traces again).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs.base import (SHAPES_BY_NAME, ModelConfig,
                                      ShapeConfig, TrainConfig)
from repro_torch.configs.registry import all_lm_configs
from repro_torch.core import roofline, tree
from repro_torch.core.accelerator import H100_SXM
from repro_torch.core.engine import Engine
from repro_torch.core.schedule import LayerSchedule
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import AbstractMesh
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.models.attention import _pad_heads
from repro_torch.serve import kvcache as KC
from repro_torch.serve import serve_step as SS
from repro_torch.train import train_step as TS

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
CODE_VERSION = 1          # bump to invalidate cached dry-run JSONs

META = torch.device("meta")

#: an engine matmul's name (its last part) -> the weight leaf it reads
_OP_LEAVES = {"q": "wq", "k": "wk", "v": "wv", "o": "wo", "gate": "wg",
              "up": "wu", "down": "wd", "fc1": "w1", "fc2": "w2",
              "router": "router", "in_proj": "in_proj",
              "out_proj": "out_proj", "lm_head": "head"}
#: row-parallel weights: their output is a partial sum over the model axis
_ROW_PARALLEL = ("wo", "wd", "w2", "out_proj")


# ---------------------------------------------------------------------------
# per-cell configuration
# ---------------------------------------------------------------------------
def audio_frames_for(shape: ShapeConfig) -> int:
    return max(128, shape.seq_len // 4)


def skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> str | None:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("pure full-attention arch: 500k decode KV is unbounded "
                "(assignment: skip, noted in DESIGN.md §6)")
    if shape.name == "long_500k" and cfg.enc_dec:
        return "enc-dec: 500k autoregressive decode outside operating regime"
    return None


def train_config_for(cfg: ModelConfig, shape: ShapeConfig,
                     mesh) -> TrainConfig:
    n = cfg.n_params()
    dp = SH.dp_size(mesh)
    if n > 100e9:
        mb, remat, mdt = 4 * dp, "block", "bfloat16"   # 4 seq/shard/microbatch
    elif n > 20e9:
        mb, remat, mdt = 2 * dp, "block", "bfloat16"
    else:
        mb, remat, mdt = 0, "block", "float32"
    if mb >= shape.global_batch:
        mb = 0
    return TrainConfig(global_batch=shape.global_batch,
                       seq_len=shape.seq_len, microbatch=mb, remat=remat,
                       moment_dtype=mdt)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Meta-tensor stand-ins for the mode's data inputs."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": torch.empty((B, 1), dtype=torch.int32,
                                      device=META)}
    s_text = S - (cfg.vision_tokens or 0)
    specs = {"tokens": torch.empty((B, s_text), dtype=torch.int32,
                                   device=META)}
    if cfg.vision_tokens:
        specs["vision_embeds"] = torch.empty(
            (B, cfg.vision_tokens, cfg.frontend_dim), dtype=torch.bfloat16,
            device=META)
    if cfg.enc_dec:
        specs["audio_embeds"] = torch.empty(
            (B, audio_frames_for(shape), cfg.frontend_dim),
            dtype=torch.bfloat16, device=META)
    return specs


def chip_view(mesh) -> AbstractMesh:
    """One chip's view of ``mesh``: its data axes of size 1 (the chip
    holds one data-parallel group), the model axis whole."""
    return AbstractMesh((1, SH.tp_size(mesh)), ("data", "model"))


def _local(t: torch.Tensor, sh: SH.NamedSharding) -> torch.Tensor:
    """A meta tensor of ``t``'s dtype at its share over the data axes
    (the model axis kept whole: the trace divides by it afterwards)."""
    shape = []
    for dim, n in enumerate(t.shape):
        parts = math.prod(sh.mesh.shape[a] for a in sh.axes(dim)
                          if a != "model")
        shape.append(-(-n // parts))
    return torch.empty(shape, dtype=t.dtype, device=META)


def _local_tree(t, shardings):
    return tree.unflatten(t, [_local(x, sh) for x, sh in
                              zip(tree.leaves(t), tree.leaves(shardings))])


# ---------------------------------------------------------------------------
# one chip's share of the count
# ---------------------------------------------------------------------------
class _Split:
    """How the model axis divides a cell's count, and the wire bytes of
    the specs (built from the parameter shardings)."""

    def __init__(self, cfg, mesh, params, psh):
        self.mesh = mesh
        self.tp = SH.tp_size(mesh)
        self.tp_leaves: dict[str, bool] = {}
        for (path, _), sh in zip(tree.flatten_with_paths(params),
                                 tree.leaves(psh)):
            names = path.split(".")
            leaf = names[-2] if names[-1] in ("q", "scale") else names[-1]
            leaf = "head" if leaf in ("embed_t", "embed") else leaf
            self.tp_leaves[leaf] = self.tp_leaves.get(leaf, False) or \
                sh.uses("model")
        hq = cfg.n_heads
        self.heads_split = bool(hq) and (hq % self.tp == 0 or
                                         _padded_heads(cfg, self.tp) != hq)

    def leaf_of(self, op_name: str) -> str:
        return _OP_LEAVES.get(op_name.rsplit(".", 1)[-1], "")

    def divisor(self, key: str) -> int:
        """The model-axis split of one count row."""
        if self.tp == 1:
            return 1
        if key.endswith("[flash_attention]"):
            return self.tp if self.heads_split else 1
        if key.endswith("_matmul]"):
            name = key.split(" ", 1)[0]
            return self.tp if self.tp_leaves.get(self.leaf_of(name)) else 1
        return self.tp

    def wire(self, params, psh, calls, passes: int, recompute: tuple,
             train: bool, itemsize: int) -> tuple[dict, dict]:
        """(wire bytes per chip by axis, collectives by kind) of one step:
        ``passes`` forward passes (microbatches), ``recompute`` the stacked
        groups (``"blocks"``, ``"encoder"``) whose weights the remat
        recompute gathers again, ``train`` the gradients
        reduced; ``calls`` the kernel-call log (the row-parallel outputs'
        all-reduces), activations of ``itemsize`` bytes."""
        mesh = self.mesh
        by_axis: dict[str, float] = {}
        colls: dict[str, dict] = {}

        def add(kind, axis, result_bytes, count=1):
            g = mesh.shape[axis]
            if g <= 1 or result_bytes <= 0:
                return
            w = roofline.WIRE_FACTOR[kind](g) * result_bytes * count
            by_axis[axis] = by_axis.get(axis, 0.0) + w
            c = colls.setdefault(kind, {"count": 0, "result_bytes": 0.0,
                                        "wire_bytes": 0.0})
            c["count"] += count
            c["result_bytes"] += result_bytes * count
            c["wire_bytes"] += w

        dp = SH.dp_axes(mesh)
        for (path, leaf), sh in zip(tree.flatten_with_paths(params),
                                    tree.leaves(psh)):
            if path.split(".")[0] == "embed_t" and train:
                continue                  # derived again, never reduced
            shard = math.prod(sh.shard_shape(leaf.shape)) * \
                leaf.dtype.itemsize
            if sh.uses("data"):
                gathers = passes * (1 + (path.split(".")[0] in recompute))
                add("all-gather", "data", shard * mesh.shape["data"],
                    gathers)
                if train:
                    add("reduce-scatter", "data", shard)
            for a in dp:
                if train and not sh.uses(a):
                    add("all-reduce", a, shard)
        if self.tp > 1:
            for c in calls:
                leaf = self.leaf_of(c.name)
                if c.kernel.endswith("_matmul") and leaf in _ROW_PARALLEL \
                        and self.tp_leaves.get(leaf) and \
                        c.role in ("forward", "dx"):
                    m, _, n = c.shape
                    add("all-reduce", "model", m * n * itemsize)
        return by_axis, colls


def _padded_heads(cfg, tp: int) -> int:
    """The query heads attention pads to under a model axis of ``tp``
    (:func:`repro_torch.models.attention._pad_heads`)."""
    with SH.activation_mesh(AbstractMesh((1, tp), ("data", "model"))):
        q, _ = _pad_heads(cfg, torch.empty((1, 1, cfg.n_heads, 1),
                                           device=META))
    return q.shape[2]


def _byte_scale(cfg, params, psh, tp: int):
    """Live-byte scale of a tensor made in the trace, as Megatron lays
    activations over the model axis: a parameter-shaped one at that
    parameter's shard fraction; a tensor ``d_model`` wide (the residual,
    the norms, the row-parallel outputs, an MoE block's dispatched tokens)
    whole on every chip; anything else (heads, the MLP's hidden width, the
    vocabulary) over the axis.  The model's :func:`constrain` sites then
    lay out what they name (:func:`_count_in`)."""
    frac: dict[tuple, float] = {}
    for leaf, sh in zip(tree.leaves(params), tree.leaves(psh)):
        shape = tuple(leaf.shape)
        if len(shape) >= 2:
            frac[shape] = math.prod(sh.shard_shape(shape)) / \
                math.prod(shape)

    def scale(t: torch.Tensor) -> float:
        shape = tuple(t.shape)
        if shape in frac:
            return frac[shape]
        if tp == 1 or (shape and shape[-1] == cfg.d_model):
            return 1.0
        return 1.0 / tp
    return scale


@contextlib.contextmanager
def _count_in(cfg, mesh, params, psh, split):
    """One chip's count (a :class:`~repro_torch.core.roofline.MetaCount`)
    under its view of ``mesh``, each tensor a ``constrain`` site names
    laid out by its spec: over the model axis where the spec says
    ``"tp"`` (the reference's ``SP_CARRY`` residual, heads), whole where
    it does not (keys and values whose heads do not divide the axis)."""
    count = roofline.MetaCount(byte_scale=_byte_scale(cfg, params, psh,
                                                      split.tp))

    def lay_out(x, spec):
        count.relayout(x, 1.0 / split.tp if "tp" in spec else 1.0)

    with SH.activation_mesh(chip_view(mesh), on_constrain=lay_out), count:
        yield count


# ---------------------------------------------------------------------------
# tracing per mode
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Trace:
    """One cell's traced step: the count, what the chip holds, and the
    analytic wire bytes."""
    count: roofline.MetaCount
    model_flops: float
    argument_bytes: int
    state_bytes: int            # the arguments but the batch (and pos)
    batch_bytes: int
    output_bytes: int           # the step's results, at their shards
    compulsory_bytes: int       # the traffic the step cannot avoid
    embed_t_bytes: int
    alias_bytes: int
    split: _Split
    wire_by_axis: dict
    collectives: dict
    dtype: str
    extra: dict

    def terms(self, chips: int) -> roofline.RooflineTerms:
        return roofline.terms_from_trace(
            self.count, chips, self.model_flops, divisor=self.split.divisor,
            wire_bytes_by_axis=self.wire_by_axis, mesh=self.split.mesh,
            dtype=self.dtype, compulsory_hbm_bytes=self.compulsory_bytes)

    def matmul_flops_per_chip(self) -> float:
        """The operations of the engine's matmul kernel calls (SA-FC and
        the SA-CONV GEMM), split over the model axis."""
        return sum(c.flops / self.split.divisor(c.key)
                   for c in self.count.calls
                   if c.kernel in ("sa_fc_matmul", "sa_conv_matmul"))

    def temp_bytes(self) -> int:
        return int(self.count.peak_live_bytes)


def _carry_bytes(cfg, local: dict, tp: int) -> int:
    """One chip's block inputs of a train step on its ``local`` batch:
    each decoder block's (B, vision + text tokens, d) and each encoder
    block's (B, frames, d) in the compute dtype, which the backward pass
    reads again; over the model axis under ``SP_CARRY``."""
    reps, rem = cfg.stack_shape()
    b, s = local["tokens"].shape
    s += local["vision_embeds"].shape[1] if "vision_embeds" in local else 0
    tokens = (reps + rem) * b * s
    if "audio_embeds" in local:
        tokens += cfg.n_enc_layers * b * local["audio_embeds"].shape[1]
    carry = tokens * cfg.d_model * T.torch_dtype(cfg.compute_dtype).itemsize
    return carry // tp if T.SP_CARRY["on"] else carry


def _nbytes(t: torch.Tensor) -> int:
    """One chip's bytes of a result traced at its local shape (the batch
    split, the model axis whole: logits are laid out by the batch only)."""
    return t.numel() * t.element_size()


def _embed_t_bytes(params, psh) -> int:
    if "embed_t" not in params:
        return 0
    sh = psh["embed_t"]
    return math.prod(sh.shard_shape(params["embed_t"].shape)) * \
        params["embed_t"].dtype.itemsize


def regathered(remat: str) -> tuple[str, ...]:
    """The stacked groups whose weights the backward's recompute gathers
    again under ``remat``: those whose matmuls it reruns.  ``"block"``
    reruns the decoder's periods and the encoder's blocks; ``"dots"``
    keeps the periods' products and reruns the encoder's blocks (the
    encoder takes ``"dots"`` for ``"block"``)."""
    return {"none": (), "block": ("blocks", "encoder"),
            "dots": ("encoder",)}[remat]


def trace_train(cfg, shape: ShapeConfig, mesh, *,
                tc: TrainConfig | None = None, batch: dict | None = None,
                donate: bool = True) -> Trace:
    """One chip's train step: ``make_train_step`` (kernels backend) at the
    chip's share of the batch, its state donated to the optimizer unless
    ``donate`` is False.  ``tc`` defaults to :func:`train_config_for`,
    ``batch`` (the global batch, as tensors of any device: only shapes and
    dtypes are read) to :func:`input_specs`."""
    tc = tc or train_config_for(cfg, shape, mesh)
    params, opt, cstate = TS.init_train_state(cfg, tc, 0, device=META)
    batch = input_specs(cfg, shape) if batch is None else {
        k: torch.empty(tuple(v.shape), dtype=v.dtype, device=META)
        for k, v in batch.items()}
    psh = SH.param_shardings(cfg, params, mesh)
    osh = SH.opt_shardings(cfg, opt, mesh)
    csh = SH.replicated(mesh, cstate)
    bsh = SH.batch_shardings(mesh, batch)
    state = SH.shard_bytes(psh, params) + SH.shard_bytes(osh, opt) + \
        SH.shard_bytes(csh, cstate)
    bbytes = SH.shard_bytes(bsh, batch)

    local = _local_tree(batch, bsh)
    b_loc, b = local["tokens"].shape[0], batch["tokens"].shape[0]
    micro = tc.microbatch * b_loc // b if tc.microbatch else 0
    tc_loc = dataclasses.replace(tc, global_batch=b_loc, microbatch=micro)
    eng = Engine(backend="kernels")
    step = TS.make_train_step(cfg, tc_loc, engine=eng, donate=donate)
    passes = b_loc // micro if micro and micro < b_loc else 1
    split = _Split(cfg, mesh, params, psh)
    if not cfg.enc_dec:                 # compile the schedule outside
        with SH.activation_mesh(chip_view(mesh)):
            LayerSchedule.compile(cfg, "train", batch=b_loc // passes,
                                  seq=local["tokens"].shape[1],
                                  policy=eng.policy,
                                  params=T.trainable(params))
    with _count_in(cfg, mesh, params, psh, split) as count:
        metrics = step(params, opt, cstate, local)[3]
    tokens = shape.global_batch * shape.seq_len
    mflops = roofline.model_flops_train(cfg.n_active_params(), tokens)
    wire, colls = split.wire(params, psh, count.calls, passes,
                             regathered(tc.remat), True,
                             torch.empty((), dtype=getattr(
                                 torch, cfg.compute_dtype)).element_size())
    outputs = state + SH.shard_bytes(SH.replicated(mesh, metrics), metrics)
    embed_t = _embed_t_bytes(params, psh)
    # read every argument and write every result once; write and read
    # each gradient (a parameter's shard) once, and each block's input
    # once (:func:`_carry_bytes`)
    compulsory = state + bbytes + outputs + \
        2 * (SH.shard_bytes(psh, params) - embed_t) + \
        2 * _carry_bytes(cfg, local, split.tp)
    return Trace(count, mflops, state + bbytes, state, bbytes, outputs,
                 compulsory, embed_t, state if donate else 0,
                 split, wire, colls, cfg.compute_dtype,
                 {"train": dataclasses.asdict(tc)})


def _serve_params(cfg, quant: bool):
    params = T.init_params(cfg, 0, device=META)
    if quant:
        from repro_torch.core.quant import quantize_params
        params = quantize_params(params)
    return params


def trace_prefill(cfg, shape: ShapeConfig, mesh) -> Trace:
    """One chip's ``prefill_step`` (kernels backend) at its share of the
    batch, serving weights (:func:`param_shardings` with ``serve``)."""
    params = _serve_params(cfg, False)
    batch = input_specs(cfg, shape)
    psh = SH.param_shardings(cfg, params, mesh, serve=True)
    bsh = SH.batch_shardings(mesh, batch)
    pbytes, bbytes = SH.shard_bytes(psh, params), SH.shard_bytes(bsh, batch)
    local = _local_tree(batch, bsh)
    split = _Split(cfg, mesh, params, psh)
    eng = Engine(backend="kernels")
    with eng.activate(), _count_in(cfg, mesh, params, psh, split) as count:
        logits, _ = SS.prefill_step(cfg, params, local, shape.seq_len)
    tokens = shape.global_batch * shape.seq_len
    mflops = roofline.model_flops_decode(cfg.n_active_params(), tokens)
    wire, colls = split.wire(params, psh, count.calls, 1, (), False, 2)
    cache = KC.init_cache(cfg, shape.global_batch, shape.seq_len,
                          enc_len=audio_frames_for(shape) if cfg.enc_dec
                          else 0, dtype=torch.bfloat16, device=META)
    outputs = _nbytes(logits) + SH.shard_bytes(
        SH.cache_shardings(cfg, mesh, cache), cache)
    return Trace(count, mflops, pbytes + bbytes, pbytes, bbytes, outputs,
                 pbytes + bbytes + outputs, _embed_t_bytes(params, psh), 0,
                 split, wire, colls,
                 cfg.compute_dtype, {})


def trace_decode(cfg, shape: ShapeConfig, mesh, quant: bool = False) -> Trace:
    """One chip's ``decode_step`` (kernels backend) against a bf16 cache
    at its share (batch, or sequence, over the data axes), serving
    weights; ``quant``: int8 weights."""
    params = _serve_params(cfg, quant)
    enc_len = audio_frames_for(shape) if cfg.enc_dec else 0
    cache = KC.init_cache(cfg, shape.global_batch, shape.seq_len,
                          enc_len=enc_len, dtype=torch.bfloat16, device=META)
    batch = input_specs(cfg, shape)
    psh = SH.param_shardings(cfg, params, mesh, serve=True)
    cash = SH.cache_shardings(cfg, mesh, cache)
    bsh = SH.batch_shardings(mesh, batch)
    pbytes, cbytes = SH.shard_bytes(psh, params), SH.shard_bytes(cash, cache)
    bbytes = SH.shard_bytes(bsh, batch) + 4          # + the int32 position
    local_cache = _local_tree(cache, cash)
    tokens = _local_tree(batch, bsh)["tokens"]
    split = _Split(cfg, mesh, params, psh)
    eng = Engine(backend="kernels")
    with eng.activate(), _count_in(cfg, mesh, params, psh, split) as count:
        logits, _ = SS.decode_step(cfg, params, local_cache, tokens,
                                   shape.seq_len - 1)
    mflops = roofline.model_flops_decode(cfg.n_active_params(),
                                         shape.global_batch)
    wire, colls = split.wire(params, psh, count.calls, 1, (), False, 2)
    # every argument read once, the logits written (the cache's update is
    # one position: left out, so the figure stays a floor)
    args = pbytes + cbytes + bbytes
    return Trace(count, mflops, args, pbytes + cbytes, bbytes,
                 _nbytes(logits) + cbytes, args + _nbytes(logits),
                 _embed_t_bytes(params, psh), cbytes, split, wire,
                 colls, cfg.compute_dtype,
                 {"cache_bytes": KC.cache_bytes(cache)})


TRACE = {"train": trace_train, "prefill": trace_prefill,
         "decode": trace_decode}


# ---------------------------------------------------------------------------
# cell runner
# ---------------------------------------------------------------------------
def record(tr: Trace, chips: int, chip=H100_SXM) -> dict:
    """The reference's JSON fields of a traced cell, with ``trace_s`` left
    to the caller, plus ``chip``, ``fits`` and the port's own."""
    terms = tr.terms(chips)
    dom, tdict = terms.dominant(chip)
    temp = tr.temp_bytes()
    outputs = tr.output_bytes
    # the reference's peak: arguments + outputs + temporaries - aliased
    peak = tr.argument_bytes + outputs + temp - tr.alias_bytes
    out = dict(
        chip=chip.name,
        argument_bytes=tr.argument_bytes,
        output_bytes=outputs,
        temp_bytes=temp,
        alias_bytes=tr.alias_bytes,
        peak_bytes_per_chip=peak,
        fits=peak <= chip.hbm_bytes,
        state_bytes=tr.state_bytes,
        batch_bytes=tr.batch_bytes,
        embed_t_bytes=tr.embed_t_bytes,
        flops_per_chip=terms.flops_per_chip,
        matmul_flops_per_chip=tr.matmul_flops_per_chip(),
        hbm_bytes_per_chip=terms.hbm_bytes_per_chip,
        wire_bytes_per_chip=terms.wire_bytes_per_chip,
        wire_bytes_by_axis=tr.wire_by_axis,
        collectives=tr.collectives,
        kernel_calls=len(tr.count.calls),
        model_flops=tr.model_flops,
        terms_s=tdict, dominant=dom,
        bound_s=terms.bound_s(chip),
        useful_flops_fraction=terms.useful_flops_fraction(),
        roofline_fraction=terms.roofline_fraction(chip),
        compulsory_bytes_per_chip=tr.compulsory_bytes,
        compulsory_bound_s=terms.compulsory_bound_s(chip),
        compulsory_roofline_fraction=terms.compulsory_roofline_fraction(
            chip),
        top_bytes=[list(r) for r in roofline.top_cost_lines(tr.count, 8)],
        **tr.extra)
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             force: bool = False, quant: bool = False, chip=H100_SXM,
             results_dir: Path | None = None) -> dict:
    results_dir = Path(results_dir or RESULTS_DIR)
    os.makedirs(results_dir, exist_ok=True)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    suffix = "__w8" if quant else ""
    path = results_dir / f"{arch}__{shape_name}__{mesh_name}{suffix}.json"
    if path.exists() and not force:
        with open(path) as f:
            cached = json.load(f)
        if cached.get("code_version") == CODE_VERSION and \
                cached.get("chip", chip.name) == chip.name:
            return cached

    cfg = all_lm_configs()[arch]
    shape = SHAPES_BY_NAME[shape_name]
    rec = {"arch": arch, "shape": shape_name,
           "mesh": mesh_name + ("(w8)" if quant else ""),
           "kind": shape.kind, "code_version": CODE_VERSION,
           "n_params": cfg.n_params(),
           "n_active_params": cfg.n_active_params()}

    reason = skip_reason(cfg, shape)
    if reason:
        rec.update(status="skipped", reason=reason, chip=chip.name)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        return rec

    mesh = make_production_mesh(multi_pod=multi_pod)
    prev = T.SP_CARRY["on"]
    try:
        # SP residual carry: the reference's capacity lever for >100B trains
        T.SP_CARRY["on"] = cfg.n_params() > 100e9 and shape.kind == "train"
        t0 = time.time()
        with torch.no_grad() if shape.kind != "train" else \
                torch.enable_grad():
            if quant:
                if shape.kind != "decode":
                    raise ValueError("the w8 variant is decode-only")
                tr = trace_decode(cfg, shape, mesh, quant=True)
            else:
                tr = TRACE[shape.kind](cfg, shape, mesh)
        rec.update(status="ok", trace_s=round(time.time() - t0, 2),
                   **record(tr, mesh.size, chip))
    except Exception as e:                       # noqa: BLE001
        rec.update(status="error", chip=chip.name,
                   error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    finally:
        T.SP_CARRY["on"] = prev
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def summarize(rec: dict) -> str:
    if rec["status"] == "skipped":
        return (f"{rec['arch']:26s} {rec['shape']:12s} {rec['mesh']:10s} "
                f"SKIP ({rec['reason'][:60]})")
    if rec["status"] == "error":
        return (f"{rec['arch']:26s} {rec['shape']:12s} {rec['mesh']:10s} "
                f"ERROR {rec['error'][:80]}")
    t = rec["terms_s"]
    return (f"{rec['arch']:26s} {rec['shape']:12s} {rec['mesh']:10s} "
            f"trace {rec['trace_s']:6.1f}s "
            f"mem/chip {rec['peak_bytes_per_chip']/2**30:7.2f}GiB "
            f"{'fits' if rec['fits'] else 'OVER'} "
            f"C {t['compute']*1e3:9.2f}ms M {t['memory']*1e3:9.2f}ms "
            f"N {t['collective']*1e3:9.2f}ms -> {rec['dominant']:10s} "
            f"roofline {rec['roofline_fraction']*100:5.1f}% (op-level "
            f"traffic), {rec['compulsory_roofline_fraction']*100:5.1f}% "
            "(compulsory)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--quant", action="store_true",
                    help="int8-weight variant (decode cells only)")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else sorted(all_lm_configs())
    shapes = [args.shape] if args.shape else list(SHAPES_BY_NAME)
    meshes = [False, True] if (args.all or args.both_meshes) \
        else [args.multi_pod]

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape, mp, force=args.force,
                               quant=args.quant)
                print(summarize(rec), flush=True)
                failures += rec["status"] == "error"
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
