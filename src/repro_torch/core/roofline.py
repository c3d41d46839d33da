"""Three-term roofline of a step — the JAX package's
``repro.core.roofline`` on the port.

    compute    = FLOPs per chip / the chip's peak for the step's dtype
    memory     = HBM bytes per chip / the chip's HBM rate
    collective = sum over mesh axes of wire bytes per chip / that axis's
                 link rate

The reference reads its FLOPs, bytes and collectives from XLA's
partitioned HLO text (its ``analyze_hlo``).  The port never produces HLO:
its counterpart is a **meta-device count** (:class:`MetaCount`), a
``TorchDispatchMode`` under which the port's own step runs on ``meta``
tensors.  It counts

* the kernels the step calls (the engine's operators
  :func:`~repro_torch.core.engine.kernel_matmul` and
  :func:`~repro_torch.core.engine.kernel_flash`: SA-FC, the SA-CONV GEMM
  and flash attention, forward and backward), each with its exact
  operations and operand bytes, keyed by the engine's op name and role;
* every other aten op the step dispatches: matmul-like ops' operations
  (``mm``, ``addmm``, ``bmm``, ``baddbmm``), and every non-view op's
  inputs plus output (an op-level upper bound on HBM traffic, as the
  reference's HLO-op-level bytes are: nothing is assumed fused);
* the peak of the bytes that tensors made inside the count hold at once.

:func:`terms_from_trace` turns such a count into :class:`RooflineTerms`;
:func:`top_cost_lines` is the count's profile.  Wire bytes are analytic
(the dry run derives them from the sharding specs with :data:`WIRE_FACTOR`).

The schedule-derived half (:func:`terms_from_schedule` and the three
reports after it) reads the port's :class:`~repro_torch.core.schedule.
LayerSchedule` and equals the reference's on the planner's chip
(``TPU_V5E``).
"""
from __future__ import annotations

import dataclasses
import functools
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.core import engine  # noqa: F401  (defines the kernel ops)
from repro_torch.core.accelerator import TPU_V5E

#: per-chip wire bytes of one collective over a group of ``g`` devices,
#: per byte of its result (ring algorithms), as the reference factors them
WIRE_FACTOR = {
    "all-reduce": lambda g: 2.0 * (g - 1) / g,
    "all-gather": lambda g: (g - 1) / g,
    "reduce-scatter": lambda g: float(g - 1),
    "all-to-all": lambda g: (g - 1) / g,
    "collective-permute": lambda g: 1.0,
}


@dataclasses.dataclass
class RooflineTerms:
    flops_per_chip: float
    hbm_bytes_per_chip: float
    wire_bytes_per_chip: float
    chips: int
    model_flops: float = 0.0            # 6*N*D (or analytic serve flops)
    #: the step's compute dtype: which peak the compute term divides by
    #: (the reference's chip has one; the H100's bf16 and fp32 differ)
    dtype: str = "bfloat16"
    #: ``wire_bytes_per_chip`` split by mesh axis, and the mesh: each axis
    #: then crosses its own link (NVLink inside a node, the NIC outside)
    wire_bytes_by_axis: dict = dataclasses.field(default_factory=dict)
    mesh: Any = None
    #: the bytes the step cannot avoid moving (each argument read once,
    #: each result written once; the dry run adds the gradients and the
    #: carried activations): the floor under ``hbm_bytes_per_chip``,
    #: which counts every op's operands, nothing fused (an upper bound on
    #: traffic)
    compulsory_hbm_bytes: float = 0.0

    def compute_s(self, chip=TPU_V5E) -> float:
        return self.flops_per_chip / chip.peak_flops(self.dtype)

    def memory_s(self, chip=TPU_V5E) -> float:
        return self.hbm_bytes_per_chip / chip.hbm_bandwidth

    def collective_s(self, chip=TPU_V5E) -> float:
        if self.wire_bytes_by_axis and self.mesh is not None:
            return sum(b / chip.link_bandwidth(self.mesh, a)
                       for a, b in self.wire_bytes_by_axis.items())
        return self.wire_bytes_per_chip / chip.link_bandwidth()

    def dominant(self, chip=TPU_V5E):
        terms = {"compute": self.compute_s(chip),
                 "memory": self.memory_s(chip),
                 "collective": self.collective_s(chip)}
        name = max(terms, key=terms.get)
        return name, terms

    def bound_s(self, chip=TPU_V5E) -> float:
        """Step-time lower bound = max of the three terms (perfect overlap)."""
        return max(self.compute_s(chip), self.memory_s(chip),
                   self.collective_s(chip))

    def useful_flops_fraction(self) -> float:
        if not self.model_flops:
            return float("nan")
        return self.model_flops / (self.flops_per_chip * self.chips)

    def roofline_fraction(self, chip=TPU_V5E) -> float:
        """MODEL_FLOPs utilization at the bound: what MFU would be if the
        step ran exactly at max(terms).  Its memory term counts op-level
        traffic, an upper bound on traffic, so the bound is loose where
        memory dominates; :meth:`compulsory_roofline_fraction` is the
        same at the compulsory bound."""
        if not self.model_flops:
            return float("nan")
        t = self.bound_s(chip)
        return (self.model_flops / self.chips) / (t * chip.peak_flops(
            self.dtype))

    def compulsory_bound_s(self, chip=TPU_V5E) -> float:
        """Step-time lower bound with the memory term at the compulsory
        traffic: max(compute, compulsory bytes / HBM rate, collective)."""
        return max(self.compute_s(chip),
                   self.compulsory_hbm_bytes / chip.hbm_bandwidth,
                   self.collective_s(chip))

    def compulsory_roofline_fraction(self, chip=TPU_V5E) -> float:
        """:meth:`roofline_fraction` at :meth:`compulsory_bound_s`."""
        if not self.model_flops:
            return float("nan")
        t = self.compulsory_bound_s(chip)
        return (self.model_flops / self.chips) / (t * chip.peak_flops(
            self.dtype))


# ---------------------------------------------------------------------------
# the meta-device count
# ---------------------------------------------------------------------------
def _mm_flops(func, args) -> int:
    """Operations of a matmul-like aten op (2 a multiply-add)."""
    name = func.overloadpacket.__name__
    if name in ("mm", "bmm", "addmm", "baddbmm"):
        a, b = (args[0], args[1]) if name in ("mm", "bmm") else \
            (args[1], args[2])
        batch = a.shape[0] if a.dim() == 3 else 1
        m, k = a.shape[-2], a.shape[-1]
        return 2 * batch * m * k * b.shape[-1]
    return 0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


#: aten ops that move no data: views are skipped by ``is_view``
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "detach", "alias", "lift_fresh",
               "_local_scalar_dense", "set_", "resize_"}


@dataclasses.dataclass
class CostRow:
    count: int = 0
    flops: float = 0.0
    nbytes: float = 0.0


@dataclasses.dataclass(frozen=True)
class KernelCall:
    """One call of a kernel operator.  ``role``: ``forward``, ``pre`` (a
    non-linear activation's pre-activation recomputed in the backward),
    ``dx`` or ``dw`` for a matmul (``shape``: the (m, k) @ (k, n) it
    runs, as ``(m, k, n)``); ``forward`` for flash (``shape``: b, sq, skv,
    hq, hkv, d, causal, window).  ``flops`` counts a multiply-add as 2
    operations (flash: the visible query-key pairs' two products);
    ``nbytes`` the operands and the output, each once."""
    kernel: str
    name: str
    role: str
    shape: tuple
    flops: int
    nbytes: int

    @property
    def key(self) -> str:
        """The count's row: ``"<op name> <role> [<kernel>]"``."""
        return f"{self.name} {self.role} [{self.kernel}]"


@functools.lru_cache(maxsize=256)
def visible_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """Query-key pairs attention lets see each other: query ``i`` sits at
    position ``i + skv - sq`` (aligned to the end of the keys), a key is
    visible at ``kpos <= qpos`` (causal) and ``kpos > qpos - window``
    (window > 0)."""
    total = 0
    for i in range(sq):
        qpos = i + skv - sq
        hi = min(qpos, skv - 1) if causal else skv - 1
        lo = max(0, qpos - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def _kernel_call(func, args, moved: int) -> KernelCall | None:
    """The :class:`KernelCall` of a dispatch of the engine's kernel
    operators (None for any other op)."""
    if func.namespace != "repro_torch":
        return None
    op = func.overloadpacket.__name__
    if op == "kernel_matmul":
        x2d, w, _, _, _, regime, _, name, role = args
        m, k = x2d.shape
        n = w.shape[1]
        kernel = "sa_fc_matmul" if regime == "sa_fc" else "sa_conv_matmul"
        return KernelCall(kernel, name, role, (m, k, n), 2 * m * k * n,
                          moved)
    if op == "kernel_flash":
        q, k, _, causal, window, _, _, name = args
        b, sq, hq, d = q.shape
        skv, hkv = k.shape[1], k.shape[2]
        return KernelCall("flash_attention", name, "forward",
                          (b, sq, skv, hq, hkv, d, causal, window),
                          4 * b * hq * d * visible_pairs(sq, skv, causal,
                                                         window), moved)
    return None


class MetaCount(TorchDispatchMode):
    """Count what runs inside: operations, op-level bytes and the peak of
    live bytes, by kernel call (:attr:`KernelCall.key`, each call also in
    ``calls``) and by aten op (``"aten.<op>"``).  Meant for
    ``meta`` tensors, where nothing computes and the count is the step's
    shape; it counts on any device.  ``byte_scale(tensor)``, when given,
    weighs each tensor's live bytes (one chip's share of it)."""

    def __init__(self, byte_scale=None) -> None:
        super().__init__()
        self.byte_scale = byte_scale
        self.rows: dict[str, CostRow] = {}
        self.calls: list[KernelCall] = []
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._live: dict[int, list[int]] = {}     # storage -> [bytes, refs]

    # -- live bytes ----------------------------------------------------------
    def _release(self, key: int) -> None:
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live_bytes -= entry[0]
            del self._live[key]

    def _hold(self, t: torch.Tensor, inputs: set[int]) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in inputs and key not in self._live:
            return                        # a view or update of an outsider
        entry = self._live.get(key)
        if entry is None:
            nb = st.nbytes()
            if self.byte_scale is not None:
                nb = int(nb * self.byte_scale(t))
            entry = self._live[key] = [nb, 0]
            self.live_bytes += entry[0]
            self.peak_live_bytes = max(self.peak_live_bytes,
                                       self.live_bytes)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def relayout(self, t: torch.Tensor, scale: float) -> None:
        """Weigh the live bytes of ``t``'s storage by ``scale`` from now
        on (a layout the step states after making the tensor; the peak
        already reached stays)."""
        st = t.untyped_storage()
        entry = self._live.get(st._cdata)
        if entry is not None:
            nb = int(st.nbytes() * scale)
            self.live_bytes += nb - entry[0]
            entry[0] = nb

    # -- dispatch ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        ins = [a for a in tree_flatten((args, kwargs))[0]
               if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_flatten(out)[0]
                if isinstance(o, torch.Tensor)]
        moved = 0 if (func.is_view or name in _NO_TRAFFIC) else \
            sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        call = _kernel_call(func, args, moved)
        if call is not None:
            self.calls.append(call)
            key, flops = call.key, call.flops
        else:
            key, flops = f"aten.{name}", _mm_flops(func, args)
        if flops or moved:
            row = self.rows.setdefault(key, CostRow())
            row.count += 1
            row.flops += flops
            row.nbytes += moved
        in_keys = {a.untyped_storage()._cdata for a in ins}
        for o in outs:
            self._hold(o, in_keys)
        return out

    # -- totals --------------------------------------------------------------
    def total(self, divisor=lambda key: 1) -> tuple[float, float]:
        """(operations, bytes) over every row, each row divided by
        ``divisor(row key)``."""
        f = b = 0.0
        for key, row in self.rows.items():
            d = divisor(key)
            f += row.flops / d
            b += row.nbytes / d
        return f, b

    def kernel_flops(self, kernels=("sa_fc_matmul", "sa_conv_matmul")
                     ) -> int:
        """Operations of the logged calls to ``kernels`` (default: the
        two matmul kernels)."""
        return sum(c.flops for c in self.calls if c.kernel in kernels)


def terms_from_trace(count: MetaCount, chips: int, model_flops: float = 0.0,
                     *, divisor=lambda key: 1, wire_bytes_by_axis=None,
                     mesh=None, dtype: str = "bfloat16",
                     compulsory_hbm_bytes: float = 0.0) -> RooflineTerms:
    """Roofline terms from a meta-device count of one chip's step (rows
    divided by ``divisor(row key)``: the share of the count one chip
    does), the step's analytic wire bytes by mesh axis and its compulsory
    HBM bytes."""
    flops, nbytes = count.total(divisor)
    wire = dict(wire_bytes_by_axis or {})
    return RooflineTerms(flops_per_chip=flops, hbm_bytes_per_chip=nbytes,
                         wire_bytes_per_chip=float(sum(wire.values())),
                         chips=chips, model_flops=model_flops, dtype=dtype,
                         wire_bytes_by_axis=wire, mesh=mesh,
                         compulsory_hbm_bytes=compulsory_hbm_bytes)


def top_cost_lines(count: MetaCount, k: int = 20, by: str = "bytes"
                   ) -> list[tuple]:
    """The dry run's profile: the ``k`` largest rows of a count as
    (cost, calls, key, operations, bytes), ``by`` ``"bytes"`` or
    ``"flops"``; a kernel row's key names the engine's op and role."""
    rows = [((r.nbytes if by == "bytes" else r.flops), r.count, key,
             r.flops, r.nbytes) for key, r in count.rows.items()]
    rows.sort(key=lambda r: r[0], reverse=True)
    return rows[:k]


# ---------------------------------------------------------------------------
# terms from a compiled schedule (the planner's analytic view)
# ---------------------------------------------------------------------------
def _itemsize(dtype_name: str) -> int:
    return getattr(torch, dtype_name).itemsize


def terms_from_schedule(schedule, chips: int = 1,
                        model_flops: float = 0.0) -> RooflineTerms:
    """Roofline terms from a compiled
    :class:`repro_torch.core.schedule.LayerSchedule`: each scheduled op's
    planner-analytic FLOPs and HBM traffic summed, matmul AND conv entries
    (a conv entry whose plan fused the following maxpool contributes only
    the *pooled* output bytes).  What the schedule commits to; no
    collective term, single-chip analytic view."""
    plans = list(schedule.values()) + list(
        getattr(schedule, "conv_entries", {}).values())
    flops = float(sum(p.flops for p in plans))
    hbm = float(sum(p.hbm_bytes for p in plans))
    return RooflineTerms(flops_per_chip=flops / chips,
                         hbm_bytes_per_chip=hbm / chips,
                         wire_bytes_per_chip=0.0, chips=chips,
                         model_flops=model_flops)


def fused_pool_traffic_from_schedule(schedule) -> dict[str, dict[str, float]]:
    """Per-conv-entry fused-vs-unfused HBM accounting from a compiled
    schedule: for every conv entry that committed a fused-pool flush
    epilogue, the bytes the schedule moves vs. what the unfused
    conv -> HBM -> standalone-pool composition would move.  Entries
    without an accepted pool fusion report a zero saving."""
    from repro_torch.core.dataflow import (PoolSpec, plan_conv,
                                           pool_roundtrip_bytes)

    out: dict[str, dict[str, float]] = {}
    policy = schedule.policy
    for key, plan in getattr(schedule, "conv_entries", {}).items():
        bytes_in = _itemsize(key.dtype)
        bytes_w = _itemsize(key.weight_dtype)
        fused = float(plan.hbm_bytes)
        unfused = fused
        if plan.fuse_pool:
            uplan = plan_conv(key.batch, key.h, key.w, key.ci, key.p,
                              key.q, key.co, stride=key.stride,
                              bytes_in=bytes_in, bytes_w=bytes_w,
                              vmem_budget=policy.vmem_budget,
                              chip=policy.chip, regime=plan.regime)
            oh = (key.h - key.p) // key.stride + 1
            ow = (key.w - key.q) // key.stride + 1
            unfused = float(uplan.hbm_bytes + pool_roundtrip_bytes(
                key.batch, oh, ow, key.co,
                PoolSpec(plan.pool_window, plan.pool_stride)))
        out[key.name] = {"fused_bytes": fused, "unfused_bytes": unfused,
                         "saving_bytes": unfused - fused}
    return out


def pipeline_overlap_from_schedule(conv_schedule, fc_schedule, *,
                                   waves: int = 1, chip=TPU_V5E) -> dict:
    """Dual-array pipeline overlap report from the two compiled stage
    schedules (:meth:`LayerSchedule.compile_cnn_stages`): per-stage
    roofline-bounded seconds, which array is the wave bottleneck, the
    per-wave overlap efficiency and the serial-vs-pipelined makespan ratio
    for ``waves`` identical waves."""
    conv = terms_from_schedule(conv_schedule)
    fc = terms_from_schedule(fc_schedule)
    conv_s, fc_s = conv.bound_s(chip), fc.bound_s(chip)
    top, bot = max(conv_s, fc_s), min(conv_s, fc_s)
    serial_s = waves * (conv_s + fc_s)
    pipelined_s = conv_s + fc_s + (waves - 1) * top
    return {
        "waves": waves,
        "conv_stage": {"seconds": conv_s,
                       "flops": conv.flops_per_chip,
                       "hbm_bytes": conv.hbm_bytes_per_chip,
                       "bound": conv.dominant(chip)[0]},
        "fc_stage": {"seconds": fc_s,
                     "flops": fc.flops_per_chip,
                     "hbm_bytes": fc.hbm_bytes_per_chip,
                     "bound": fc.dominant(chip)[0]},
        "bottleneck": "sa_conv" if conv_s >= fc_s else "sa_fc",
        "overlap_efficiency": (bot / top) if top > 0 else 0.0,
        "serial_s": serial_s,
        "pipelined_s": pipelined_s,
        "makespan_ratio": (serial_s / pipelined_s) if pipelined_s > 0
        else 1.0,
    }


def fc_batch_traffic_from_schedule(schedule) -> dict[str, dict[str, float]]:
    """Per-FC-entry batch-amortization accounting from a compiled schedule:
    for every matmul entry routed to the batch-amortized SA-FC dataflow
    (an :class:`~repro_torch.core.dataflow.FCPlan`), the streamed weight
    bytes per sample vs. the compulsory single stream, the weight passes,
    and the planner-pinned flip batch."""
    out: dict[str, dict[str, float]] = {}
    for key, plan in schedule.items():
        if not hasattr(plan, "bb"):          # MatmulPlan (sa_conv) entry
            continue
        bw = _itemsize(key.weight_dtype)
        b = max(1, key.m)
        out[key.name] = {
            "batch": float(key.m),
            "batch_tile": float(plan.bb),
            "weight_passes": float(plan.weight_passes),
            "weight_bytes_per_sample": plan.weight_hbm_bytes / b,
            "compulsory_weight_bytes_per_sample": key.k * key.n * bw / b,
            "hbm_bytes": float(plan.hbm_bytes),
            "amortized_intensity": float(plan.arithmetic_intensity),
            "flip_batch": float(plan.flip_batch),
        }
    return out


def model_flops_train(n_active_params: int, tokens: int) -> float:
    return 6.0 * n_active_params * tokens


def model_flops_decode(n_active_params: int, tokens: int) -> float:
    return 2.0 * n_active_params * tokens
