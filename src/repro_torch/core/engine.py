"""Explicit heterogeneous execution engine — MPNA's array dispatch as an
object API (the port of the JAX package's engine).

The paper assigns each layer to the systolic array whose dataflow matches
its reuse pattern (CONV -> SA-CONV, FC -> SA-FC) in an offline per-layer
schedule (Sec. V).  This module is the runtime half of that design:

* :class:`Engine` — owns the backend, a pluggable :class:`DispatchPolicy`
  (the SA-CONV/SA-FC classifier + Case-1..4 planner), an optional compiled
  :class:`repro_torch.core.schedule.LayerSchedule`, and a structured
  :class:`DispatchTrace`.  ``matmul``, ``conv2d``, ``pool`` and
  ``attention`` are methods.
* Two backends: ``"kernels"`` runs the hand-written CUDA kernels (their
  wrappers take the plain versions for CPU tensors), ``"torch"`` runs the
  plain PyTorch versions (:mod:`repro_torch.kernels.ref`).
* :class:`DispatchTrace` / :class:`DispatchRecord` — "which array did this
  layer run on" as structured data, with dtypes spelled as the JAX package
  spells them (``"float32"``, ``"int8"``) so traces compare field for field.

int8 weights (:class:`repro_torch.core.quant.QTensor`) reach the kernels
un-dequantized; the per-channel scale runs in the kernel epilogue.

A matmul runs on the SA-FC kernel in the ``sa_fc`` regime and on the
SA-CONV GEMM kernel in the ``sa_conv`` regime; the plan's tiles are the
planner's (TPU) tiles and the CUDA kernels pick their own.

On the ``"kernels"`` backend ``matmul`` and ``attention`` are
differentiable, as the JAX package's Pallas path is: the matmul's backward
runs the same two kernels (``dx`` on the forward's regime kernel against
a contiguous ``w.T``, ``dw = x.T @ dpre`` on the SA-CONV GEMM), and
attention's backward differentiates the plain version from the saved q, k
and v (the reference's flash kernel has no VJP; it trains on XLA, whose
attention is that plain version).  Backward launches are not recorded in
the trace.  ``conv2d`` and ``pool`` refuse inputs that require grad: the
JAX package has no backward for them.

The kernels backend reaches the matmul and flash kernels through two
PyTorch operators, ``repro_torch::kernel_matmul`` and
``repro_torch::kernel_flash`` (:func:`kernel_matmul`, :func:`kernel_flash`):
each launches its kernel, and on ``meta`` tensors returns an empty output
of the kernel's shape.  Each carries the op's name and its role as labels,
so a dispatch mode sees every kernel call with its shape: the dry run's
count (:class:`repro_torch.core.roofline.MetaCount`) costs them there.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from collections.abc import Iterator
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core import dataflow
from repro_torch.core.accelerator import TPU_V5E, TPUChip
from repro_torch.core.dataflow import ConvPlan, FCPlan, MatmulPlan, PoolSpec
from repro_torch.core.quant import QTensor
from repro_torch.kernels import ref
from repro_torch.kernels.attention import flash_attention
from repro_torch.kernels.pool_act import maxpool_act
from repro_torch.kernels.sa_conv import sa_conv_matmul
from repro_torch.kernels.sa_conv_implicit import sa_conv_implicit
from repro_torch.kernels.sa_fc import sa_fc_matmul

BACKENDS = ("kernels", "torch")


def dtype_name(dtype: torch.dtype) -> str:
    """The JAX package's spelling of a dtype (``torch.float32`` ->
    ``"float32"``)."""
    return str(dtype).removeprefix("torch.")


# ---------------------------------------------------------------------------
# structured dispatch trace
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class DispatchRecord:
    """One dispatch decision."""
    name: str
    regime: str                 # 'sa_conv' | 'sa_fc' | 'pool' | 'attention'
    m: int
    n: int
    k: int
    case: int
    backend: str
    dtype: str = ""             # activation dtype
    weight_dtype: str = ""      # 'int8' for QTensor weights
    schedule: str = ""          # 'hit' | 'miss' | '' (no schedule attached)
    plan: MatmulPlan | None = None
    fc_plan: FCPlan | None = None
    # CONV dispatches: the plan plus (batch, h, w, ci, p, q, co, stride),
    # h/w the padded input dims
    conv_plan: ConvPlan | None = None
    conv_shape: tuple[int, ...] | None = None
    pool: PoolSpec | None = None
    stage: str = ""             # pipeline stage tag ('conv' | 'fc' | '')
    wave: int = -1              # serving wave tag (-1 = untagged)


class DispatchTrace:
    """Ordered record of every dispatch decision made under an engine."""

    def __init__(self) -> None:
        self.records: list[DispatchRecord] = []

    def append(self, rec: DispatchRecord) -> None:
        self.records.append(rec)

    def __iter__(self) -> Iterator[DispatchRecord]:
        return iter(self.records)

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, i):
        return self.records[i]

    def summary(self) -> str:
        lines = []
        for r in self.records:
            fused = ""
            if r.conv_plan is not None and r.conv_plan.fuse_pool:
                fused = (f" +pool{r.conv_plan.pool_window}"
                         f"s{r.conv_plan.pool_stride}")
            elif r.pool is not None and r.conv_plan is not None:
                fused = " pool-declined"
            elif r.fc_plan is not None:
                fused = (f" bb={r.fc_plan.bb}"
                         f" wx{r.fc_plan.weight_passes}")
            lines.append(f"{r.name:24s} {r.regime:9s} case={r.case} "
                         f"({r.m}x{r.k})@({r.k}x{r.n}) "
                         f"w={r.weight_dtype or '-'} "
                         f"{r.schedule or 'planned'}{fused}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# dispatch policy
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class DispatchPolicy:
    """Pluggable SA-CONV/SA-FC classification + Case-1..4 planning.

    ``chip`` supplies the ridge point and default buffer budget (the JAX
    package's planning model); ``vmem_budget`` overrides the budget;
    ``force_regime`` pins every op to one array; ``overrides`` pins ops by
    exact name."""
    chip: TPUChip = TPU_V5E
    vmem_budget: int | None = None
    force_regime: str | None = None          # 'sa_conv' | 'sa_fc'
    overrides: tuple[tuple[str, str], ...] = ()

    def __post_init__(self) -> None:
        regimes = (None, "sa_conv", "sa_fc")
        if self.force_regime not in regimes:
            raise ValueError(f"force_regime must be one of {regimes[1:]}, "
                             f"got {self.force_regime!r}")
        for name, reg in self.overrides:
            if reg not in regimes[1:]:
                raise ValueError(f"override {name!r} names unknown regime "
                                 f"{reg!r}; must be one of {regimes[1:]}")

    @property
    def effective_vmem_budget(self) -> int:
        """The on-chip allowance every plan under this policy honors."""
        return self.vmem_budget if self.vmem_budget is not None \
            else self.chip.vmem_budget

    def regime_for(self, name: str, m: int, n: int, k: int, *,
                   act_bytes: int, weight_bytes: int | None = None) -> str:
        for pat, reg in self.overrides:
            if name == pat:
                return reg
        if self.force_regime is not None:
            return self.force_regime
        return dataflow.classify_regime(m, n, k, act_bytes, self.chip,
                                        bytes_w=weight_bytes)

    def plan(self, m: int, n: int, k: int, *, act_bytes: int,
             weight_bytes: int | None = None,
             regime: str | None = None) -> MatmulPlan:
        return _cached_plan(self, m, n, k, act_bytes,
                            weight_bytes if weight_bytes is not None
                            else act_bytes, regime)

    def plan_fc(self, b: int, n: int, k: int, *, act_bytes: int,
                weight_bytes: int | None = None,
                regime: str | None = None) -> FCPlan:
        """Batch-amortized SA-FC planning under this policy's budget."""
        return _cached_fc_plan(self, b, n, k, act_bytes,
                               weight_bytes if weight_bytes is not None
                               else act_bytes, regime)

    def conv_regime_for(self, name: str, batch: int, h: int, w: int,
                        ci: int, p: int, q: int, co: int, stride: int, *,
                        act_bytes: int,
                        weight_bytes: int | None = None) -> str:
        for pat, reg in self.overrides:
            if name == pat:
                return reg
        if self.force_regime is not None:
            return self.force_regime
        return dataflow.classify_conv_regime(
            batch, h, w, ci, p, q, co, stride=stride, bytes_in=act_bytes,
            bytes_w=weight_bytes, chip=self.chip)

    def plan_conv(self, batch: int, h: int, w: int, ci: int,
                  p: int, q: int, co: int, stride: int, *, act_bytes: int,
                  weight_bytes: int | None = None,
                  regime: str | None = None,
                  pool: PoolSpec | None = None,
                  act: str = "none") -> ConvPlan:
        """Conv planning under this policy's budget; ``pool`` requests the
        fused maxpool epilogue, which the planner may decline."""
        return _cached_conv_plan(self, batch, h, w, ci, p, q, co, stride,
                                 act_bytes,
                                 weight_bytes if weight_bytes is not None
                                 else act_bytes, regime, pool, act)


@functools.lru_cache(maxsize=4096)
def _cached_plan(policy: DispatchPolicy, m: int, n: int, k: int,
                 act_bytes: int, weight_bytes: int,
                 regime: str | None) -> MatmulPlan:
    return dataflow.plan_matmul(
        m, n, k, bytes_in=act_bytes, bytes_w=weight_bytes,
        vmem_budget=policy.vmem_budget, chip=policy.chip, regime=regime)


@functools.lru_cache(maxsize=4096)
def _cached_fc_plan(policy: DispatchPolicy, b: int, n: int, k: int,
                    act_bytes: int, weight_bytes: int,
                    regime: str | None) -> FCPlan:
    return dataflow.plan_fc(
        b, n, k, bytes_in=act_bytes, bytes_w=weight_bytes,
        vmem_budget=policy.vmem_budget, chip=policy.chip, regime=regime)


@functools.lru_cache(maxsize=4096)
def _cached_conv_plan(policy: DispatchPolicy, batch: int, h: int, w: int,
                      ci: int, p: int, q: int, co: int, stride: int,
                      act_bytes: int, weight_bytes: int,
                      regime: str | None,
                      pool: PoolSpec | None, act: str) -> ConvPlan:
    return dataflow.plan_conv(
        batch, h, w, ci, p, q, co, stride=stride, bytes_in=act_bytes,
        bytes_w=weight_bytes, vmem_budget=policy.vmem_budget,
        chip=policy.chip, regime=regime, pool=pool, act=act)


def _refuse_grad(name: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the kernels backend has no backward for conv2d or "
            "pool (the JAX package has none either: it trains no CNN); "
            "run under torch.no_grad() or on the 'torch' backend")


# ---------------------------------------------------------------------------
# kernels-backend autodiff: the JAX package's custom VJPs
# (``_make_pallas_vjp``, ``_quantized_pallas_matmul``) as autograd
# Functions whose backward runs the forward kernels.  The reference plans
# the SA-FC ``dx`` stream (``_fc_dx_plan``); the port's SA-FC picks its own
# tiles from the launch's shape, so there is nothing to plan here.
# ---------------------------------------------------------------------------
@torch.library.custom_op(
    "repro_torch::kernel_matmul", mutates_args=(),
    schema="(Tensor x2d, Tensor w, Tensor? bias, Tensor? w_scale, str act, "
           "str regime, ScalarType? out_dtype, str name, str role) -> Tensor")
def kernel_matmul(x2d, w, bias, w_scale, act, regime, out_dtype, name, role):
    """One call of SA-FC (``regime == "sa_fc"``) or the SA-CONV GEMM:
    ``act(x2d @ w * w_scale + bias)``.  ``name`` (the engine's op) and
    ``role`` (``forward``; ``pre``, the pre-activation recomputed in the
    backward; ``dx``; ``dw``) are labels for a dispatch mode: the kernel
    does not read them."""
    kernel = sa_fc_matmul if regime == "sa_fc" else sa_conv_matmul
    return kernel(x2d, w, bias, act=act, w_scale=w_scale,
                  out_dtype=out_dtype)


@kernel_matmul.register_fake
def _(x2d, w, bias, w_scale, act, regime, out_dtype, name, role):
    return x2d.new_empty((x2d.shape[0], w.shape[1]),
                         dtype=out_dtype or x2d.dtype)


@torch.library.custom_op(
    "repro_torch::kernel_flash", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, bool causal, int window, "
           "float softcap, float? scale, str name) -> Tensor")
def kernel_flash(q, k, v, causal, window, softcap, scale, name):
    """One call of the flash kernel; ``name`` labels it, as in
    :func:`kernel_matmul`."""
    return flash_attention(q, k, v, causal=causal, window=window,
                           softcap=softcap, scale=scale)


@kernel_flash.register_fake
def _(q, k, v, causal, window, softcap, scale, name):
    return torch.empty_like(q)


def _kernel_matmul(regime: str, x2d: torch.Tensor, w: torch.Tensor,
                   bias: torch.Tensor | None = None, *, act: str = "none",
                   w_scale: torch.Tensor | None = None,
                   out_dtype=None, name: str = "",
                   role: str = "forward") -> torch.Tensor:
    return kernel_matmul(x2d, w, bias, w_scale, act, regime, out_dtype,
                         name, role)


def _act_grad(pre: torch.Tensor, act: str) -> torch.Tensor:
    """d act / d pre of :func:`ref.apply_act`, elementwise, in fp32."""
    _, vjp = torch.func.vjp(lambda t: ref.apply_act(t, act), pre)
    return vjp(torch.ones_like(pre))[0]


def _dpre(g: torch.Tensor, act: str, pre_fn) -> torch.Tensor:
    """``g * act'(pre)`` in fp32; ``pre_fn`` recomputes the pre-activation
    through the forward kernel, which ``act == "none"`` does not need
    (``act'`` is 1 there)."""
    gf = g.to(torch.float32)
    if act == "none":
        return gf
    return gf * _act_grad(pre_fn().to(torch.float32), act)


class _MatmulFn(torch.autograd.Function):
    """``act(x @ w + bias)`` on the regime's kernel, differentiable in x, w
    and bias (``bias`` may be None)."""

    @staticmethod
    def forward(ctx, x2d, w, bias, act, regime, out_dtype, name):
        ctx.save_for_backward(x2d, w, bias)
        ctx.act, ctx.regime, ctx.name = act, regime, name
        return _kernel_matmul(regime, x2d, w, bias, act=act,
                              out_dtype=out_dtype, name=name)

    @staticmethod
    def backward(ctx, g):
        x2d, w, bias = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        name = ctx.name
        dpre = _dpre(g, ctx.act, lambda: _kernel_matmul(
            ctx.regime, x2d, w, bias, name=name,
            role="pre")).to(x2d.dtype).contiguous()
        dx = dw = db = None
        if need_x:
            dx = _kernel_matmul(ctx.regime, dpre, w.t().contiguous(),
                                name=name, role="dx")
        if need_w:
            dw = _kernel_matmul("sa_conv", x2d.t().contiguous(), dpre,
                                name=name, role="dw").to(w.dtype)
        if need_b and bias is not None:
            db = dpre.to(torch.float32).sum(0).to(bias.dtype)
        return dx, dw, db, None, None, None, None


class _QuantMatmulFn(torch.autograd.Function):
    """``act((x @ q) * scale + bias)`` with frozen int8 weights:
    differentiable in x and bias.  ``dx`` folds the per-column scale into
    the cotangent and streams the raw int8 ``q.T`` (1 byte a weight)."""

    @staticmethod
    def forward(ctx, x2d, bias, q, w_scale, act, regime, out_dtype, name):
        ctx.save_for_backward(x2d, bias, q, w_scale)
        ctx.act, ctx.regime, ctx.name = act, regime, name
        return _kernel_matmul(regime, x2d, q, bias, act=act,
                              w_scale=w_scale, out_dtype=out_dtype,
                              name=name)

    @staticmethod
    def backward(ctx, g):
        x2d, bias, q, w_scale = ctx.saved_tensors
        dpre = _dpre(g, ctx.act, lambda: _kernel_matmul(
            ctx.regime, x2d, q, bias, w_scale=w_scale, name=ctx.name,
            role="pre"))
        dx = db = None
        if ctx.needs_input_grad[0]:
            scaled = (dpre * w_scale.reshape(1, -1).to(torch.float32)
                      ).to(x2d.dtype).contiguous()
            dx = _kernel_matmul(ctx.regime, scaled, q.t().contiguous(),
                                name=ctx.name, role="dx")
        if ctx.needs_input_grad[1] and bias is not None:
            db = dpre.sum(0).to(bias.dtype)
        return dx, db, None, None, None, None, None, None


class _FlashFn(torch.autograd.Function):
    """Flash attention forward on the kernel; the backward differentiates
    the plain :func:`ref.attention` recomputed from the saved q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, name):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        scale=scale)
        return kernel_flash(q, k, v, causal, window, softcap, scale,
                            name)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
            out = ref.attention(*qkv, **ctx.opts)
            grads = iter(torch.autograd.grad(
                out, [t for t in qkv if t.requires_grad], g))
        return (*(next(grads) if n else None for n in need),
                None, None, None, None, None)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
_TRACE_UNSET = object()     # distinguishes "no per-thread trace" from None


class Engine:
    """Explicit execution engine: backend + policy + trace + schedule::

        eng = Engine(backend="kernels")
        with eng.tracing() as tr:
            y = eng.matmul(x, w, act="relu", name="fc1")
        print(tr.summary())

    Attach a compiled :class:`~repro_torch.core.schedule.LayerSchedule`
    with :meth:`with_schedule` and every named op resolves its plan by
    lookup (recorded as ``schedule="hit"``)."""

    def __init__(self, *, backend: str = "torch",
                 chip: TPUChip | None = None,
                 policy: DispatchPolicy | None = None,
                 schedule: Any | None = None,
                 trace: DispatchTrace | None = None,
                 verify_schedules: bool = False) -> None:
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, "
                             f"got {backend!r}")
        if policy is None:
            policy = DispatchPolicy(chip=chip if chip is not None
                                    else TPU_V5E)
        elif chip is not None and chip is not policy.chip:
            policy = dataclasses.replace(policy, chip=chip)
        self.policy = policy
        self.backend = backend
        self.schedule = schedule
        # debug hook: statically verify any schedule at attach time (and
        # through with_schedule, which carries this flag via with_)
        self.verify_schedules = verify_schedules
        if verify_schedules and schedule is not None:
            from repro_torch.analysis import verify_schedule
            verify_schedule(schedule).raise_if_failed()
        # constructor-supplied trace is shared across threads (derived
        # engines); tracing() overlays a per-thread trace on top
        self._trace_default = trace
        self._trace_tls = threading.local()

    @property
    def trace(self) -> DispatchTrace | None:
        tls = getattr(self._trace_tls, "trace", _TRACE_UNSET)
        return self._trace_default if tls is _TRACE_UNSET else tls

    # -- derivation ---------------------------------------------------------
    def with_(self, **overrides: Any) -> Engine:
        """A derived engine sharing this engine's live trace."""
        kw = dict(backend=self.backend, policy=self.policy,
                  schedule=self.schedule, trace=self.trace,
                  verify_schedules=self.verify_schedules)
        kw.update(overrides)
        return Engine(**kw)

    def with_schedule(self, schedule) -> Engine:
        return self.with_(schedule=schedule)

    # -- context ------------------------------------------------------------
    @contextlib.contextmanager
    def activate(self):
        """Make this the engine :func:`current` resolves to."""
        stack = _engine_stack()
        stack.append(self)
        try:
            yield self
        finally:
            stack.pop()

    @contextlib.contextmanager
    def tracing(self):
        """Collect dispatch records into a fresh per-thread trace."""
        prev = getattr(self._trace_tls, "trace", _TRACE_UNSET)
        tr = DispatchTrace()
        self._trace_tls.trace = tr
        try:
            yield tr
        finally:
            if prev is _TRACE_UNSET:
                del self._trace_tls.trace
            else:
                self._trace_tls.trace = prev

    @contextlib.contextmanager
    def replaying(self):
        """Run a recomputation (the second forward of activation
        checkpointing) under this engine, recording nothing.  The backward
        pass may run it on another thread (autograd's device thread), whose
        engine stack is empty, so it activates this engine there."""
        prev = getattr(self._trace_tls, "trace", _TRACE_UNSET)
        self._trace_tls.trace = None
        try:
            with self.activate():
                yield self
        finally:
            if prev is _TRACE_UNSET:
                del self._trace_tls.trace
            else:
                self._trace_tls.trace = prev

    @contextlib.contextmanager
    def tagging(self, *, stage: str = "", wave: int = -1):
        """Tag every record issued inside with its pipeline stage and
        serving wave.  Per-thread and re-entrant."""
        prev = getattr(self._trace_tls, "tags", None)
        self._trace_tls.tags = (stage, wave)
        try:
            yield self
        finally:
            self._trace_tls.tags = prev

    def record(self, **kw: Any) -> None:
        """Append a :class:`DispatchRecord` to the live trace (no-op when
        not tracing)."""
        if self.trace is not None:
            tags = getattr(self._trace_tls, "tags", None)
            if tags is not None:
                kw.setdefault("stage", tags[0])
                kw.setdefault("wave", tags[1])
            self.trace.append(DispatchRecord(**kw))

    # -- planning -----------------------------------------------------------
    def plan_for(self, name: str, m: int, n: int, k: int, *,
                 dtype: torch.dtype, weight_dtype: torch.dtype
                 ) -> tuple[Any, str]:
        """(plan, 'hit'|'miss'|'') for one named op — schedule lookup with
        policy fallback; SA-FC ops get an :class:`FCPlan`."""
        act_bytes = dtype.itemsize
        w_bytes = weight_dtype.itemsize
        state = ""
        if self.schedule is not None:
            plan = self.schedule.lookup(name, m, n, k, dtype_name(dtype),
                                        dtype_name(weight_dtype))
            if plan is not None:
                return plan, "hit"
            state = "miss"
        regime = self.policy.regime_for(name, m, n, k, act_bytes=act_bytes,
                                        weight_bytes=w_bytes)
        try:
            if regime == "sa_fc":
                plan = self.policy.plan_fc(m, n, k, act_bytes=act_bytes,
                                           weight_bytes=w_bytes,
                                           regime=regime)
            else:
                plan = self.policy.plan(m, n, k, act_bytes=act_bytes,
                                        weight_bytes=w_bytes, regime=regime)
        except dataflow.PlanError as e:
            raise e.with_op(name) from e
        return plan, state

    def plan_conv_for(self, name: str, batch: int, h: int, w: int, ci: int,
                      p: int, q: int, co: int, stride: int, *,
                      dtype: torch.dtype, weight_dtype: torch.dtype,
                      pool: PoolSpec | None = None,
                      act: str = "none") -> tuple[ConvPlan, str]:
        """(conv plan, 'hit'|'miss'|'') for one named CONV op."""
        act_bytes = dtype.itemsize
        w_bytes = weight_dtype.itemsize
        state = ""
        if self.schedule is not None:
            plan = self.schedule.lookup_conv(
                name, batch, h, w, ci, p, q, co, stride,
                dtype_name(dtype), dtype_name(weight_dtype), pool=pool)
            if plan is not None:
                return plan, "hit"
            state = "miss"
        regime = self.policy.conv_regime_for(name, batch, h, w, ci, p, q,
                                             co, stride,
                                             act_bytes=act_bytes,
                                             weight_bytes=w_bytes)
        try:
            plan = self.policy.plan_conv(batch, h, w, ci, p, q, co, stride,
                                         act_bytes=act_bytes,
                                         weight_bytes=w_bytes, regime=regime,
                                         pool=pool, act=act)
        except dataflow.PlanError as e:
            raise e.with_op(name) from e
        return plan, state

    # -- ops ----------------------------------------------------------------
    def matmul(self, x: torch.Tensor, w, bias: torch.Tensor | None = None,
               *, act: str = "none", name: str = "matmul",
               out_dtype=None) -> torch.Tensor:
        """``(..., k) @ (k, n)`` with fused bias + activation, routed by the
        policy/schedule.  ``w`` may be a :class:`QTensor`."""
        if isinstance(w, QTensor):
            wq, w_scale = w.q, w.scale.reshape(1, -1)
        else:
            wq, w_scale = w, None
        *lead, k = x.shape
        n = wq.shape[-1]
        m = 1
        for s in lead:
            m *= s
        plan, sched = self.plan_for(name, m, n, k, dtype=x.dtype,
                                    weight_dtype=wq.dtype)
        is_fc = isinstance(plan, FCPlan)
        self.record(name=name, regime=plan.regime, m=m, n=n, k=k,
                     case=plan.case, backend=self.backend,
                     dtype=dtype_name(x.dtype),
                     weight_dtype=dtype_name(wq.dtype),
                     schedule=sched, plan=None if is_fc else plan,
                     fc_plan=plan if is_fc else None)
        x2d = x.reshape(m, k)
        out_dt = out_dtype if out_dtype is not None else x.dtype
        if self.backend == "kernels":
            if w_scale is not None:
                out = _QuantMatmulFn.apply(x2d.contiguous(), bias, wq,
                                           w_scale, act, plan.regime, out_dt,
                                           name)
            else:
                out = _MatmulFn.apply(x2d.contiguous(), wq, bias, act,
                                      plan.regime, out_dt, name)
        else:
            out = ref.matmul_bias_act(x2d, wq, bias, act=act,
                                      out_dtype=out_dt, w_scale=w_scale)
        return out.reshape(*lead, n)

    def conv2d(self, x: torch.Tensor, f, bias: torch.Tensor | None = None,
               *, stride: int = 1, pad: int = 0, act: str = "none",
               pool: PoolSpec | None = None,
               name: str = "conv", out_dtype=None) -> torch.Tensor:
        """NHWC x HWIO convolution with fused bias + activation, planned by
        the policy/schedule.  ``pool`` requests the following maxpool to
        ride the conv epilogue; the planner owns the decision, and a
        declined fusion runs conv then a standalone :meth:`pool`
        (``<name>.pool`` in the trace).  ``f`` may be a :class:`QTensor`."""
        if isinstance(f, QTensor):
            fq, f_scale = f.q, f.scale.reshape(-1)
        else:
            fq, f_scale = f, None
        if pad:
            x = F.pad(x, (0, 0, pad, pad, pad, pad))
        batch, h, w, ci = x.shape
        p, q, ci2, co = fq.shape
        if ci != ci2:
            raise ValueError(f"{name}: input {tuple(x.shape)} vs filter "
                             f"{tuple(fq.shape)}")
        plan, sched = self.plan_conv_for(name, batch, h, w, ci, p, q, co,
                                         stride, dtype=x.dtype,
                                         weight_dtype=fq.dtype,
                                         pool=pool, act=act)
        self.record(name=name, regime=plan.regime, m=plan.m, n=plan.n,
                     k=plan.k, case=plan.case, backend=self.backend,
                     dtype=dtype_name(x.dtype),
                     weight_dtype=dtype_name(fq.dtype),
                     schedule=sched, conv_plan=plan,
                     conv_shape=(batch, h, w, ci, p, q, co, stride),
                     pool=pool)
        out_dt = out_dtype if out_dtype is not None else x.dtype
        if self.backend == "kernels":
            _refuse_grad(name, x, fq, bias)
            out = sa_conv_implicit(
                x.contiguous(), fq, bias, stride=stride, act=act,
                pool_window=plan.pool_window if plan.fuse_pool else 0,
                pool_stride=plan.pool_stride, w_scale=f_scale,
                out_dtype=out_dt)
        else:
            ff = fq if f_scale is None else \
                fq.to(torch.float32) * f_scale.reshape(1, 1, 1, co)
            out = ref.conv2d(x, ff, stride=stride, out_dtype=torch.float32)
            if bias is not None:
                out = out + bias.to(torch.float32)
            out = ref.apply_act(out, act).to(out_dt)
            if plan.fuse_pool:
                out = ref.maxpool2d(out, window=plan.pool_window,
                                    stride=plan.pool_stride)
        if pool is not None and not plan.fuse_pool:
            out = self.pool(out, window=pool.window, stride=pool.stride,
                            name=f"{name}.pool")
        return out

    def pool(self, x: torch.Tensor, *, window: int,
             stride: int | None = None, act: str = "none",
             name: str = "pool") -> torch.Tensor:
        """Standalone maxpool + activation as its own traced dispatch."""
        stride = stride if stride is not None else window
        n, h, w, c = x.shape
        oh = (h - window) // stride + 1
        ow = (w - window) // stride + 1
        self.record(name=name, regime="pool", m=n * oh * ow, n=c,
                     k=window * window, case=0, backend=self.backend,
                     dtype=dtype_name(x.dtype), pool=PoolSpec(window, stride))
        if self.backend == "kernels":
            _refuse_grad(name, x)
            return maxpool_act(x.contiguous(), window=window, stride=stride,
                               act=act)
        return ref.maxpool_act(x, window=window, stride=stride, act=act)

    def attention(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  *, causal: bool = True, window: int = 0,
                  softcap: float = 0.0, scale: float | None = None,
                  name: str = "attn") -> torch.Tensor:
        """Blocked attention, q (b, sq, hq, d), k/v (b, skv, hkv, d): the
        flash kernel or the plain version, recorded as ``regime=
        "attention"``."""
        self.record(name=name, regime="attention", m=q.shape[1],
                    n=k.shape[1], k=q.shape[-1], case=0,
                    backend=self.backend, dtype=dtype_name(q.dtype))
        if self.backend == "kernels":
            return _FlashFn.apply(q, k, v, causal, window, softcap, scale,
                                  name)
        return ref.attention(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale)

    def __repr__(self) -> str:
        return (f"Engine(backend={self.backend!r}, policy={self.policy}, "
                f"schedule={'yes' if self.schedule is not None else 'no'})")


# ---------------------------------------------------------------------------
# current-engine stack
# ---------------------------------------------------------------------------
_LOCAL = threading.local()
_DEFAULT = Engine()


def _engine_stack() -> list[Engine]:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def current() -> Engine:
    """The innermost :meth:`Engine.activate`-d engine, else the module
    default (torch backend, default policy)."""
    stack = _engine_stack()
    return stack[-1] if stack else _DEFAULT
