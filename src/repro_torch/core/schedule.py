"""Compiled per-model layer schedules — the paper's offline schedule table.

MPNA assigns each layer to an array (SA-CONV vs SA-FC) and a dataflow case
(1–4) before execution (Sec. V).  :class:`LayerSchedule` is that artifact:
an immutable mapping from named ops to plans, compiled once per
(network, batch, shapes, policy) and memoized.  An engine carrying one
resolves every named op by lookup (``schedule="hit"``).

Compilation runs the network (or one pipeline stage), or one LM phase
(the training loss, prefill or decode), on ``meta`` tensors under a
collecting ``"torch"``-backend engine: shapes only, no data, no device
work.
"""
from __future__ import annotations

from collections.abc import Iterator, Mapping
from dataclasses import dataclass
from types import MappingProxyType
from typing import Any

import torch

from repro_torch.core import tree
from repro_torch.core.dataflow import ConvPlan, FCPlan, MatmulPlan
from repro_torch.core.engine import DispatchPolicy, Engine, dtype_name

#: LM phases :meth:`LayerSchedule.compile` knows
PHASES = ("train", "prefill", "decode")

#: Pipeline stages :meth:`LayerSchedule.compile_cnn` can compile for: the
#: full network, the SA-CONV stage or the SA-FC stage.  The stage schedules
#: partition the full schedule.
CNN_STAGES = ("full", "conv", "fc")


@dataclass(frozen=True)
class OpKey:
    """Identity of one scheduled op."""
    name: str
    m: int
    n: int
    k: int
    dtype: str
    weight_dtype: str


@dataclass(frozen=True)
class ConvOpKey:
    """Identity of one scheduled CONV op (``h``/``w`` the padded input;
    ``pool_window``/``pool_stride`` the pool requested to ride the
    epilogue, 0/0 for a plain conv)."""
    name: str
    batch: int
    h: int
    w: int
    ci: int
    p: int
    q: int
    co: int
    stride: int
    dtype: str
    weight_dtype: str
    pool_window: int = 0
    pool_stride: int = 0


class LayerSchedule(Mapping):
    """Immutable compiled mapping ``OpKey -> MatmulPlan | FCPlan`` (plus
    ``ConvOpKey -> ConvPlan``, reached via :meth:`lookup_conv` and
    :attr:`conv_entries`)."""

    def __init__(self, phase: str, policy: DispatchPolicy,
                 entries: dict[OpKey, MatmulPlan | FCPlan],
                 conv_entries: dict[ConvOpKey, ConvPlan] | None = None
                 ) -> None:
        self.phase = phase
        self.policy = policy
        self._entries = MappingProxyType(dict(entries))
        self._conv_entries = MappingProxyType(dict(conv_entries or {}))

    @property
    def conv_entries(self) -> Mapping:
        return self._conv_entries

    def __getitem__(self, key: OpKey) -> MatmulPlan | FCPlan:
        return self._entries[key]

    def __iter__(self) -> Iterator[OpKey]:
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, name: str, m: int, n: int, k: int,
               dtype: str, weight_dtype: str) -> MatmulPlan | FCPlan | None:
        return self._entries.get(OpKey(name, m, n, k, dtype, weight_dtype))

    def lookup_conv(self, name: str, batch: int, h: int, w: int, ci: int,
                    p: int, q: int, co: int, stride: int,
                    dtype: str, weight_dtype: str, *,
                    pool=None) -> ConvPlan | None:
        return self._conv_entries.get(
            ConvOpKey(name, batch, h, w, ci, p, q, co, stride,
                      dtype, weight_dtype,
                      pool.window if pool is not None else 0,
                      pool.stride if pool is not None else 0))

    def table(self) -> str:
        """The paper-style schedule table, one line per op."""
        lines = [f"[{self.phase}] {len(self) + len(self._conv_entries)} "
                 f"scheduled ops"]
        for ckey, cplan in self._conv_entries.items():
            pooltag = ""
            if ckey.pool_window:
                pooltag = (f"+pool{ckey.pool_window}s{ckey.pool_stride}"
                           f"{'' if cplan.fuse_pool else '(declined)'} ")
            lines.append(
                f"  {ckey.name:24s} conv {ckey.h}x{ckey.w}x{ckey.ci} "
                f"*{ckey.p}x{ckey.q}->{ckey.co} s{ckey.stride} {pooltag}"
                f"w={ckey.weight_dtype:8s} -> {cplan.regime:8s} "
                f"case {cplan.case} tile (bi={cplan.bi},bj={cplan.bj}) "
                f"hbm {cplan.hbm_bytes / 2**20:.1f} MiB")
        for key, plan in self._entries.items():
            if isinstance(plan, FCPlan):
                lines.append(
                    f"  {key.name:24s} ({key.m}x{key.k})@({key.k}x{key.n}) "
                    f"w={key.weight_dtype:8s} -> {plan.regime:8s} "
                    f"case {plan.case} "
                    f"tile (bb={plan.bb},{plan.bn},{plan.bk}) "
                    f"wstream x{plan.weight_passes} "
                    f"hbm {plan.hbm_bytes / 2**20:.1f} MiB")
                continue
            lines.append(
                f"  {key.name:24s} ({key.m}x{key.k})@({key.k}x{key.n}) "
                f"w={key.weight_dtype:8s} -> {plan.regime:8s} case {plan.case} "
                f"tile ({plan.bm},{plan.bn},{plan.bk}) "
                f"hbm {plan.hbm_bytes / 2**20:.1f} MiB")
        return "\n".join(lines)

    def __repr__(self) -> str:
        return (f"LayerSchedule(phase={self.phase!r}, ops={len(self)}, "
                f"conv_ops={len(self._conv_entries)})")

    @classmethod
    def compile(cls, cfg, phase: str, *,
                batch: int = 1, seq: int = 128,
                max_seq: int | None = None,
                cache_dtype=torch.bfloat16,
                policy: DispatchPolicy | None = None,
                params: Any | None = None) -> LayerSchedule:
        """Compile (and memoize) the schedule of LM ``cfg`` in ``phase``:
        ``train`` (the loss on a (batch, seq) batch), ``prefill`` ((batch,
        seq) prompt against a ``max_seq``-deep cache) or ``decode`` (one
        token per slot against the cache).  A vision config's schedules
        are its text-only ones, as the reference compiles them; an
        encoder-decoder config raises ``NotImplementedError``.  ``params``
        (optional) supplies the real parameter tree so quantized weight
        dtypes land in the keys; only its shapes and dtypes are read."""
        if phase not in PHASES:
            raise ValueError(f"phase must be one of {PHASES}, got {phase!r}")
        if cfg.enc_dec:
            raise NotImplementedError(
                f"{cfg.name}: an encoder-decoder config has no compiled "
                "schedule (its prefill and training need the audio frames, "
                "its decode the encoder's length, which a schedule does not "
                "take; the reference cannot compile one either): serve it "
                "through repro_torch.serve.serve_step.greedy_generate, and "
                "train it through train_step.make_train_step, which runs "
                "it with no schedule")
        if policy is None:
            policy = DispatchPolicy()
        key = (cfg, phase, batch, seq, max_seq, dtype_name(cache_dtype),
               policy, _params_fingerprint(params))
        hit = _CACHE.get(key)
        if hit is not None:
            return hit
        sched = cls(phase, policy,
                    *_collect(cfg, phase, batch, seq, max_seq, cache_dtype,
                              policy, params))
        _CACHE[key] = sched
        return sched

    @classmethod
    def compile_cnn(cls, net: str, *,
                    batch: int = 1,
                    in_res: int | None = None,
                    in_ch: int = 3,
                    width_mult: float = 1.0,
                    dtype=torch.float32,
                    policy: DispatchPolicy | None = None,
                    params: Any | None = None,
                    stage: str = "full") -> LayerSchedule:
        """Compile (and memoize) the inference schedule of a CNN from
        :data:`repro_torch.models.cnn.NETWORKS`, or of one pipeline stage
        (``"conv"`` or ``"fc"``).  ``params`` (optional) supplies the real
        parameters so int8 weights land in the keys; only their shapes and
        dtypes are read."""
        if stage not in CNN_STAGES:
            raise ValueError(f"stage must be one of {CNN_STAGES}, "
                             f"got {stage!r}")
        if policy is None:
            policy = DispatchPolicy()
        key = ("cnn", net, batch, in_res, in_ch, width_mult,
               dtype_name(dtype), policy, _params_fingerprint(params), stage)
        hit = _CACHE.get(key)
        if hit is not None:
            return hit
        sched = cls("infer", policy,
                    *_collect_cnn(net, batch, in_res, in_ch, width_mult,
                                  dtype, policy, params, stage))
        _CACHE[key] = sched
        return sched

    @classmethod
    def compile_cnn_stages(cls, net: str, **kw: Any
                           ) -> tuple[LayerSchedule, LayerSchedule]:
        """(conv-stage schedule, fc-stage schedule) for the dual-array
        serving pipeline — same arguments as :meth:`compile_cnn`."""
        return (cls.compile_cnn(net, stage="conv", **kw),
                cls.compile_cnn(net, stage="fc", **kw))


class ScheduleRegistry:
    """Multi-model schedule registry keyed by ``(net, dtype_tag, batch)``:
    each :meth:`register` compiles the (conv-stage, fc-stage) pair and files
    it.  Re-registering a key with the same settings is idempotent; with
    different settings it raises.

    ``verify=True`` statically verifies each newly compiled pair with
    :func:`repro_torch.analysis.verify_stage_pair` before filing it
    (raising :class:`repro_torch.analysis.ScheduleVerificationError` on a
    violation): the four schedule passes and the CUDA launch pass."""

    def __init__(self, *, verify: bool = False) -> None:
        self._stages: dict[tuple[str, str, int],
                           tuple[LayerSchedule, LayerSchedule]] = {}
        self._settings: dict[tuple[str, str, int], tuple] = {}
        self._verify = verify

    @staticmethod
    def _settings_fingerprint(compile_kw: dict[str, Any]) -> tuple:
        items = []
        for name in sorted(compile_kw):
            value = compile_kw[name]
            if name == "params":
                value = _params_fingerprint(value)
            elif name == "dtype" and value is not None:
                value = dtype_name(value)
            items.append((name, value))
        return tuple(items)

    def register(self, net: str, *, dtype_tag: str = "float32",
                 batch: int = 1, **compile_kw: Any
                 ) -> tuple[LayerSchedule, LayerSchedule]:
        key = (net, dtype_tag, batch)
        fingerprint = self._settings_fingerprint(compile_kw)
        hit = self._stages.get(key)
        if hit is not None:
            if fingerprint != self._settings[key]:
                raise ValueError(
                    f"conflicting re-registration of {key}: already "
                    f"compiled with {self._settings[key]!r}, "
                    f"re-requested with {fingerprint!r}")
            return hit
        pair = LayerSchedule.compile_cnn_stages(net, batch=batch,
                                                **compile_kw)
        if self._verify:
            from repro_torch.analysis import verify_stage_pair
            verify_stage_pair(
                pair, label=f"{key[0]}/{key[1]}@b{key[2]}"
            ).raise_if_failed()
        self._stages[key] = pair
        self._settings[key] = fingerprint
        return pair

    def stages(self, net: str, dtype_tag: str, batch: int
               ) -> tuple[LayerSchedule, LayerSchedule]:
        key = (net, dtype_tag, batch)
        if key not in self._stages:
            raise KeyError(f"no compiled schedule for {key}; "
                           f"registered: {sorted(self._stages)}")
        return self._stages[key]

    def keys(self) -> tuple[tuple[str, str, int], ...]:
        return tuple(sorted(self._stages))

    def __contains__(self, key: tuple[str, str, int]) -> bool:
        return key in self._stages

    def __len__(self) -> int:
        return len(self._stages)

    def __repr__(self) -> str:
        return f"ScheduleRegistry({list(self.keys())!r})"


_CACHE: dict[tuple, LayerSchedule] = {}


def clear_schedule_cache() -> None:
    """Drop every memoized schedule."""
    _CACHE.clear()


def _params_fingerprint(params: Any) -> tuple | None:
    if params is None:
        return None
    return tuple((path, tuple(t.shape), dtype_name(t.dtype))
                 for path, t in tree.flatten_with_paths(params))


def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _meta_params(params):
    """The same tree with every tensor replaced by a meta tensor."""
    return tree.map_leaves(_meta, params)


def _entries_from_trace(tr) -> tuple[dict[OpKey, MatmulPlan | FCPlan],
                                     dict[ConvOpKey, ConvPlan]]:
    entries: dict[OpKey, MatmulPlan | FCPlan] = {}
    conv_entries: dict[ConvOpKey, ConvPlan] = {}
    for rec in tr:
        if rec.conv_plan is not None and rec.conv_shape is not None:
            pool = rec.pool
            conv_entries[ConvOpKey(rec.name, *rec.conv_shape, rec.dtype,
                                   rec.weight_dtype,
                                   pool.window if pool is not None else 0,
                                   pool.stride if pool is not None else 0)
                         ] = rec.conv_plan
        elif rec.regime in ("sa_conv", "sa_fc") and \
                (rec.plan is not None or rec.fc_plan is not None):
            entries[OpKey(rec.name, rec.m, rec.n, rec.k, rec.dtype,
                          rec.weight_dtype)] = \
                rec.plan if rec.plan is not None else rec.fc_plan
    return entries, conv_entries


def _collect_cnn(net: str, batch: int, in_res: int | None, in_ch: int,
                 width_mult: float, dtype, policy: DispatchPolicy, params,
                 stage: str = "full"
                 ) -> tuple[dict[OpKey, MatmulPlan | FCPlan],
                            dict[ConvOpKey, ConvPlan]]:
    """Run one CNN forward (or one pipeline stage) on meta tensors under a
    collecting engine.  The ``"fc"`` stage runs on the conv stage's
    hand-off shape, derived by an untraced meta run of the conv stage."""
    from repro_torch.models import cnn

    _, res0 = cnn.NETWORKS[net]
    res = in_res if in_res is not None else res0
    if params is None:
        shapes = cnn.param_shapes(net, in_res=res, in_ch=in_ch,
                                  width_mult=width_mult)
        params = [{} if kind == "pool" else
                  {"f" if kind == "conv" else "w":
                   torch.empty(shape, dtype=dtype, device="meta"),
                   "b": torch.empty(shape[-1], dtype=dtype, device="meta")}
                  for kind, shape in shapes]
    else:
        params = _meta_params(params)
    x = torch.empty((batch, res, res, in_ch), dtype=dtype, device="meta")
    if stage == "fc":
        x = cnn.cnn_conv_stage(net, params, x,
                               eng=Engine(backend="torch", policy=policy))
    fn = {"full": cnn.cnn_forward, "conv": cnn.cnn_conv_stage,
          "fc": cnn.cnn_fc_stage}[stage]
    eng = Engine(backend="torch", policy=policy)
    with eng.tracing() as tr, eng.activate():
        fn(net, params, x, eng=eng)
    return _entries_from_trace(tr)


def _collect(cfg, phase: str, batch: int, seq: int, max_seq: int | None,
             cache_dtype, policy: DispatchPolicy, params
             ) -> tuple[dict[OpKey, MatmulPlan | FCPlan],
                        dict[ConvOpKey, ConvPlan]]:
    """Run one LM phase on meta tensors under a collecting engine."""
    from repro_torch.models import transformer as T
    from repro_torch.serve import kvcache as KC
    from repro_torch.serve.serve_step import decode_step, prefill_step

    params = T.init_params(cfg, 0, device="meta") if params is None \
        else _meta_params(params)
    ms = max_seq if max_seq is not None else seq + 32
    eng = Engine(backend="torch", policy=policy)
    with eng.tracing() as tr, eng.activate():
        if phase == "train":
            tokens = torch.empty((batch, seq), dtype=torch.int64,
                                 device="meta")
            T.loss_fn(cfg, params, {"tokens": tokens})
        elif phase == "prefill":
            tokens = torch.empty((batch, seq), dtype=torch.int64,
                                 device="meta")
            prefill_step(cfg, params, {"tokens": tokens}, ms, cache_dtype)
        else:                                   # decode
            cache = KC.init_cache(cfg, batch, ms, dtype=cache_dtype,
                                  device="meta")
            tok = torch.empty((batch, 1), dtype=torch.int64, device="meta")
            decode_step(cfg, params, cache, tok, 0)
    return _entries_from_trace(tr)
