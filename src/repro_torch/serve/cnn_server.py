"""Micro-batch coalescing CNN server on the port — batched image serving on
the batch-amortized SA-FC dataflow, pipelined across the two stages.

* Single-image requests queue up and are coalesced into the planner's
  preferred micro-batch (:attr:`~repro_torch.core.dataflow.FCPlan.bb` of
  the dominant FC layer): the samples one streamed weight pass serves.
* Each wave runs as two stages under memoized stage-split schedules: the
  SA-CONV stage (conv+fused-pool stack -> flattened features) and the SA-FC
  stage (classifier head).
* Pipelined runs enqueue wave *i+1*'s conv stage on the device before the
  host blocks on wave *i*'s logits (``.cpu()`` is the barrier).  Everything
  runs on one CUDA stream, so the device executes the stages in order; the
  overlap is between host work and device work, as on the JAX package's
  asynchronous dispatch.
* Per-request logits are bitwise equal on both paths and to the unbatched
  forward: same kernels, same plans, and kernels whose per-output
  arithmetic does not depend on the batch.
* Logits are delivered as numpy arrays; bf16 logits come widened to fp32
  (numpy has no bf16), which is exact, so each value is the bf16 value.

Every wave's :class:`~repro_torch.core.engine.DispatchTrace` is kept on its
:class:`WaveReport`, each record tagged with its stage and wave.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.accelerator import resolve_device
from repro_torch.core.engine import DispatchTrace, Engine
from repro_torch.core.quant import QTensor
from repro_torch.core.schedule import LayerSchedule
from repro_torch.models import cnn


@dataclasses.dataclass
class CNNRequest:
    """One single-image classification request."""
    uid: int
    image: np.ndarray                     # (H, W, C)
    done: bool = False
    logits: np.ndarray | None = None


@dataclasses.dataclass(frozen=True)
class WaveReport:
    """What one coalesced dispatch did: who rode it, how it resolved."""
    uids: tuple[int, ...]
    batch: int
    schedule_hits: int
    trace: DispatchTrace
    wave: int = 0
    conv_trace: DispatchTrace | None = None
    fc_trace: DispatchTrace | None = None

    @property
    def fc_records(self):
        """The FC dispatches of this wave (each carries its FCPlan)."""
        return [r for r in self.trace if r.fc_plan is not None]


@dataclasses.dataclass
class _StageBuffer:
    """Hand-off between the stages: one wave's requests, its (possibly
    still in flight) flattened features, and the conv-stage trace."""
    wave: int
    requests: list[CNNRequest]
    feats: torch.Tensor
    conv_trace: DispatchTrace


class CNNServer:
    """Admit single images, dispatch planner-sized micro-batches through
    the two-stage pipeline on ``device`` — the card unless the caller
    names another (``device="cpu"`` runs the kernels' plain versions).

    ``max_batch`` caps admission; the micro-batch is the planner's resident
    batch tile for the dominant FC layer under the engine's policy.
    ``pipeline`` selects the default :meth:`run` mode; logits are bitwise
    identical either way."""

    def __init__(self, net: str, params: list, *,
                 in_res: int | None = None, in_ch: int = 3,
                 width_mult: float = 1.0, max_batch: int = 64,
                 dtype=torch.float32,
                 pipeline: bool = True,
                 engine: Engine | None = None,
                 device=None) -> None:
        _, res0 = cnn.NETWORKS[net]
        self.device = resolve_device(device)
        self.net = net
        self.params = params
        self.in_res = in_res if in_res is not None else res0
        self.in_ch = in_ch
        self.width_mult = width_mult
        self.max_batch = max_batch
        self.dtype = dtype
        self.pipeline = pipeline
        self.engine = engine if engine is not None \
            else Engine(backend="kernels")
        self._planner_microbatch = self._preferred_microbatch()
        self.microbatch = self._planner_microbatch
        self.queue: list[CNNRequest] = []
        self.waves: list[WaveReport] = []
        self._wave_counter = 0
        self._uids: set = set()
        self._inflight: _StageBuffer | None = None

    @property
    def preferred_microbatch(self) -> int:
        """The planner's resident batch tile for this model's dominant FC
        layer — the wave size one streamed weight pass amortizes over."""
        return self._planner_microbatch

    # -- planning -----------------------------------------------------------
    def _fc_shapes(self) -> list[tuple[int, int, int]]:
        """(k, n, weight_bytes) of every FC layer, from the parameters;
        int8 weights report their 1-byte stream."""
        spec, _ = cnn.NETWORKS[self.net]
        out = []
        for s, p in zip(spec, self.params):
            if s.kind != "fc":
                continue
            w = p["w"]
            if isinstance(w, QTensor):
                out.append((*w.q.shape, 1))
            else:
                out.append((*w.shape, w.dtype.itemsize))
        return out

    def _preferred_microbatch(self) -> int:
        k, n, wb = max(self._fc_shapes(), key=lambda s: s[0] * s[1])
        plan = self.engine.policy.plan_fc(self.max_batch, n, k,
                                          act_bytes=self.dtype.itemsize,
                                          weight_bytes=wb, regime="sa_fc")
        return max(1, min(self.max_batch, plan.bb))

    def _stage_schedules(self, batch: int
                         ) -> tuple[LayerSchedule, LayerSchedule]:
        return LayerSchedule.compile_cnn_stages(
            self.net, batch=batch, in_res=self.in_res, in_ch=self.in_ch,
            width_mult=self.width_mult, dtype=self.dtype,
            policy=self.engine.policy, params=self.params)

    # -- serving ------------------------------------------------------------
    def submit(self, req: CNNRequest) -> None:
        """Admit one request.  Duplicate uids are rejected
        (``ValueError``): a uid names one request for the server's life."""
        shape = (self.in_res, self.in_res, self.in_ch)
        if tuple(req.image.shape) != shape:
            raise ValueError(f"request {req.uid}: image shape "
                             f"{tuple(req.image.shape)} != server {shape}")
        if req.uid in self._uids:
            raise ValueError(f"duplicate request uid {req.uid}: uids are "
                             "unique per server lifetime")
        self._uids.add(req.uid)
        self.queue.append(req)

    def _to_device(self, wave: list[CNNRequest]) -> torch.Tensor:
        """Stack a wave's images into one (N, H, W, C) batch on the device.
        On the card the copy leaves from pinned memory without blocking the
        host, so it queues behind the work already on the stream."""
        host = torch.from_numpy(np.stack([np.asarray(r.image) for r in wave])
                                ).to(self.dtype)
        if self.device.type == "cuda":
            return host.pin_memory().to(self.device, non_blocking=True)
        return host.to(self.device)

    def _conv_stage_dispatch(self, wave_idx: int,
                             wave: list[CNNRequest]) -> _StageBuffer:
        """Stage 1: enqueue one wave's conv stack; do not block."""
        x = self._to_device(wave)
        conv_sched, _ = self._stage_schedules(len(wave))
        eng = self.engine.with_schedule(conv_sched)
        with eng.tracing() as tr, eng.tagging(stage="conv", wave=wave_idx):
            feats = cnn.cnn_conv_stage(self.net, self.params, x, eng=eng)
        return _StageBuffer(wave_idx, list(wave), feats, tr)

    def _fc_stage_complete(self, buf: _StageBuffer) -> list[CNNRequest]:
        """Stage 2: run the classifier head on the buffered features, wait
        for the logits, deliver them and file the WaveReport."""
        _, fc_sched = self._stage_schedules(len(buf.requests))
        eng = self.engine.with_schedule(fc_sched)
        with eng.tracing() as tr, eng.tagging(stage="fc", wave=buf.wave):
            logits = cnn.cnn_fc_stage(self.net, self.params, buf.feats,
                                      eng=eng)
        logits = logits.cpu()                         # the pipeline barrier
        if logits.dtype == torch.bfloat16:
            # numpy has no bf16: deliver it widened to fp32, which is exact
            logits = logits.float()
        logits = logits.numpy()
        for i, r in enumerate(buf.requests):
            r.logits = logits[i]
            r.done = True
        combined = DispatchTrace()
        for rec in list(buf.conv_trace) + list(tr):
            combined.append(rec)
        self.waves.append(WaveReport(
            uids=tuple(r.uid for r in buf.requests),
            batch=len(buf.requests),
            schedule_hits=sum(r.schedule == "hit" for r in combined),
            trace=combined, wave=buf.wave,
            conv_trace=buf.conv_trace, fc_trace=tr))
        return buf.requests

    def step_wave(self) -> list[CNNRequest]:
        """Dispatch and complete ONE wave (both stages, blocking); returns
        its requests, ``[]`` on an empty queue.  An in-flight pipelined
        wave completes first.  A stage that raises pushes the wave's
        undelivered requests back to the head of the queue."""
        finished: list[CNNRequest] = []
        if self._inflight is not None:
            buf, self._inflight = self._inflight, None
            try:
                finished.extend(self._fc_stage_complete(buf))
            except Exception:
                self.queue[:0] = [r for r in buf.requests if not r.done]
                raise
        if not self.queue:
            return finished
        wave = self.queue[:self.microbatch]
        self.queue = self.queue[len(wave):]
        try:
            buf = self._conv_stage_dispatch(self._wave_counter, wave)
            self._wave_counter += 1
            finished.extend(self._fc_stage_complete(buf))
        except Exception:
            self.queue[:0] = [r for r in wave if not r.done]
            raise
        return finished

    def cancel(self, uids) -> list[CNNRequest]:
        """Remove still-queued requests by uid and return them (uids stay
        consumed); unknown or already-served uids are ignored."""
        uids = set(uids)
        cancelled = [r for r in self.queue if r.uid in uids]
        self.queue = [r for r in self.queue if r.uid not in uids]
        return cancelled

    def drain(self) -> list[CNNRequest]:
        """Complete the in-flight wave (if any), then serve everything
        still queued, including a final partial wave."""
        finished: list[CNNRequest] = []
        if self._inflight is not None:
            finished.extend(self._fc_stage_complete(self._inflight))
            self._inflight = None
        while self.queue:
            finished.extend(self.step_wave())
        return finished

    def run(self, *, pipelined: bool | None = None) -> list[CNNRequest]:
        """Drain the queue in planner-preferred micro-batches.  Pipelined
        (default, per ``self.pipeline``): wave *i+1*'s conv stage is
        enqueued BEFORE the host waits on wave *i*'s logits.  Sequential:
        each wave's two stages complete back to back."""
        pipelined = self.pipeline if pipelined is None else pipelined
        finished: list[CNNRequest] = []
        while self.queue:
            wave = self.queue[:self.microbatch]
            self.queue = self.queue[len(wave):]
            buf = self._conv_stage_dispatch(self._wave_counter, wave)
            self._wave_counter += 1
            if self._inflight is not None:
                finished.extend(self._fc_stage_complete(self._inflight))
            self._inflight = buf
            if not pipelined:
                finished.extend(self._fc_stage_complete(self._inflight))
                self._inflight = None
        finished.extend(self.drain())
        return finished
