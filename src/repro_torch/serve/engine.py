"""Batched LM serving engine of the port — the JAX package's
``repro.serve.engine`` run eagerly on the card.

Requests queue up; each admission wave takes up to ``batch_size`` requests
of equal prompt length, prefills them together and decodes them in lock
step.  Prefill projections are matmuls with m = wave x prompt rows (the
SA-CONV GEMM once m is large), decode projections have m = wave (the SA-FC
weight stream): the batching policy keeps decode's weight reuse up.

Every phase runs under a compiled, memoized
:class:`~repro_torch.core.schedule.LayerSchedule` for its (phase, batch,
prompt length), so every named matmul resolves by lookup.  The reference
jit-compiles its steps and records dispatches once per trace; the port
records every call.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import Engine
from repro_torch.core.schedule import LayerSchedule
from repro_torch.serve.serve_step import decode_step, prefill_step


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (S,) integer tokens
    max_new: int = 16
    done: bool = False
    output: np.ndarray | None = None
    #: (max_new, vocab) fp32: the logits each output token was taken from
    logits: np.ndarray | None = None


class ServeEngine:
    """Serve ``cfg`` with ``params`` on the device the parameters lie on.

    The default ``engine`` is ``Engine(backend="kernels")``, where the
    reference defaults to its XLA backend: the port's entry points run its
    kernels (on CPU tensors the kernel wrappers run their plain versions).
    Requests are tokens only: encoder-decoder and vision configs, whose
    requests carry frontend embeddings, are served by
    :func:`~repro_torch.serve.serve_step.greedy_generate` and refused here.
    """

    def __init__(self, cfg: ModelConfig, params: dict, *,
                 batch_size: int = 4, max_seq: int = 256,
                 cache_dtype=torch.float32, engine: Engine | None = None):
        if cfg.enc_dec or cfg.vision_tokens:
            raise NotImplementedError(
                f"{cfg.name}: ServeEngine takes tokens only; serve "
                "encoder-decoder and vision configs with their frontend "
                "inputs through repro_torch.serve.serve_step."
                "greedy_generate(..., extra=...)")
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.batch_size = batch_size
        self.max_seq = max_seq
        self.cache_dtype = cache_dtype
        self.engine = engine if engine is not None else \
            Engine(backend="kernels")
        # the per-phase offline schedule for the configured batch size;
        # odd-sized admission waves compile (memoized) variants on demand
        self.decode_schedule = self._schedule("decode", batch_size)
        self.queue: list[Request] = []

    def _schedule(self, phase: str, batch: int,
                  seq: int = 1) -> LayerSchedule:
        return LayerSchedule.compile(
            self.cfg, phase, batch=batch, seq=seq, max_seq=self.max_seq,
            cache_dtype=self.cache_dtype, policy=self.engine.policy,
            params=self.params)

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit_wave(self) -> list[Request]:
        """Admit up to batch_size requests of EQUAL prompt length (padding
        a causal LM's prompt changes its content)."""
        want = len(self.queue[0].prompt)
        wave, rest = [], []
        for r in self.queue:
            if len(r.prompt) == want and len(wave) < self.batch_size:
                wave.append(r)
            else:
                rest.append(r)
        self.queue = rest
        return wave

    @torch.no_grad()
    def run(self) -> list[Request]:
        """Drain the queue; returns completed requests."""
        finished: list[Request] = []
        while self.queue:
            wave = self._admit_wave()
            B = len(wave)
            S = max(len(r.prompt) for r in wave)
            toks = np.zeros((B, S), np.int64)
            for i, r in enumerate(wave):
                toks[i, S - len(r.prompt):] = r.prompt
            psched = self._schedule("prefill", B, S)
            with self.engine.with_schedule(psched).activate():
                logits, cache = prefill_step(
                    self.cfg, self.params,
                    {"tokens": torch.from_numpy(toks).to(self.device)},
                    self.max_seq, self.cache_dtype)
            n_steps = max(r.max_new for r in wave)
            outs = np.zeros((B, n_steps), np.int32)
            kept = np.zeros((B, n_steps, logits.shape[-1]), np.float32)
            tok = logits.argmax(-1)[:, None]
            outs[:, 0] = tok[:, 0].cpu().numpy()
            kept[:, 0] = logits.cpu().numpy()
            dsched = (self.decode_schedule if B == self.batch_size
                      else self._schedule("decode", B))
            with self.engine.with_schedule(dsched).activate():
                for i in range(1, n_steps):
                    logits, cache = decode_step(self.cfg, self.params, cache,
                                                tok, S + i - 1)
                    tok = logits.argmax(-1)[:, None]
                    outs[:, i] = tok[:, 0].cpu().numpy()
                    kept[:, i] = logits.cpu().numpy()
            for i, r in enumerate(wave):
                r.output = outs[i, :r.max_new]
                r.logits = kept[i, :r.max_new]
                r.done = True
                finished.append(r)
        return finished
