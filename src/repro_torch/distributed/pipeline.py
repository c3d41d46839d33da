"""Pipeline parallelism: the GPipe schedule.

The JAX package runs a model's stages on the pods of its mesh (the
``pod`` axis), activations crossing pods by ``collective-permute`` and
microbatches filling the pipe.  On the port the stages are streams of one
card: stage ``s`` runs on its own CUDA stream, and the reference's forward
permute becomes an event that stage ``s`` records after each microbatch
and stage ``s + 1`` waits on before it takes that microbatch.  The slots
run in the schedule's time-major order, so while stage 1 runs microbatch
``m`` stage 0 may already run ``m + 1``.  On the CPU the same slots run
one after another.  The schedule and bubble arithmetic is
hardware-independent.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class PipeSchedule:
    stages: int
    microbatches: int

    @property
    def bubble_fraction(self) -> float:
        """GPipe bubble: (S-1)/(M+S-1)."""
        s, m = self.stages, self.microbatches
        return (s - 1) / (m + s - 1)

    def slots(self) -> list[list[tuple[int, int]]]:
        """Time-major schedule: slots()[t] = [(stage, microbatch), ...]."""
        s, m = self.stages, self.microbatches
        out = []
        for t in range(m + s - 1):
            row = []
            for stage in range(s):
                mb = t - stage
                if 0 <= mb < m:
                    row.append((stage, mb))
            out.append(row)
        return out


def pipelined_forward(stage_fns: Sequence[Callable], x_mb, *,
                      device=None) -> torch.Tensor:
    """GPipe forward of ``x_mb`` (microbatches leading: a tensor (M, ...)
    or a sequence of M tensors) through ``stage_fns``, stage ``s``
    applying ``stage_fns[s]`` to stage ``s - 1``'s output.

    Returns the last stage's outputs stacked in microbatch order (what the
    reference's last ``"pod"`` shard holds).  On a CUDA device (``x_mb``'s,
    unless ``device`` names one) each stage runs on its own stream; the
    caller's stream waits for every stage before the result is used.
    Stages may change the shape (tokens in, logits out)."""
    mbs = list(x_mb)
    n_stages = len(stage_fns)
    if not mbs or not n_stages:
        raise ValueError("pipelined_forward needs a stage and a microbatch")
    dev = torch.device(device) if device is not None else mbs[0].device
    sched = PipeSchedule(n_stages, len(mbs))
    carry: dict[tuple[int, int], torch.Tensor] = {}
    outs: list[torch.Tensor | None] = [None] * len(mbs)

    if dev.type != "cuda":
        for row in sched.slots():
            for stage, mb in row:
                x = mbs[mb] if stage == 0 else carry.pop((stage - 1, mb))
                y = stage_fns[stage](x)
                if stage == n_stages - 1:
                    outs[mb] = y
                else:
                    carry[(stage, mb)] = y
        return torch.stack(outs)

    caller = torch.cuda.current_stream(dev)
    streams = [torch.cuda.Stream(dev) for _ in range(n_stages)]
    ready = torch.cuda.Event()
    ready.record(caller)                       # x_mb is written on caller
    done: dict[tuple[int, int], torch.cuda.Event] = {}
    for row in sched.slots():
        for stage, mb in row:
            st = streams[stage]
            with torch.cuda.stream(st):
                if stage == 0:
                    st.wait_event(ready)
                    x = mbs[mb]
                else:
                    st.wait_event(done.pop((stage - 1, mb)))
                    x = carry.pop((stage - 1, mb))
                x.record_stream(st)            # made on another stream
                y = stage_fns[stage](x)
                ev = torch.cuda.Event()
                ev.record(st)
                done[(stage, mb)] = ev
            if stage == n_stages - 1:
                outs[mb] = y
            else:
                carry[(stage, mb)] = y
    for st in streams:
        caller.wait_stream(st)
    for y in outs:
        y.record_stream(caller)
    return torch.stack(outs)


def lm_stages(cfg, params: dict, n_stages: int) -> list[Callable]:
    """A decoder-only LM's forward (``T.forward``'s logits, mode
    ``"train"``) cut into ``n_stages`` callables over equal runs of its
    stacked periods, each running ``T.stack_apply`` over its slice of
    ``params["blocks"]``: stage 0 takes the tokens (B, S) and embeds them
    (``T.embed_inputs``), the last stage also runs the unstacked tail and
    returns the fp32 logits (B, S, V) (``T.output_logits``); between them
    the hidden state (B, S, d) passes.  The MoE auxiliary loss is not
    passed on (the logits do not depend on it).  Each stage runs under the
    caller's engine."""
    from repro_torch.core import tree
    from repro_torch.models import transformer as T
    if cfg.enc_dec or cfg.vision_tokens:
        raise ValueError(f"{cfg.name}: lm_stages cuts decoder-only stacks")
    reps, _ = cfg.stack_shape()
    if n_stages < 1 or reps % n_stages:
        raise ValueError(f"{cfg.name}: {reps} periods do not split into "
                         f"{n_stages} stages")
    per = reps // n_stages

    def stage_fn(s: int) -> Callable:
        last = s == n_stages - 1
        p = {**params, "tail": params["tail"] if last else [],
             "blocks": tree.map_leaves(lambda t: t[s * per:(s + 1) * per],
                                       params["blocks"])}

        def fn(x: torch.Tensor) -> torch.Tensor:
            if s == 0:
                x, _ = T.embed_inputs(cfg, p, {"tokens": x})
            pos_ids = torch.arange(x.shape[1], device=x.device)[None, :]
            x, _, _ = T.stack_apply(cfg, p, x, pos_ids, mode="train")
            return T.output_logits(cfg, p, x) if last else x
        return fn

    return [stage_fn(s) for s in range(n_stages)]
