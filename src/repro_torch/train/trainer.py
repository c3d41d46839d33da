"""Training loop: checkpoint/auto-resume and straggler detection — the
JAX package's ``repro.train.trainer`` on the port.

``run()`` resumes from the latest complete checkpoint (restart-idempotent),
saves every ``ckpt_every`` steps on a background thread and once at the
end (each step written once, the last write joined), and flags a step
whose wall time exceeds 3x the running median
(:class:`repro_torch.distributed.fault_tolerance.StepMonitor`).  A step's
wall time runs from drawing its batch to the host reading its loss, so it
covers the card's work and leaves out the checkpoint's host copy.
Checkpoints hold the trained leaves (no ``embed_t``), the AdamW state and
the compression state.
"""
from __future__ import annotations

import dataclasses
import time
from collections.abc import Callable

from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.engine import Engine
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.distributed.fault_tolerance import StepMonitor
from repro_torch.models import transformer as T
from repro_torch.train import train_step as ts


@dataclasses.dataclass
class TrainerReport:
    steps_run: int
    final_loss: float
    losses: list
    resumed_from: int | None
    straggler_steps: list
    step_seconds: list          # host clock of each step run


def run(cfg: ModelConfig, tc: TrainConfig, *,
        ckpt_dir: str | None = None,
        ckpt_every: int = 50,
        train_step_fn: Callable | None = None,
        state: tuple | None = None,
        data: SyntheticLM | None = None,
        log_every: int = 10,
        log: Callable[[str], None] = print,
        device=None,
        engine: Engine | None = None) -> TrainerReport:
    """Train ``tc.total_steps`` steps (from the latest checkpoint in
    ``ckpt_dir`` if there is one).  Without ``state`` the parameters are
    drawn from ``tc.seed`` on ``device`` (the card unless the caller names
    another); without ``train_step_fn`` the step runs on ``engine`` (the
    ``"kernels"`` backend by default)."""
    step_fn = train_step_fn or ts.make_train_step(cfg, tc, engine=engine)
    if data is None:
        data = SyntheticLM(DataConfig(cfg.vocab_size, tc.seq_len,
                                      tc.global_batch, seed=tc.seed), cfg)
    if state is None:
        state = ts.init_train_state(cfg, tc, tc.seed, device=device)
    params, opt_state, cstate = state
    del state                   # each step replaces the state it was given

    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    start_step, resumed_from = 0, None
    if ckpt and ckpt.latest_step() is not None:
        (tp, opt_state, cstate), start_step, _ = ckpt.restore(
            (T.trainable(params), opt_state, cstate))
        params = T.with_head_copy(cfg, tp)
        resumed_from = start_step
        log(f"[trainer] resumed from step {start_step}")

    monitor = StepMonitor()
    losses, stragglers, seconds = [], [], []
    for step in range(start_step, tc.total_steps):
        t0 = time.monotonic()
        batch = data.batch_at(step)          # stateless-resumable stream
        params, opt_state, cstate, metrics = step_fn(
            params, opt_state, cstate, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        dt = time.monotonic() - t0
        seconds.append(dt)
        if monitor.observe(step, dt) == "straggler":
            stragglers.append(step)
            log(f"[trainer] step {step}: straggler ({dt:.2f}s vs "
                f"median {monitor.median():.2f}s) — flagged for rebalance")

        if step % log_every == 0:
            log(f"[trainer] step {step} loss {loss:.4f} "
                f"lr {float(metrics['lr']):.2e} "
                f"gnorm {float(metrics['grad_norm']):.2f} ({dt:.2f}s)")
        if ckpt and (step + 1) % ckpt_every == 0:
            ckpt.save(step + 1, (T.trainable(params), opt_state, cstate),
                      extra={"loss": loss}, async_save=True)

    if ckpt:
        # a last step on ckpt_every was saved by the loop: join that write
        if start_step == tc.total_steps or tc.total_steps % ckpt_every:
            ckpt.save(tc.total_steps,
                      (T.trainable(params), opt_state, cstate),
                      extra={"loss": losses[-1] if losses else None})
        ckpt.wait()
    return TrainerReport(steps_run=max(0, tc.total_steps - start_step),
                         final_loss=losses[-1] if losses else float("nan"),
                         losses=losses, resumed_from=resumed_from,
                         straggler_steps=stragglers, step_seconds=seconds)
