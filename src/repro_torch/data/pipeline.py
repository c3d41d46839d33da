"""Deterministic, stateless-resumable synthetic data — the JAX package's
``repro.data.pipeline`` for the port.

Every batch is a pure function of (seed, step, shard), so a restarted job
reproduces its token stream with no iterator state in the checkpoint.
Tokens follow the reference's Zipf-like marginal (p(t) proportional to
(t + 1)^(-1/1.2)) and its learnable structure: every odd position repeats
``(prev * 2 + 1) mod V`` of the token before it.

The draws come from a ``torch.Generator`` seeded from (seed, step, shard),
not from ``jax.random``, so the port's tokens are not the reference's:
tests that compare the two packages feed the reference's batches to both.
A vision config's batches also carry ``vision_embeds`` (B, vision_tokens,
frontend_dim) and an encoder-decoder config's ``audio_embeds`` (B,
audio_frames, frontend_dim): the stubbed frontends' embeddings, fp32
standard normals drawn from the step's generator after the tokens.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1            # data-parallel host shards
    shard: int = 0


def zipf_probs(vocab: int) -> torch.Tensor:
    """The token marginal, fp64 then normalised, as the reference's."""
    probs = np.exp(-np.log(np.arange(1, vocab + 1, dtype=np.float64)) / 1.2)
    return torch.from_numpy(probs / probs.sum())


class SyntheticLM:
    """``batch_at(step) -> {"tokens": (local_batch, seq) int64}`` on the
    CPU, plus the frontend embeddings of ``cfg`` where it has them,
    deterministic in (seed, step, shard)."""

    def __init__(self, dc: DataConfig, cfg: ModelConfig | None = None):
        if dc.global_batch % dc.n_shards:
            raise ValueError(f"global_batch {dc.global_batch} does not "
                             f"split into {dc.n_shards} shards")
        self.dc = dc
        self.cfg = cfg
        self.local_batch = dc.global_batch // dc.n_shards
        self._probs = zipf_probs(dc.vocab_size)

    def _generator(self, step: int) -> torch.Generator:
        """The generator of one step's batch on this shard."""
        seed = np.random.SeedSequence(
            [self.dc.seed, step, self.dc.shard]).generate_state(
                1, dtype=np.uint64)[0]
        return torch.Generator().manual_seed(int(seed) >> 1)

    def batch_at(self, step: int) -> dict:
        dc = self.dc
        gen = self._generator(step)
        base = torch.multinomial(self._probs, self.local_batch * dc.seq_len,
                                 replacement=True, generator=gen).reshape(
            self.local_batch, dc.seq_len)
        odd = (torch.arange(dc.seq_len) % 2 == 1)[None, :]
        prev = torch.roll(base, 1, dims=1)
        batch = {"tokens": torch.where(odd, (prev * 2 + 1) % dc.vocab_size,
                                       base)}
        cfg = self.cfg
        if cfg is not None and cfg.vision_tokens:
            batch["vision_embeds"] = torch.randn(
                (self.local_batch, cfg.vision_tokens, cfg.frontend_dim),
                generator=gen, dtype=torch.float32)
        if cfg is not None and cfg.enc_dec:
            batch["audio_embeds"] = torch.randn(
                (self.local_batch, cfg.audio_frames, cfg.frontend_dim),
                generator=gen, dtype=torch.float32)
        return batch

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
