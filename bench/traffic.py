"""The one traffic generator: every mix is a set of parameters in a cell's
file (``bench/workloads/<cell>.json``, key ``traffic_params``), and every
draw is a pure function of the run's ``--seed``.

* ``open``: an open loop of single-image arrivals at ``rate_per_s`` over
  the window.  Each seed gets the same set of gaps between arrivals, the
  exact quantiles of the exponential law at that rate (``"poisson"``), in
  an order drawn from the seed, so the work of a window does not depend
  on the seed; the images are drawn from the seed.
* ``closed``: callers that each wait for their reply: requests in chunks
  that the next chunk waits on, cycling through the image pool.
* token batches for training: a copy of ``repro_torch.data.pipeline``'s
  rule (a Zipf-like marginal, every odd position ``(prev * 2 + 1) mod V``),
  drawn from (seed, step).
"""
from __future__ import annotations

import math

import numpy as np


def seed_of(seed: int, *parts) -> int:
    """A 63-bit generator seed from the run's seed and labels (any whole
    number; a label may be a string)."""
    s = int(seed)
    words = [abs(s) % 2**64, abs(s) >> 64, int(s < 0)]
    for p in parts:
        words += list(str(p).encode()) if isinstance(p, str) else [int(p)]
    return int(np.random.SeedSequence(words).generate_state(
        1, dtype=np.uint64)[0]) >> 1


def open_loop(params: dict, seed: int, seconds: float
              ) -> tuple[np.ndarray, np.ndarray]:
    """(due times in seconds from the window's start, ascending; image
    index of each) of an open loop over ``seconds``."""
    rate = float(params["rate_per_s"])
    n = max(1, round(rate * seconds))
    if params.get("arrivals", "poisson") != "poisson":
        raise ValueError(f"unknown arrivals {params['arrivals']!r}")
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate                 # exponential quantiles
    rng = np.random.default_rng(seed_of(seed, "open-loop"))
    gaps = gaps[rng.permutation(n)]
    due = np.cumsum(gaps) - gaps[0]             # the first is due at 0
    images = rng.integers(0, int(params["image_pool"]), size=n)
    return due, images


def closed_loop_images(params: dict, start: int, count: int) -> np.ndarray:
    """Image indices of requests ``start .. start + count - 1`` of a closed
    loop: the pool in order, again and again."""
    return (np.arange(start, start + count) % int(params["image_pool"]))


def zipf_probs(vocab: int) -> np.ndarray:
    p = np.exp(-np.log(np.arange(1, vocab + 1, dtype=np.float64)) / 1.2)
    return p / p.sum()


def lm_batch(seed: int, step: int, vocab: int, batch: int, seq: int):
    """(batch, seq) int64 tokens of one train step, a CPU tensor."""
    import torch
    gen = torch.Generator().manual_seed(seed_of(seed, "tokens", step))
    probs = torch.from_numpy(zipf_probs(vocab))
    base = torch.multinomial(probs, batch * seq, replacement=True,
                             generator=gen).reshape(batch, seq)
    odd = (torch.arange(seq) % 2 == 1)[None, :]
    prev = torch.roll(base, 1, dims=1)
    return torch.where(odd, (prev * 2 + 1) % vocab, base)


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between
    order statistics (numpy's default)."""
    if len(values) == 0:
        return math.nan
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))
