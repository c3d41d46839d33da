"""Three train steps of the encoder-decoder and vision-prefix families on
the port against the JAX package's jitted XLA steps, on the CPU: reduced
llava-next-34b and seamless-m4t-large-v2 through ``make_train_step``, with
and without microbatches (the reference trains seamless through the
gradient of its loss followed by ``adamw.apply``); configured as in
``tests/test_torch_train_encdec.py`` (whose file would pass ~40 s on one
worker with these in it).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.models import transformer as RT
from repro.optim import adamw as radamw
from repro.optim import grad_compress as rgc
from repro.train import train_step as RTS
from repro_torch.configs import base as tbase
from repro_torch.core import tree
from repro_torch.models import transformer as T
from repro_torch.optim import adamw, grad_compress
from repro_torch.train import train_step as TS
from test_torch_train_encdec import (KERNELS, LLAVA, SEAMLESS, port_batch,
                                     ref_batches, setup)

#: three steps' losses, port against reference (tests/test_torch_train.py)
STEP_TOL = 1e-4
STEPS = 3
TC = dict(global_batch=4, seq_len=32, total_steps=STEPS, lr=3e-3,
          warmup_steps=1, remat="block")


def _ref_state(params, rtc):
    return (params, radamw.init(params, rtc), rgc.CompressState(
        error=jax.tree.map(lambda p: jnp.zeros((), jnp.float32), params)))


def _port_state(tp, ttc):
    tr = T.trainable(tp)
    return (tp, adamw.init(tr, ttc), grad_compress.CompressState(
        error=tree.map_leaves(lambda p: torch.zeros(()), tr)))


def _compare(got: list, want: list) -> None:
    np.testing.assert_allclose(got, want, rtol=0, atol=STEP_TOL)
    assert got[-1] < got[0] and want[-1] < want[0]


@pytest.mark.parametrize("microbatch", [0, 2])
def test_llava_train_steps_match_reference(microbatch):
    """From the same weights and the reference's batches (tokens and vision
    embeddings), three steps of ``make_train_step`` (kernels backend, remat
    by block, AdamW) follow the reference's jitted ``make_train_step``
    within 1e-4 of loss, with and without microbatches, and the loss
    falls."""
    rcfg, tcfg, rp, tp = setup(LLAVA)
    batches = ref_batches(rcfg, STEPS, b=TC["global_batch"],
                         s=TC["seq_len"])
    rtc = rbase.TrainConfig(**TC, microbatch=microbatch)
    step = jax.jit(RTS.make_train_step(rcfg, rtc))
    state, want = _ref_state(rp, rtc), []
    for b in batches:
        *state, m = step(*state, {k: jnp.asarray(v) for k, v in b.items()})
        want.append(float(m["loss"]))
    ttc = tbase.TrainConfig(**TC, microbatch=microbatch)
    tstep = TS.make_train_step(tcfg, ttc, engine=KERNELS)
    tstate, got = _port_state(tp, ttc), []
    for b in batches:
        *tstate, m = tstep(*tstate, port_batch(b))
        got.append(float(m["loss"]))
    _compare(got, want)


@pytest.mark.parametrize("microbatch", [0, 2])
def test_seamless_train_steps_match_reference(microbatch):
    """Three steps of ``make_train_step`` (no schedule attached) follow the
    step the reference trains seamless by, its jitted
    ``jax.value_and_grad(loss_fn)`` and ``adamw.apply`` (its
    ``make_train_step`` cannot compile an enc-dec schedule), within 1e-4
    of loss, with and without microbatches (against the reference's full
    batch: the same gradient), and the loss falls."""
    rcfg, tcfg, rp, tp = setup(SEAMLESS)
    batches = ref_batches(rcfg, STEPS, b=TC["global_batch"],
                          s=TC["seq_len"])
    rtc = rbase.TrainConfig(**TC)

    @jax.jit
    def step(params, opt, batch):
        (loss, _), g = jax.value_and_grad(
            lambda p: RT.loss_fn(rcfg, p, batch, remat=rtc.remat),
            has_aux=True)(params)
        params, opt, _ = radamw.apply(params, g, opt, rtc)
        return params, opt, loss

    params, opt, _ = _ref_state(rp, rtc)
    want = []
    for b in batches:
        params, opt, loss = step(params, opt,
                                 {k: jnp.asarray(v) for k, v in b.items()})
        want.append(float(loss))
    ttc = tbase.TrainConfig(**TC, microbatch=microbatch)
    tstep = TS.make_train_step(tcfg, ttc, engine=KERNELS)
    tstate, got = _port_state(tp, ttc), []
    for b in batches:
        *tstate, m = tstep(*tstate, port_batch(b))
        got.append(float(m["loss"]))
    _compare(got, want)
