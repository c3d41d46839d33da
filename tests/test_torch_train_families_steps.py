"""Five train steps of the decoder-only families on the port against the
JAX package's jitted XLA steps, on the CPU: reduced mixtral-8x7b,
llama4-maverick (without and with its shared expert), mamba2-130m and
zamba2-2.7b, configured as in ``tests/test_torch_train_families.py``
(whose file would pass a minute on one worker with these in it).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.data import pipeline as rdata
from repro.optim import adamw as radamw
from repro.optim import grad_compress as rgc
from repro.train import train_step as RTS
from repro_torch.configs import base as tbase
from repro_torch.core import tree
from repro_torch.core.engine import Engine
from repro_torch.models import transformer as T
from repro_torch.optim import adamw, grad_compress
from repro_torch.train import train_step as TS
from test_torch_train_families import CONFIGS, SPREAD, _nudged, setup

#: five steps' losses, port against reference (tests/test_torch_train.py)
STEP_TOL = 1e-4


@pytest.mark.parametrize("name", CONFIGS)
def test_five_train_steps_match_reference(name, record_testsuite_property):
    """From the same weights and the reference's batches, five steps of the
    port (kernels backend, remat by block, AdamW, the loss with the MoE
    ``aux``) follow the reference's jitted XLA steps within 1e-4 of loss,
    and the loss falls.  A step of an SSM stack may miss 1e-4 only where
    the reference's own loss moves by more than 1e-4 when its embedding
    moves by an ulp, and then lies within SPREAD times that move (reduced
    zamba2 is chaotic under AdamW: such a nudge moves its fifth loss by
    up to ~0.3); the steps that needed it go to the JUnit report."""
    rcfg, tcfg, rp, tp = setup(name)
    tc = dict(global_batch=4, seq_len=32, total_steps=5, lr=3e-3,
              warmup_steps=2, remat="block")
    batches = [rdata.SyntheticLM(rdata.DataConfig(
        rcfg.vocab_size, 32, 4, seed=1), rcfg).batch_at(s) for s in range(5)]

    rtc = rbase.TrainConfig(**tc)
    step = jax.jit(RTS.make_train_step(rcfg, rtc))

    def ref_losses(params) -> np.ndarray:
        opt = radamw.init(params, rtc)
        cs = rgc.CompressState(error=jax.tree.map(
            lambda p: jnp.zeros((), jnp.float32), params))
        out = []
        for b in batches:
            params, opt, cs, m = step(params, opt, cs, b)
            out.append(float(m["loss"]))
        return np.array(out)

    want = ref_losses(rp)
    ttc = tbase.TrainConfig(**tc)
    tstep = TS.make_train_step(tcfg, ttc, engine=Engine(backend="kernels"))
    tr = T.trainable(tp)
    topt = adamw.init(tr, ttc)
    tcs = grad_compress.CompressState(error=tree.map_leaves(
        lambda p: torch.zeros(()), tr))
    got = []
    for b in batches:
        tp, topt, tcs, m = tstep(tp, topt, tcs, {
            k: torch.from_numpy(np.array(v)) for k, v in b.items()})
        got.append(float(m["loss"]))
    diff = np.abs(np.array(got) - want)
    fell_back = []
    if (diff > STEP_TOL).any():
        # an SSM stack's steps may miss STEP_TOL only where the reference's
        # own losses move by more under a one-ulp nudge of the embedding
        # (the rule of _match in tests/test_torch_train_families.py)
        assert tcfg.ssm is not None, (got, want)
        move = np.max([np.abs(ref_losses(_nudged(rp, seed)) - want)
                       for seed in (1, 2)], axis=0)
        for i in np.flatnonzero(diff > STEP_TOL):
            assert move[i] > STEP_TOL and diff[i] <= SPREAD * move[i], \
                (i, got, want, move)
            fell_back.append(int(i))
    record_testsuite_property(f"{name}.steps_fallback", fell_back)
    assert want[-1] < want[0] and got[-1] < got[0]
