"""The port's GPipe schedule (``repro_torch.distributed.pipeline``) against
the JAX package's: ``PipeSchedule`` field for field, ``pipelined_forward``
against the reference's last ``"pod"`` shard (two host devices, in a
subprocess so the device count stays out of this process's jax), and on
the CPU bitwise the sequential composition of its stages, an LM's stages
(``lm_stages``) bitwise its unpipelined forward."""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.distributed.pipeline import PipeSchedule as RPipe
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.distributed.pipeline import (PipeSchedule,
                                              lm_stages, pipelined_forward)
from repro_torch.models import transformer as T

ROOT = Path(__file__).resolve().parents[1]

REF_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.distributed.pipeline import pipelined_forward
    w = np.load(sys.argv[1])
    W0, W1, x = (jnp.asarray(w[k]) for k in ("w0", "w1", "x"))
    fns = [lambda h: jnp.tanh(h @ W0), lambda h: jnp.tanh(h @ W1) * 2.0]
    # jax.make_mesh's Explicit axes refuse the reference's ppermute
    mesh = Mesh(np.array(jax.devices()), ("pod",))
    f = jax.shard_map(lambda xm: pipelined_forward(fns, xm, "pod"),
                      mesh=mesh, in_specs=P(), out_specs=P("pod"),
                      check_vma=False)
    out = np.asarray(f(x))
    np.save(sys.argv[2], out[out.shape[0] // 2:])    # the last pod's
""")


@pytest.mark.parametrize("stages,micro", [(1, 1), (2, 4), (3, 2), (4, 8),
                                          (2, 1), (5, 3)])
def test_pipe_schedule_equals_reference(stages, micro):
    t, r = PipeSchedule(stages, micro), RPipe(stages, micro)
    assert t.bubble_fraction == r.bubble_fraction
    assert t.slots() == r.slots()
    flat = [s for row in t.slots() for s in row]
    assert sorted(flat) == [(s, m) for s in range(stages)
                            for m in range(micro)]
    assert PipeSchedule(2, 4).bubble_fraction == 0.2


def test_pipelined_forward_equals_reference_last_pod(tmp_path):
    """Two tanh stages over 4 microbatches: the port's result against the
    reference's ``pipelined_forward`` inside ``shard_map`` over a 2-device
    ``"pod"`` mesh, last shard, within 1e-6 (fp32; the products sum in
    another library's order)."""
    rng = np.random.default_rng(0)
    w = {"w0": (rng.standard_normal((8, 8)) * 0.3).astype(np.float32),
         "w1": (rng.standard_normal((8, 8)) * 0.3).astype(np.float32),
         "x": rng.standard_normal((4, 3, 8)).astype(np.float32)}
    np.savez(tmp_path / "w.npz", **w)
    script = tmp_path / "ref.py"
    script.write_text(REF_SCRIPT)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    subprocess.run([sys.executable, str(script), str(tmp_path / "w.npz"),
                    str(tmp_path / "out.npy")], check=True, env=env,
                   timeout=300)
    want = np.load(tmp_path / "out.npy")
    W0, W1 = torch.from_numpy(w["w0"]), torch.from_numpy(w["w1"])
    got = pipelined_forward([lambda h: torch.tanh(h @ W0),
                             lambda h: torch.tanh(h @ W1) * 2.0],
                            torch.from_numpy(w["x"]))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_pipelined_forward_is_the_sequential_composition():
    """On the CPU the slots run in order: bitwise the stages applied one
    after another to each microbatch, for stages that change the shape;
    a sequence of microbatches works as a stacked tensor does."""
    gen = torch.Generator().manual_seed(1)
    ws = [torch.randn((6, 5), generator=gen), torch.randn((5, 7),
                                                          generator=gen),
          torch.randn((7, 2), generator=gen)]
    fns = [lambda h, w=w: torch.relu(h @ w) for w in ws]
    x = torch.randn((5, 4, 6), generator=gen)
    want = torch.stack([fns[2](fns[1](fns[0](m))) for m in x])
    assert torch.equal(pipelined_forward(fns, x), want)
    assert torch.equal(pipelined_forward(fns, list(x)), want)
    with pytest.raises(ValueError):
        pipelined_forward([], x)


def test_lm_stages_bitwise_the_forward():
    """A reduced OLMo (4 layers) in 2 stages of 2 blocks, 4 microbatches of
    one sequence: bitwise the unpipelined forward of the whole wave (every
    kernel keeps batched == unbatched), on both backends."""
    from repro_torch.core.engine import Engine
    cfg = reduced(get_config("olmo-1b"), n_layers=4)
    p = T.init_params(cfg, 0, device="cpu")
    tok = torch.randint(0, cfg.vocab_size, (4, 16),
                        generator=torch.Generator().manual_seed(2))
    for backend in ("torch", "kernels"):
        with torch.no_grad(), Engine(backend=backend).activate():
            want = T.forward(cfg, p, {"tokens": tok})[0]
            got = pipelined_forward(lm_stages(cfg, p, 2), tok[:, None])
        assert torch.equal(got[:, 0], want)
    with pytest.raises(ValueError):
        lm_stages(cfg, p, 3)


@pytest.mark.parametrize("arch,n_layers,quant", [
    ("mixtral-8x7b", 4, False), ("gemma2-27b", 5, False),
    ("zamba2-2.7b", 14, False), ("mamba2-130m", 2, False),
    ("olmo-1b", 4, True)])
def test_lm_stages_bitwise_the_forward_of_every_family(arch, n_layers, quant):
    """The stages run the model's own ``stack_apply`` over their slice of
    the stacked blocks, so every decoder-only family pipelines bitwise its
    forward: MoE (routing per microbatch: capacity ample enough to keep
    every token, so one sequence routes as it does in the wave), gemma's
    scaled embedding and pattern period with an unstacked tail block,
    zamba2's shared attention with its tail, Mamba2, and an int8 tree."""
    import dataclasses
    from repro_torch.core.engine import Engine
    from repro_torch.core.quant import quantize_params
    cfg = reduced(get_config(arch), n_layers=n_layers)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=4.0))
    p = T.init_params(cfg, 0, device="cpu")
    if quant:
        p = quantize_params(p)
    tok = torch.randint(0, cfg.vocab_size, (2, 16),
                        generator=torch.Generator().manual_seed(3))
    with torch.no_grad(), Engine(backend="kernels").activate():
        want = T.forward(cfg, p, {"tokens": tok})[0]
        got = pipelined_forward(lm_stages(cfg, p, 2), tok[:, None])
    assert torch.equal(got[:, 0], want)
