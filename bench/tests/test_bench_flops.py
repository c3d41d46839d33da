"""The benchmark's own operation counts against the program's: VGG-16's
layer table (``models/cnn.py::network_stats``) and a reduced OLMo's matrix
products as the dry run counts them (``launch/dryrun.py``).  The tests may
read the program; ``bench/flops.py`` does not."""
from __future__ import annotations

import dataclasses

import pytest
import torch
from conftest import ROOT, small

from bench import flops, harness


def test_vgg16_layer_table():
    from repro_torch.models import cnn
    spec = harness.benchmark(ROOT)
    cfg = harness.config(spec, "vgg16-fp32", ROOT)
    stats = cnn.network_stats("vgg16")
    conv = sum(s.macs for s in stats if s.kind == "conv")
    fc = sum(s.macs for s in stats if s.kind == "fc")
    assert flops.conv_flops(cfg) == 2 * conv == 2 * 15_346_630_656
    assert flops.fc_flops(cfg) == 2 * fc == 2 * 123_633_664
    convs, fcs = flops.cnn_layers(cfg)
    assert [(c["h"], c["ci"], c["co"]) for c in convs] == \
        [(s.ifm[0], s.ifm[2], s.ofm[2]) for s in stats if s.kind == "conv"]
    assert [(f["fan_in"], f["fan_out"]) for f in fcs] == \
        [(s.ifm[2], s.ofm[2]) for s in stats if s.kind == "fc"]
    # a 64-image wave: bounded by its operations at fp32's peak but for
    # conv1_1, whose 822 MB output map outweighs its 11 GFLOP
    ops_s = 64 * 2 * conv / 67e12
    c11 = 64 * 224 * 224 * 2 * 27 * 64 / 67e12
    c11_bytes = 4 * (64 * 224 * 224 * (3 + 64) + 27 * 64 + 64) / 3.35e12
    assert flops.conv_bound_s(cfg, 64) == pytest.approx(
        ops_s - c11 + c11_bytes, rel=1e-9)
    # the head at b = 1 is bounded by its weight stream
    assert flops.fc_bound_s(cfg, 1) == pytest.approx(
        4 * (fc + 4096 + 4096 + 1000 + 25088 + 4 * 4096 + 1000)
        / 3.35e12, rel=1e-9)


def test_olmo_matmul_operations_equal_the_dry_runs():
    """A reduced OLMo's train step on one chip of the dry run, remat off:
    its matmul kernel calls in the forward, ``dx`` and ``dw`` roles (``pre``
    is a recompute) count 6 operations per weight per token."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import dryrun as D
    drv = harness.driver("lm_train")
    cfg, wl = small("olmo-1b-bf16.train")
    mc = drv.model_config(cfg)
    seq, batch = 32, 4
    mesh = SH.AbstractMesh((1, 1), ("data", "model"))
    tc = dataclasses.replace(drv.train_config(cfg, wl), global_batch=batch,
                             seq_len=seq, remat="none")
    with torch.enable_grad():
        tr = D.trace_train(mc, ShapeConfig("t", seq, batch, "train"), mesh,
                           tc=tc)
    got = sum(c.flops for c in tr.count.calls
              if c.kernel.endswith("_matmul") and c.role != "pre")
    assert got == flops.lm_train_matmul_flops(cfg["model"], seq * batch)
    assert flops.lm_matmul_params(cfg["model"]) == mc.n_params()


def test_published_olmo_parameters():
    from repro_torch.configs.registry import get_config
    spec = harness.benchmark(ROOT)
    m = harness.config(spec, "olmo-1b-bf16", ROOT)["model"]
    assert flops.lm_matmul_params(m) == get_config("olmo-1b").n_params()
    assert flops.lm_train_flops(m, 8192, 2048) == pytest.approx(
        8192 * (6 * 1_176_764_416 + 12 * 16 * 2048 * 2048))
