"""The plain references (``bench/reference/``) against the port's own plain
path on the CPU at reduced sizes: VGG-16's logits against
``models/cnn.py::cnn_forward`` on the ``"torch"`` backend, OLMo's loss,
gradients and AdamW steps against the port's ``loss_fn`` and train step in
fp32.  The tests read the program; the references do not."""
from __future__ import annotations

import copy

import torch
from conftest import small

from bench import harness, traffic
from bench.reference import olmo as ref_olmo
from bench.reference import vgg as ref_vgg


def test_vgg_reference_equals_the_ports_forward():
    from repro_torch.core.engine import Engine
    from repro_torch.models import cnn
    drv = harness.driver("cnn_serve")
    cfg, _ = small("vgg16-fp32.offline")
    layers = drv.make_weights(cfg, 11, "cpu")
    shapes = [s for k, s in cnn.param_shapes(
        "vgg16", in_res=cfg["in_res"], width_mult=cfg["width_mult"])]
    assert [tuple(p.get("f", p.get("w")).shape) if p else () for p in layers] \
        == [tuple(s) for s in shapes]
    x = torch.from_numpy(drv.make_images(cfg, 6, 11, "cpu"))
    want = cnn.cnn_forward("vgg16", layers, x, eng=Engine(backend="torch"))
    got = ref_vgg.forward(cfg, layers, x)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5 * want.abs().max())
    ctl = ref_vgg.forward(cfg, layers, x, control=True)
    assert (ctl - got).abs().max() > 1e-5 * got.abs().max()


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11 + 2 ** -12, -3.0])
    assert ref_vgg.round_tf32(x).tolist() == [1.0 + 2 ** -10,
                                              1.0 + 2 ** -10, -3.0]


def _fp32(cfg):
    cfg = copy.deepcopy(cfg)
    cfg["model"].update(param_dtype="float32", compute_dtype="float32")
    return cfg


def test_olmo_reference_loss_and_gradients_equal_the_ports():
    from repro_torch.core import tree
    from repro_torch.core.engine import Engine
    from repro_torch.models import transformer as T
    from repro_torch.train import train_step as TS
    drv = harness.driver("lm_train")
    cfg, wl = small("olmo-1b-bf16.train")
    cfg = _fp32(cfg)
    m = cfg["model"]
    mc = drv.model_config(cfg)
    params = drv.program_params(mc, m, 5, "cpu")
    tokens = traffic.lm_batch(5, 0, m["vocab_size"], 4, 32)
    tc = drv.train_config(cfg, wl)
    eng = Engine(backend="torch")
    with eng.activate():
        loss, grads = TS.value_and_grad(TS.make_loss(mc, tc),
                                        T.trainable(params), {"tokens": tokens})
    w = {k: drv.draw_leaf(m, k, 5, "cpu", torch.float32) for k in drv.PATHS}
    rloss, rgrads = ref_olmo.loss_and_grads(m, w, tokens)
    assert abs(rloss - float(loss)) < 1e-5 * abs(rloss)
    flat = dict(tree.flatten_with_paths(grads))
    for k, p in drv.PATHS.items():
        g = flat[p]
        assert torch.allclose(rgrads[k], g, rtol=1e-4,
                              atol=1e-4 * g.abs().max()), k


def test_olmo_reference_steps_equal_the_ports():
    """Three AdamW steps of the reference and of the port's donated train
    step (fp32, the kernels backend's plain versions on the CPU) reach the
    same losses, first gradient norms and changes: the comparison reads ~0
    where both compute alike."""
    drv = harness.driver("lm_train")
    cfg, wl = small("olmo-1b-bf16.train")
    cfg = _fp32(cfg)
    st = drv.setup(cfg, wl, 9, torch.device("cpu"), harness.Tracer(False))
    ref = drv.reference_readings(st)
    got = drv.compare(drv.program_readings(st), ref)
    assert got["loss_gap"] < 1e-4 and got["grad_gap"] < 1e-3
    assert got["change_gap"] < 2e-3


def test_fp8_control_and_half_batch_read_far_from_the_reference():
    drv = harness.driver("lm_train")
    cfg, wl = small("olmo-1b-bf16.train")
    st = drv.State(_fp32(cfg), wl, 13, torch.device("cpu"))
    ref = drv.reference_readings(st)
    ctl = drv.compare(drv.reference_readings(st, mm=ref_olmo.fp8_mm), ref)
    half = drv.compare(drv.reference_readings(st, rows=[0, 1]), ref)
    same = drv.compare(drv.reference_readings(st), ref)
    assert same == {"loss_gap": 0.0, "grad_gap": 0.0, "change_gap": 0.0}
    assert max(ctl.values()) > 1e-2 and max(half.values()) > 1e-2
