"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's: the per-cell configuration for every arch x shape x mesh; on a
(2, 4) mesh, one chip's argument bytes against the reference's compiled
``argument_size_in_bytes`` (exactly) and its operations against
``analyze_hlo`` of the compiled step, for reduced OLMo and a reduced MoE
config in training and decode (the reference compiles in a subprocess with
8 host devices); the traced matmul operations against the launch pass's
launches; and one full-size cell."""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro.configs import base as rbase
from repro.configs.registry import all_lm_configs as r_configs
from repro_torch.analysis import launch as AL
from repro_torch.configs import base as tbase
from repro_torch.configs.base import ShapeConfig, reduced
from repro_torch.configs.registry import all_lm_configs as t_configs
from repro_torch.configs.registry import get_config
from repro_torch.core.engine import Engine
from repro_torch.core.schedule import LayerSchedule
from repro_torch.distributed import sharding as SH
from repro_torch.launch import dryrun as D
from repro_torch.models import transformer as T

ROOT = Path(__file__).resolve().parents[1]


def _reference_dryrun():
    """``repro.launch.dryrun``, whose first lines set XLA_FLAGS to 512 host
    devices: imported with the environment restored afterwards (no
    function used here touches a device)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return dryrun


RD = _reference_dryrun()
MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", [s.name for s in tbase.SHAPES])
@pytest.mark.parametrize("arch", sorted(r_configs()))
def test_cell_config_equals_reference(arch, shape, mesh):
    """skip_reason, train_config_for and input_specs (shapes and dtypes)."""
    from jax.sharding import AbstractMesh as JMesh
    sizes, names = MESHES[mesh]
    try:
        rmesh = JMesh(tuple(zip(names, sizes)))
    except TypeError:
        rmesh = JMesh(sizes, names)
    rcfg, tcfg = r_configs()[arch], t_configs()[arch]
    rs, ts = rbase.SHAPES_BY_NAME[shape], tbase.SHAPES_BY_NAME[shape]
    assert D.skip_reason(tcfg, ts) == RD.skip_reason(rcfg, rs)
    assert D.audio_frames_for(ts) == RD.audio_frames_for(rs)
    assert vars(D.train_config_for(tcfg, ts, SH.AbstractMesh(sizes, names))
                ) == vars(RD.train_config_for(rcfg, rs, rmesh))
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
           for k, v in D.input_specs(tcfg, ts).items()}
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in RD.input_specs(rcfg, rs).items()}
    assert got == want


# ---------------------------------------------------------------------------
# one chip of a (2, 4) mesh against the reference's compiled step
# ---------------------------------------------------------------------------
CELLS = [(arch, kind) for arch in ("olmo-1b", "mixtral-8x7b")
         for kind in ("train", "decode", "decode_w8")]
SMALL = {"train": (32, 8), "decode": (64, 8), "decode_w8": (64, 8)}
#: memory cells: fp32 (XLA's CPU compile keeps fp32 copies of a bf16
#: dot's operands as temporaries, which a card does not), 8 layers at
#: 256 tokens so that the residual carry weighs in the peak; SP_CARRY off
#: and on
MEM = dict(n_layers=8, param_dtype="float32", compute_dtype="float32")
MEM_SHAPE = (256, 8)
MEM_CELLS = [(arch, sp) for arch in ("olmo-1b", "mixtral-8x7b")
             for sp in (False, True)]
#: the memory cells under remat="dots" (SP_CARRY off): the reference's
#: attention as it is, and as an opaque call (``opaque``: a ``custom_vjp``
#: that keeps q, k and v, as the port's flash Function does; the
#: reference's Pallas path is a ``pallas_call``, no dot either)
DOTS_CELLS = [(arch, opaque) for arch in ("olmo-1b", "mixtral-8x7b")
              for opaque in (False, True)]

REF_SCRIPT = textwrap.dedent("""
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    jax.devices()                      # 8 host devices, before the import
    import numpy as np
    from repro.launch import dryrun as D
    from repro.core import roofline
    from repro.configs.base import ShapeConfig, reduced
    from repro.configs.registry import all_lm_configs
    from repro.distributed import sharding as SH
    from repro.kernels import ref as RK
    from repro.models import transformer as RT
    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 4),
                             ("data", "model"))
    (cells, small, mem, (mseq, mbatch), mem_cells,
     dots_cells) = map(json.loads, sys.argv[1:])
    train_config_for, attention = D.train_config_for, RK.attention

    def opaque_attention(q, k, v, **kw):
        def fn(a, b, c):
            return attention(a, b, c, **kw)
        f = jax.custom_vjp(fn)
        f.defvjp(lambda a, b, c: (fn(a, b, c), (a, b, c)),
                 lambda res, g: jax.vjp(fn, *res)[1](g))
        return f(q, k, v)

    def compiled_cell(cfg, kind, seq, batch):
        mode = "decode" if kind == "decode_w8" else kind
        shape = ShapeConfig(mode, seq, batch, mode)
        with mesh, SH.activation_mesh(mesh):
            if kind == "decode_w8":
                lowered, mflops, _ = D.lower_decode(cfg, shape, mesh,
                                                    quant=True)
            else:
                lowered, mflops, _ = D.LOWER[mode](cfg, shape, mesh)
            compiled = lowered.compile()
        m = compiled.memory_analysis()
        return dict(argument_bytes=m.argument_size_in_bytes,
                    output_bytes=m.output_size_in_bytes,
                    temp_bytes=m.temp_size_in_bytes,
                    alias_bytes=m.alias_size_in_bytes,
                    flops=roofline.analyze_hlo(compiled.as_text()).flops,
                    model_flops=mflops)

    out = {}
    for arch, kind in cells:
        out[f"{arch} {kind}"] = compiled_cell(
            reduced(all_lm_configs()[arch]), kind, *small[kind])
    for arch, sp in mem_cells:
        RT.SP_CARRY["on"] = sp
        out[f"{arch} mem sp={sp}"] = compiled_cell(
            reduced(all_lm_configs()[arch], **mem), "train", mseq, mbatch)
    RT.SP_CARRY["on"] = False
    D.train_config_for = lambda *a: dataclasses.replace(
        train_config_for(*a), remat="dots")
    for arch, opaque in dots_cells:
        RK.attention = opaque_attention if opaque else attention
        out[f"{arch} dots opaque={opaque}"] = compiled_cell(
            reduced(all_lm_configs()[arch], **mem), "train", mseq, mbatch)
    D.train_config_for, RK.attention = train_config_for, attention
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_cells(tmp_path_factory):
    script = tmp_path_factory.mktemp("dryrun") / "ref.py"
    script.write_text(REF_SCRIPT)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    run = subprocess.run([sys.executable, str(script),
                          *map(json.dumps, (CELLS, SMALL, MEM, MEM_SHAPE,
                                            MEM_CELLS, DOTS_CELLS))],
                         check=True, env=env, capture_output=True, text=True,
                         timeout=600)
    return json.loads(run.stdout.strip().splitlines()[-1])


def _trace(cfg, kind: str, seq: int, batch: int, remat: str | None = None):
    """One chip of the (2, 4) mesh; ``remat`` replaces the train cell's
    policy."""
    mode = "decode" if kind == "decode_w8" else kind
    mesh = SH.AbstractMesh((2, 4), ("data", "model"))
    shape = ShapeConfig(mode, seq, batch, mode)
    if kind == "decode_w8":
        with torch.no_grad():
            tr = D.trace_decode(cfg, shape, mesh, quant=True)
    elif remat is not None:
        tc = dataclasses.replace(D.train_config_for(cfg, shape, mesh),
                                 remat=remat)
        with torch.enable_grad():
            tr = D.trace_train(cfg, shape, mesh, tc=tc)
    else:
        with torch.enable_grad() if mode == "train" else torch.no_grad():
            tr = D.TRACE[mode](cfg, shape, mesh)
    return tr, D.record(tr, mesh.size)


@pytest.mark.parametrize("arch,kind", CELLS)
def test_small_mesh_against_compiled_reference(arch, kind,
                                               reference_cells):
    """Argument bytes equal the reference's compiled figure exactly once
    ``embed_t`` (the port's copy of a tied head, which the reference does
    not hold) is taken out: params, moments, step, compression state and
    batch (train); serving params (int8 ``q`` and fp32 ``scale`` in the
    w8 variant), cache, tokens and position (decode).  So do the aliased
    (donated) bytes.  Outputs within 1 % (XLA counts the output tuple's
    pointers; the metrics differ).  Operations: decode equals
    ``analyze_hlo``'s count exactly; training within 10 % once the port's
    own recompute of an activated matmul's pre-activation (the kernels
    backend's backward reruns the forward kernel; XLA keeps it) is taken
    out -- the rest is attention, which the flash kernel counts over
    visible pairs and XLA over every score, and ops the reference's
    partitioner splits otherwise than Megatron's rule."""
    want = reference_cells[f"{arch} {kind}"]
    tr, rec = _trace(reduced(get_config(arch)), kind, *SMALL[kind])
    assert rec["argument_bytes"] - rec["embed_t_bytes"] == \
        want["argument_bytes"]
    assert rec["alias_bytes"] - (rec["embed_t_bytes"] if kind == "train"
                                 else 0) == want["alias_bytes"]
    assert abs((rec["output_bytes"] - (rec["embed_t_bytes"] if kind ==
                                       "train" else 0)) /
               want["output_bytes"] - 1) < 0.01
    assert rec["model_flops"] == want["model_flops"]
    if kind != "train":
        assert rec["flops_per_chip"] == want["flops"]
    else:
        pre = sum(c.flops / tr.split.divisor(c.key)
                  for c in tr.count.calls if c.role == "pre")
        got = rec["flops_per_chip"] - pre
        assert abs(got / want["flops"] - 1) < 0.10, (got, want["flops"])
    assert rec["fits"]


@pytest.mark.parametrize("arch", ["olmo-1b", "mixtral-8x7b"])
def test_small_mesh_memory_against_compiled_reference(arch, monkeypatch,
                                                      reference_cells):
    """The temporaries and the peak of a train step (fp32, 8 layers, 256
    tokens) against the reference's compiled ``memory_analysis`` on the
    (2, 4) mesh, with SP_CARRY off and on: each within a factor of 1.4
    (the port's peak of live tensors under eager allocation against XLA's
    buffer assignment of the partitioned program; the MoE dispatch
    buffers differ, one-hot einsums there, a scatter here), and SP_CARRY
    lowers the temporaries on both sides, the port's saving at least half
    the reference's (the port lays out only what the constrain sites
    name; GSPMD propagates from them)."""
    got, want = {}, {}
    for sp in (False, True):
        monkeypatch.setitem(T.SP_CARRY, "on", sp)
        _, rec = _trace(reduced(get_config(arch), **MEM), "train",
                        *MEM_SHAPE)
        ref = reference_cells[f"{arch} mem sp={sp}"]
        peak = ref["argument_bytes"] + ref["output_bytes"] + \
            ref["temp_bytes"] - ref["alias_bytes"]
        got[sp], want[sp] = rec["temp_bytes"], ref["temp_bytes"]
        for mine, theirs in ((rec["temp_bytes"], ref["temp_bytes"]),
                             (rec["peak_bytes_per_chip"], peak)):
            assert 1 / 1.4 < mine / theirs < 1.4, (sp, mine, theirs)
    assert want[False] > want[True] and got[False] > got[True]
    assert got[False] - got[True] > 0.5 * (want[False] - want[True])


@pytest.mark.parametrize("arch", ["olmo-1b", "mixtral-8x7b"])
def test_small_mesh_dots_memory_against_compiled_reference(arch,
                                                           reference_cells):
    """The memory cells of the test above under ``remat="dots"`` (SP_CARRY
    off): the port's temporaries and peak each within a factor of 1.4 of
    the reference's compiled step with its attention as an opaque call,
    which keeps q, k and v and recomputes the rest, as the port's flash
    kernel does (its Pallas path's ``pallas_call`` is no dot to
    ``checkpoint_dots`` either); the reference's XLA attention, whose
    score and value products ``checkpoint_dots`` keeps, holds more.  The
    port's peak lies between ``"block"``'s and ``"none"``'s."""
    cfg = reduced(get_config(arch), **MEM)
    rec = {remat: _trace(cfg, "train", *MEM_SHAPE, remat=remat)[1]
           for remat in ("none", "block", "dots")}
    ref = reference_cells[f"{arch} dots opaque=True"]
    peak = ref["argument_bytes"] + ref["output_bytes"] + \
        ref["temp_bytes"] - ref["alias_bytes"]
    for mine, theirs in ((rec["dots"]["temp_bytes"], ref["temp_bytes"]),
                         (rec["dots"]["peak_bytes_per_chip"], peak)):
        assert 1 / 1.4 < mine / theirs < 1.4, (mine, theirs)
    assert reference_cells[f"{arch} dots opaque=False"]["temp_bytes"] > \
        ref["temp_bytes"]
    peaks = [rec[r]["peak_bytes_per_chip"] for r in ("block", "dots",
                                                      "none")]
    assert peaks[0] < peaks[1] < peaks[2], peaks


@pytest.mark.parametrize("arch", ["olmo-1b", "seamless-m4t-large-v2"])
def test_remat_regathers_what_its_recompute_reruns(arch):
    """A train cell's all-gathers of FSDP-sharded weights on the (2, 4)
    mesh: the recompute gathers again the weights whose matmuls it
    reruns.  ``"dots"`` reruns none of the decoder's (OLMo: as many
    gathers as ``"none"``), but an encoder runs ``"dots"`` as ``"block"``
    (seamless: between the two)."""
    gathers = {remat: _trace(reduced(get_config(arch)), "train",
                             *SMALL["train"], remat=remat)[0]
               .collectives["all-gather"]["count"]
               for remat in ("none", "block", "dots")}
    assert gathers["none"] < gathers["block"]
    if arch == "olmo-1b":
        assert gathers["dots"] == gathers["none"]
    else:
        assert gathers["none"] < gathers["dots"] < gathers["block"]


def _launch_flops(lau) -> tuple[str, int]:
    if lau.kernel in ("sa_fc", "sa_fc_tc"):    # either of SA-FC's kernels
        b, k, n = lau.shape[:3]
        return "sa_fc_matmul", 2 * b * k * n
    m, n, k = lau.shape[:3]
    return "sa_conv_matmul", 2 * m * n * k


@pytest.mark.parametrize("arch", ["olmo-1b", "mixtral-8x7b", "zamba2-2.7b"])
def test_traced_matmuls_equal_the_launch_pass(arch):
    """One chip (1 x 1 mesh) of a reduced train step: the dry run's
    matmul kernel calls, by kernel, in count and operations, equal the
    launch pass's launches for the config's train schedule
    (``analysis/launch.py``: ``launches_for`` and ``backward_launches`` of
    each entry) taken as often as one forward dispatches the op, again in
    the remat recompute (every stacked block's) and for ``pre`` where its
    activation is not linear."""
    cfg = reduced(get_config(arch), n_layers=2 * len(get_config(
        arch).pattern))
    seq, batch = 32, 4
    mesh = SH.AbstractMesh((1, 1), ("data", "model"))
    with torch.enable_grad():
        tr = D.trace_train(cfg, ShapeConfig("t", seq, batch, "train"), mesh)
    got: dict = {}
    for c in tr.count.calls:
        if c.kernel.endswith("_matmul"):
            n, f = got.get(c.kernel, (0, 0))
            got[c.kernel] = (n + 1, f + c.flops)
    sched = LayerSchedule.compile(cfg, "train", batch=batch, seq=seq,
                                  policy=Engine().policy)
    eng = Engine(backend="torch")
    with eng.tracing() as rec, eng.activate():
        T.loss_fn(cfg, T.init_params(cfg, 0, device="meta"),
                  {"tokens": torch.empty((batch, seq), dtype=torch.int64,
                                         device="meta")})
    reps, rem = cfg.stack_shape()
    assert rem == 0
    acts = {"mlp.gate", "moe.shared.gate"} if cfg.mlp == "swiglu" else set()
    want: dict = {}
    for r in rec:
        if r.regime not in ("sa_fc", "sa_conv") or \
                r.name.endswith(".experts"):       # plain products
            continue
        key = next(k for k in sched if (k.name, k.m, k.n, k.k) ==
                   (r.name, r.m, r.n, r.k))
        plan = sched[key]
        fwd = AL.launches_for(key, plan)
        runs = fwd * (1 + (r.name != "lm_head") + (r.name in acts))
        for lau in runs + AL.backward_launches(key, plan):
            kern, f = _launch_flops(lau)
            n, tot = want.get(kern, (0, 0))
            want[kern] = (n + 1, tot + f)
    assert got == want
    assert tr.count.kernel_flops() == sum(f for _, f in want.values())


def test_full_size_cell_and_cli(tmp_path, monkeypatch, capsys):
    """olmo-1b decode_32k on the 16 x 16 production mesh traces ``ok`` and
    fits; a cached cell is reused; the CLI prints its summary, the w8
    variant included, and a skipped cell is recorded as skipped."""
    rec = D.run_cell("olmo-1b", "decode_32k", False, results_dir=tmp_path)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["fits"] and rec["chip"] == "H100 SXM"
    assert rec["dominant"] == "memory" and rec["kernel_calls"] > 0
    assert rec["cache_bytes"] == 2 * 16 * 128 * 32768 * 16 * 128 * 2
    again = D.run_cell("olmo-1b", "decode_32k", False, results_dir=tmp_path)
    assert again == json.loads(json.dumps(rec))
    skip = D.run_cell("olmo-1b", "long_500k", True, results_dir=tmp_path)
    assert skip["status"] == "skipped"
    monkeypatch.setattr(D, "RESULTS_DIR", tmp_path)
    D.main(["--arch", "olmo-1b", "--shape", "decode_32k", "--quant"])
    out = capsys.readouterr().out
    assert "pod16x16(w8)" in out and "fits" in out
    w8 = json.loads((tmp_path / "olmo-1b__decode_32k__pod16x16__w8.json")
                    .read_text())
    assert w8["argument_bytes"] < rec["argument_bytes"]
