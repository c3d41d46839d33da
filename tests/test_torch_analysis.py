"""The port's static checks (``repro_torch.analysis``) against the
reference's (``repro.analysis``).

Three parts:

* the reference's own tests of its checks (``tests/test_analysis.py``),
  each mirrored against the port: the clean path, every seeded plan
  mutation, the determinism lint on snippet files, the report, both debug
  hooks and the CLI;
* parity: on the same schedules (AlexNet at b = 1, every zoo variant at
  its micro-batch) the port's four schedule passes give exactly the
  reference's findings, clean and under each of the reference's seeded
  mutations, and the port's plan geometry equals the reference's;
* the ``launch`` pass over the CUDA kernels' launches: clean for every
  zoo variant, every LM config the port runs and the edge launches, and
  each seeded fault (a grid one CTA short, a band that splits a pool
  window, SA-FC scratch one segment or one tile short, a split over k
  that reads the batch, shared memory 1 B over the limit, a kv tile
  dropped) caught with a diagnostic that names the kernel and the operand.
"""
import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis import context_for as rcontext_for
from repro.analysis import passes as rpasses
from repro.analysis.__main__ import _verify_zoo_variants as r_zoo_reports
from repro.core.schedule import ScheduleRegistry as RRegistry
from repro.kernels import geometry as rgeometry
from repro_torch.analysis import (
    AnalysisReport,
    Finding,
    ScheduleVerificationError,
    context_for,
    lint_scheduler_sources,
    merge_reports,
    verify_context,
    verify_stage_pair,
)
from repro_torch.analysis import launch as tlaunch
from repro_torch.analysis import passes as tpasses
from repro_torch.analysis.__main__ import zoo_variant_pairs
from repro_torch.analysis.determinism import DEFAULT_TARGETS, lint_file
from repro_torch.analysis.passes import (
    check_accounting,
    check_coverage,
    check_races,
    check_residency,
)
from repro_torch.core.dataflow import MAX_TILE, ConvPlan, FCPlan
from repro_torch.core.engine import Engine
from repro_torch.core.schedule import ScheduleRegistry
from repro_torch.kernels import attention as tattn
from repro_torch.kernels import geometry as tgeometry
from repro_torch.kernels import sa_fc as tfc

ROOT = Path(__file__).resolve().parents[1]


# -- shared compiled schedules (memoized; compiled once per process) --------

@pytest.fixture(scope="module")
def alexnet_pair():
    return ScheduleRegistry().register("alexnet", batch=1)


@pytest.fixture(scope="module")
def ref_alexnet_pair():
    return RRegistry().register("alexnet", batch=1)


def _fc_ctx(pair, context_for_):
    _, fc_sched = pair
    for key, plan in fc_sched.items():
        if isinstance(plan, FCPlan) or type(plan).__name__ == "FCPlan":
            return context_for_(key, plan, fc_sched.policy)
    raise AssertionError("alexnet fc stage holds no FCPlan")


def _conv_ctx(pair, context_for_):
    conv_sched, _ = pair
    key, plan = next(iter(conv_sched.conv_entries.items()))
    return context_for_(key, plan, conv_sched.policy)


@pytest.fixture(scope="module")
def fc_ctx(alexnet_pair):
    """Context of one batch-amortized FC entry of the fc stage."""
    return _fc_ctx(alexnet_pair, context_for)


@pytest.fixture(scope="module")
def conv_ctx(alexnet_pair):
    ctx = _conv_ctx(alexnet_pair, context_for)
    assert isinstance(ctx.plan, ConvPlan)
    return ctx


def _mutate(ctx, **plan_fields):
    """Rebuild the context around a plan with one corrupted field."""
    bad_plan = dataclasses.replace(ctx.plan, **plan_fields)
    return context_for(ctx.key, bad_plan, ctx.policy)


def _messages(findings):
    return " | ".join(f.message for f in findings)


# -- clean path --------------------------------------------------------------

def test_alexnet_schedule_verifies_clean(alexnet_pair):
    report = verify_stage_pair(alexnet_pair, label="alexnet@b1")
    assert report.ok, report.summary()
    assert report.checked_ops == 8
    assert report.findings == []


def test_clean_contexts_pass_every_pass(fc_ctx, conv_ctx):
    for ctx in (fc_ctx, conv_ctx):
        assert verify_context(ctx) == []


def test_determinism_lint_clean_on_repo_sources():
    report = lint_scheduler_sources()
    assert report.ok, report.summary()
    assert report.checked_files == len(DEFAULT_TARGETS) == 4


# -- seeded mutations: coverage ----------------------------------------------

def test_coverage_catches_misaligned_batch_tile(fc_ctx):
    findings = check_coverage(_mutate(fc_ctx, bb=24))
    assert findings, "verifier missed a 24-row (non-SUBLANE) batch tile"
    msgs = _messages(findings)
    assert "SUBLANE" in msgs
    assert "normalized tiles" in msgs      # plan-vs-kernel clamp drift


def test_coverage_catches_max_tile_overflow(fc_ctx):
    assert fc_ctx.plan.n >= 2 * MAX_TILE, "pick a wider FC layer"
    findings = check_coverage(_mutate(fc_ctx, bn=2 * MAX_TILE))
    assert any(f"exceeds MAX_TILE={MAX_TILE}" in f.message
               for f in findings), _messages(findings)


def test_coverage_catches_grid_gap(fc_ctx):
    """A grid shrunk below the plan's own grid is both a plan/kernel
    grid disagreement and (on the shrunken axis) a coverage gap."""
    geom = fc_ctx.geom
    shrunk = dataclasses.replace(
        geom, grid=(geom.grid[0], geom.grid[1], geom.grid[2] - 1))
    bad = dataclasses.replace(fc_ctx, geom=shrunk)
    msgs = _messages(check_coverage(bad))
    assert "kernel grid" in msgs and "!= plan grid" in msgs
    assert "silent clamp" in msgs or "coverage gap" in msgs


# -- seeded mutations: residency ---------------------------------------------

def test_residency_catches_vmem_lie(fc_ctx, conv_ctx):
    for ctx in (fc_ctx, conv_ctx):
        findings = check_residency(
            _mutate(ctx, vmem_bytes=ctx.plan.vmem_bytes + 1))
        assert len(findings) == 1
        assert "plan and kernel disagree" in findings[0].message
        assert str(ctx.plan.vmem_bytes + 1) in findings[0].message


# -- seeded mutations: races -------------------------------------------------

def test_race_catches_parallel_reduction_dim(fc_ctx):
    """Re-labelling the FC reduction grid dim 'parallel' makes every
    accumulation step a racing writer of its output block."""
    geom = dataclasses.replace(
        fc_ctx.geom,
        dimension_semantics=("parallel",) * len(fc_ctx.geom.grid))
    findings = check_races(dataclasses.replace(fc_ctx, geom=geom))
    assert any("write race" in f.message for f in findings), \
        _messages(findings)


def test_race_catches_non_innermost_reduction(fc_ctx):
    sem = ("arbitrary",) + ("parallel",) * (len(fc_ctx.geom.grid) - 1)
    geom = dataclasses.replace(fc_ctx.geom, dimension_semantics=sem)
    findings = check_races(dataclasses.replace(fc_ctx, geom=geom))
    assert any("innermost-sequential suffix" in f.message
               for f in findings), _messages(findings)


# -- seeded mutations: accounting --------------------------------------------

def test_accounting_catches_traffic_lie(fc_ctx, conv_ctx):
    for ctx in (fc_ctx, conv_ctx):
        findings = check_accounting(
            _mutate(ctx, hbm_bytes=ctx.plan.hbm_bytes + 64))
        assert any("!= plan.hbm_bytes" in f.message for f in findings), \
            _messages(findings)


def test_accounting_catches_weight_stream_lie(fc_ctx):
    bad = _mutate(fc_ctx,
                  weight_hbm_bytes=fc_ctx.plan.weight_hbm_bytes + 4)
    findings = check_accounting(bad)
    assert any("plan.weight_hbm_bytes" in f.message for f in findings), \
        _messages(findings)


def test_accounting_catches_flip_batch_lie(fc_ctx):
    bad = _mutate(fc_ctx, flip_batch=fc_ctx.plan.flip_batch + 7)
    findings = check_accounting(bad)
    assert any("plan.flip_batch" in f.message for f in findings), \
        _messages(findings)


def test_accounting_catches_bad_case(fc_ctx):
    findings = check_accounting(_mutate(fc_ctx, case=5))
    assert any("outside 1..4" in f.message for f in findings)


def test_accounting_catches_conv_flops_lie(conv_ctx):
    bad = _mutate(conv_ctx, flops=conv_ctx.plan.flops - 2)
    findings = check_accounting(bad)
    assert any("plan.flops" in f.message for f in findings), \
        _messages(findings)


# -- seeded mutations: determinism lint --------------------------------------

def _lint_snippet(tmp_path, source, **kw):
    path = tmp_path / "snippet.py"
    path.write_text(textwrap.dedent(source))
    return lint_file(path, rel="snippet.py", **kw)


def test_determinism_flags_wall_clock(tmp_path):
    findings = _lint_snippet(tmp_path, """\
        import time
        def decide():
            return time.perf_counter()
        """)
    assert len(findings) == 1
    assert "wall-clock call time.perf_counter()" in findings[0].message
    assert findings[0].op == "snippet.py:3"


def test_determinism_pragma_and_exemption(tmp_path):
    source = """\
        import time
        def measure():
            return time.time()
        def decide():
            return time.time()  # det: allow
        """
    assert _lint_snippet(tmp_path, source) != []  # measure() flagged...
    assert _lint_snippet(tmp_path, source,
                         exempt=frozenset({"measure"})) == []


def test_determinism_flags_unseeded_rng_only(tmp_path):
    findings = _lint_snippet(tmp_path, """\
        import numpy as np
        def draw():
            good = np.random.default_rng(1234)
            bad = np.random.default_rng()
            worse = np.random.poisson(3.0)
            return good, bad, worse
        """)
    assert len(findings) == 2
    assert "without a seed" in findings[0].message
    assert "global" in findings[1].message


def test_determinism_flags_set_iteration(tmp_path):
    findings = _lint_snippet(tmp_path, """\
        def order(queues):
            for q in set(queues):
                yield q
            return [x for x in {1, 2}] + list({3, 4})
        """)
    kinds = _messages(findings)
    assert "for-loop over an unordered set" in kinds
    assert "comprehension over an unordered set" in kinds
    assert "list() over an unordered set" in kinds


#: torch's global generator: each draw flagged without ``generator=`` and
#: allowed with it (the port's counterpart of the reference's jax.random
#: allowance)
TORCH_DRAWS = ("torch.rand(3{g})", "torch.randn(2, 3{g})",
               "torch.randint(0, 9, (4,){g})", "torch.randperm(5{g})",
               "torch.normal(0.0, 1.0, (2,){g})",
               "torch.bernoulli(torch.full((3,), 0.5){g})",
               "torch.multinomial(torch.ones(4), 2{g})",
               "torch.empty(3).normal_({g0})", "torch.empty(3).uniform_({g0})",
               "torch.empty(3).random_({g0})",
               "torch.empty(3).bernoulli_(0.5{g})")


@pytest.mark.parametrize("draw", TORCH_DRAWS)
def test_determinism_flags_torch_global_generator(tmp_path, draw):
    def snippet(g, g0):
        return f"""\
            import torch
            def draw(gen):
                return {draw.format(g=g, g0=g0)}
            """
    findings = _lint_snippet(tmp_path, snippet("", ""))
    assert len(findings) == 1, _messages(findings)
    assert "torch's global generator; pass generator=" in \
        findings[0].message
    assert findings[0].op == "snippet.py:3"
    assert _lint_snippet(tmp_path, snippet(", generator=gen",
                                           "generator=gen")) == []


# -- report / error types ----------------------------------------------------

def test_finding_validates_pass_name_and_severity():
    with pytest.raises(ValueError, match="unknown pass"):
        Finding("typo", "op", "msg")
    with pytest.raises(ValueError, match="severity"):
        Finding("coverage", "op", "msg", severity="fatal")
    assert str(Finding("launch", "fc1 [sa_fc]", "m")) == \
        "[launch] fc1 [sa_fc]: m"


def test_report_merge_and_raise():
    bad = AnalysisReport(label="b", checked_ops=1)
    bad.findings.append(Finding("residency", "fc1", "working set lie"))
    warn = AnalysisReport(label="w", checked_ops=1)
    warn.findings.append(Finding("coverage", "big", "skipped",
                                 severity="warning"))
    merged = merge_reports("all", [bad, warn])
    assert merged.checked_ops == 2
    assert len(merged.errors) == 1 and len(merged.warnings) == 1
    assert not merged.ok
    with pytest.raises(ScheduleVerificationError,
                       match="working set lie") as ei:
        merged.raise_if_failed()
    assert ei.value.report is merged
    assert warn.ok  # warnings alone do not fail a report
    warn.raise_if_failed()


# -- registry conflict detection + debug hooks -------------------------------

def test_registry_rejects_conflicting_reregistration():
    reg = ScheduleRegistry()
    pair = reg.register("alexnet", batch=1)
    assert reg.register("alexnet", batch=1) is pair  # idempotent
    with pytest.raises(ValueError, match="conflicting re-registration"):
        reg.register("alexnet", batch=1, width_mult=0.5)
    assert len(reg) == 1  # the filed pair survived the rejected call


def test_registry_verify_hook_accepts_clean_schedules(alexnet_pair):
    reg = ScheduleRegistry(verify=True)
    assert reg.register("alexnet", batch=1) == alexnet_pair


class _StubSchedule:
    """Minimal LayerSchedule facade holding one corrupted entry."""
    phase = "fc"

    def __init__(self, ctx):
        self.policy = ctx.policy
        self.conv_entries = {}
        self._entries = {ctx.key: dataclasses.replace(
            ctx.plan, vmem_bytes=ctx.plan.vmem_bytes + 1)}

    def items(self):
        return self._entries.items()


def test_engine_verify_hook(alexnet_pair, fc_ctx):
    _, fc_sched = alexnet_pair
    eng = Engine(backend="kernels", verify_schedules=True)
    derived = eng.with_schedule(fc_sched)        # clean: attaches fine
    assert derived.verify_schedules and derived.schedule is fc_sched
    with pytest.raises(ScheduleVerificationError,
                       match="plan and kernel disagree"):
        eng.with_schedule(_StubSchedule(fc_ctx))
    # the hook is opt-in: a default engine attaches without verifying
    Engine(backend="kernels").with_schedule(_StubSchedule(fc_ctx))


def test_registry_verify_hook_raises_on_a_faulty_launch(monkeypatch):
    """verify=True also runs the launch pass: a registry whose SA-FC split
    reads the batch refuses to file the pair."""
    monkeypatch.setattr(tfc, "fc_launch", _fc_launch_reading_b())
    with pytest.raises(ScheduleVerificationError, match="sa_fc order"):
        ScheduleRegistry(verify=True).register("alexnet", batch=3)


# -- CLI ---------------------------------------------------------------------

def test_cli_verifies_named_net(capsys):
    from repro_torch.analysis.__main__ import main
    assert main(["--net", "alexnet", "--skip-determinism-lint"]) == 0
    out = capsys.readouterr().out
    assert "[alexnet@b1] OK" in out
    assert "0 findings" in out


def test_cli_requires_a_target():
    from repro_torch.analysis.__main__ import main
    with pytest.raises(SystemExit):
        main([])


def test_cli_all_zoo_variants_without_jax():
    """``python -m repro_torch.analysis --net alexnet --net vgg16
    --all-zoo-variants`` exits 0 with no error finding, and JAX is never
    imported."""
    code = ("import sys\n"
            "from repro_torch.analysis.__main__ import main\n"
            "rc = main(['--net', 'alexnet', '--net', 'vgg16', "
            "'--all-zoo-variants'])\n"
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules\n"
            "sys.exit(rc)\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "[repro_torch.analysis] OK: 56 op(s), 4 file(s) verified, " \
        "0 findings" in run.stdout


# -- parity with the reference ------------------------------------------------

SCHEDULE_PASSES = ("coverage", "residency", "race", "accounting")


def _tuples(findings):
    return [(f.pass_name, f.op, f.severity, f.message) for f in findings]


def test_findings_equal_the_reference_on_the_zoo(alexnet_pair,
                                                 ref_alexnet_pair):
    """AlexNet at b = 1 and every zoo variant at its micro-batch: the
    port's schedule passes find exactly what the reference's find, and its
    launch pass finds nothing."""
    from repro.analysis import verify_stage_pair as rverify_stage_pair
    ref = [rverify_stage_pair(ref_alexnet_pair, label="alexnet@b1")]
    ref += r_zoo_reports(8)
    port = [verify_stage_pair(alexnet_pair, label="alexnet@b1")]
    port += [verify_stage_pair(pair, label=label)
             for label, pair in zoo_variant_pairs(8)]
    assert [r.label for r in port] == [r.label for r in ref]
    for p, r in zip(port, ref):
        assert p.checked_ops == r.checked_ops
        assert _tuples(f for f in p.findings
                       if f.pass_name in SCHEDULE_PASSES) == \
            _tuples(r.findings)
        assert [f for f in p.findings if f.pass_name == "launch"] == []


#: the reference's seeded mutations (tests/test_analysis.py): (context,
#: pass, plan fields or geometry fields to corrupt)
MUTATIONS = [
    ("fc", "check_coverage", "plan", dict(bb=24)),
    ("fc", "check_coverage", "plan", dict(bn=2 * MAX_TILE)),
    ("fc", "check_coverage", "grid", None),
    ("fc", "check_residency", "plan", "vmem+1"),
    ("conv", "check_residency", "plan", "vmem+1"),
    ("fc", "check_races", "sem", ("parallel",) * 3),
    ("fc", "check_races", "sem", ("arbitrary", "parallel", "parallel")),
    ("fc", "check_accounting", "plan", "hbm+64"),
    ("conv", "check_accounting", "plan", "hbm+64"),
    ("fc", "check_accounting", "plan", "weight_hbm+4"),
    ("fc", "check_accounting", "plan", "flip+7"),
    ("fc", "check_accounting", "plan", dict(case=5)),
    ("conv", "check_accounting", "plan", "flops-2"),
]

_DELTAS = {"vmem+1": ("vmem_bytes", 1), "hbm+64": ("hbm_bytes", 64),
           "weight_hbm+4": ("weight_hbm_bytes", 4),
           "flip+7": ("flip_batch", 7), "flops-2": ("flops", -2)}


def _mutated(ctx, context_for_, what, how):
    if what == "plan":
        if isinstance(how, str):
            field, delta = _DELTAS[how]
            how = {field: getattr(ctx.plan, field) + delta}
        return context_for_(ctx.key, dataclasses.replace(ctx.plan, **how),
                            ctx.policy)
    if what == "grid":
        g = ctx.geom.grid
        geom = dataclasses.replace(ctx.geom, grid=(g[0], g[1], g[2] - 1))
    else:
        geom = dataclasses.replace(ctx.geom, dimension_semantics=how)
    return dataclasses.replace(ctx, geom=geom)


@pytest.mark.parametrize("which,check,what,how", MUTATIONS)
def test_mutation_findings_equal_the_reference(alexnet_pair,
                                               ref_alexnet_pair, which,
                                               check, what, how):
    pick = _fc_ctx if which == "fc" else _conv_ctx
    tctx = _mutated(pick(alexnet_pair, context_for), context_for, what, how)
    rctx = _mutated(pick(ref_alexnet_pair, rcontext_for), rcontext_for,
                    what, how)
    assert tctx.op == rctx.op
    got = _tuples(getattr(tpasses, check)(tctx))
    want = _tuples(getattr(rpasses, check)(rctx))
    assert got and got == want


def _grid_values(geom):
    import itertools
    points = list(itertools.product(*(range(g) for g in geom.grid)))
    return [(s.name, s.block, [s.index_map(*pt) for pt in points])
            for s in (*geom.inputs, geom.out)]


@pytest.mark.parametrize("which", ["fc", "matmul", "conv"])
def test_plan_geometry_equals_the_reference(which):
    """``kernels/geometry.py``'s functions give the reference's grid,
    semantics, blocks, scratch and index maps (evaluated over the grid)."""
    if which == "fc":
        args, kw = (3, 1000, 4100), dict(bb=None, bn=512, bk=512)
        kw.update(has_scale=True, has_bias=True)
        t, r = tgeometry.fc_geometry(*args, **kw), \
            rgeometry.fc_geometry(*args, **kw)
        assert tgeometry.fc_normalize(3, 1000, 4100, bb=24, bn=1024,
                                      bk=640) == \
            rgeometry.fc_normalize(3, 1000, 4100, bb=24, bn=1024, bk=640)
    elif which == "matmul":
        args, kw = (300, 700, 900), dict(bm=128, bn=256, bk=512,
                                         has_bias=True)
        t, r = tgeometry.matmul_geometry(*args, **kw), \
            rgeometry.matmul_geometry(*args, **kw)
    else:
        from repro.core.dataflow import ConvPlan as RConvPlan
        fields = dict(case=3, regime="sa_conv", bi=16, bj=32,
                      fuse_taps=False, hbm_bytes=0, flops=0, vmem_bytes=0,
                      m=0, n=0, k=0, fuse_pool=True, pool_window=3,
                      pool_stride=2)
        kw = dict(stride=1, has_scale=True, has_bias=True)
        t = tgeometry.conv_geometry(2, 15, 15, 40, 3, 3, 70,
                                    plan=ConvPlan(**fields), **kw)
        r = rgeometry.conv_geometry(2, 15, 15, 40, 3, 3, 70,
                                    plan=RConvPlan(**fields), **kw)
    for f in ("kernel", "grid", "dimension_semantics", "out_shape",
              "scratch", "points"):
        assert getattr(t, f) == getattr(r, f), f
    assert _grid_values(t) == _grid_values(r)


# -- the launch pass: clean ----------------------------------------------------

def test_launch_pass_clean_on_every_zoo_variant():
    launches = [lau for _, pair in zoo_variant_pairs(8) for sched in pair
                for lau in tlaunch.schedule_launches(sched)]
    assert {lau.kernel for lau in launches} == {"sa_conv_implicit",
                                                "sa_fc"}
    report = tlaunch.verify_launches(launches)
    assert report.ok and report.findings == [], report.summary()
    assert report.checked_ops == len(launches) == 32


def test_launch_pass_clean_on_every_lm_config():
    """Every LM config the port serves, as published: the dense ones, and
    the MoE (the router on SA-FC with n = E = 8 and 128), Mamba2
    (zamba2's in_proj with n = 2 di + 2 ns + nh = 10448) and zamba2's
    shared attention (flash at hd = 80)."""
    configs = tlaunch.lm_configs()
    assert set(configs) == {"gemma2-27b", "gemma3-27b", "llama3-405b",
                            "llama4-maverick-400b-a17b", "llava-next-34b",
                            "llava-next-34b@fp32", "mamba2-130m",
                            "mixtral-8x7b", "olmo-1b", "olmo-1b@fp32",
                            "seamless-m4t-large-v2",
                            "seamless-m4t-large-v2@fp32", "zamba2-2.7b"}
    launches = tlaunch.lm_launches(configs)
    kernels = {lau.kernel for lau in launches}
    assert kernels == {"sa_fc", "sa_fc_tc", "sa_conv", "attention"}
    # bf16 x (every bf16 decode step and wave) on the tensor-core kernel,
    # every fp32 x launch on the FMA kernel
    for lau in launches:
        if lau.kernel.startswith("sa_fc"):
            x_kind = lau.shape[4]
            assert (lau.kernel == "sa_fc_tc") == (x_kind == 2), lau.op
    windows = {lau.shape[7] for lau in launches
               if lau.kernel == "attention"}
    assert windows == {0, 1024, 4096}          # gemma3's, gemma2's, mixtral's
    routers = {lau.shape[2] for lau in launches if "moe.router [" in lau.op}
    assert routers == {8, 128}
    assert any("zamba2" in lau.op and "ssm.in_proj" in lau.op
               and lau.shape[1] == 10448 for lau in launches)
    assert any("zamba2" in lau.op and lau.kernel == "attention"
               and lau.shape[5] == 80 for lau in launches)
    assert not any("mamba2-130m" in lau.op and lau.kernel == "attention"
                   for lau in launches)
    assert len(launches) == 460         # 430 before the frontend families
    report = tlaunch.verify_launches(launches)           # trained
    assert report.ok and report.findings == [], report.summary()


def test_launch_pass_covers_the_train_backward_of_every_trained_config():
    """Every config the port trains has its train shape's launches checked,
    the backward's ``dx`` (the forward's regime kernel against ``w.T``)
    and ``dw`` (the GEMM on ``x.T``) among them: mixtral's router (dx on
    SA-FC with k = E = 8, dw at n = 8), Mamba's in_proj (n = 2 di + 2 ns
    + nh: 10448 for zamba2, 3352 for mamba2), and, since every config
    trains, the encoder-decoder and vision configs' (seamless's encoder
    and cross K/V at m = 4 x 1024 frames, its 256206-wide head's ``dw`` at
    k = 2048; llava's projections over 4 x (576 + 512) rows) with their
    flash launches at the train shape: llava's 1088 x 1088 causal (GQA 56
    / 8, hd 128), seamless's 1024 x 1024 encoder, 512 x 1024 cross and
    512 x 512 causal (hd 64).  No finding."""
    configs = {k: v for k, v in tlaunch.lm_configs().items()
               if k in ("mixtral-8x7b", "mamba2-130m", "zamba2-2.7b",
                        "olmo-1b", "seamless-m4t-large-v2",
                        "llava-next-34b")}
    launches = tlaunch.lm_launches(configs)
    train = {(lau.op.split(" ")[0], lau.op.split(": ")[1], lau.kernel,
              lau.shape[:3]) for lau in launches if " train " in lau.op}
    assert {name for name, *_ in train} == set(configs)
    for want in (
            ("mixtral-8x7b", "moe.router dx [sa_fc]", "sa_fc",
             (2048, 8, 4096)),
            ("mixtral-8x7b", "moe.router dw [sa_conv]", "sa_conv",
             (4096, 8, 2048)),
            ("zamba2-2.7b", "ssm.in_proj dx [sa_conv]", "sa_conv",
             (2048, 2560, 10448)),
            ("zamba2-2.7b", "ssm.in_proj dw [sa_conv]", "sa_conv",
             (2560, 10448, 2048)),
            ("mamba2-130m", "ssm.in_proj dw [sa_conv]", "sa_conv",
             (768, 3352, 2048)),
            ("olmo-1b", "lm_head dx [sa_conv]", "sa_conv",
             (2048, 2048, 50304)),
            ("seamless-m4t-large-v2", "attn.q dw [sa_conv]", "sa_conv",
             (1024, 1024, 4096)),
            ("seamless-m4t-large-v2", "mlp.down dw [sa_conv]", "sa_conv",
             (8192, 1024, 4096)),
            ("seamless-m4t-large-v2", "lm_head dx [sa_conv]", "sa_conv",
             (2048, 1024, 256206)),
            ("seamless-m4t-large-v2", "lm_head dw [sa_conv]", "sa_conv",
             (1024, 256206, 2048)),
            ("llava-next-34b", "attn.k dx [sa_conv]", "sa_conv",
             (4352, 7168, 1024)),
            ("llava-next-34b", "lm_head dw [sa_conv]", "sa_conv",
             (7168, 64000, 4352))):
        assert want in train, want
    # each shape once per config, under the first phase that launches it
    flash = {(lau.op.split(" ")[0], lau.shape) for lau in launches
             if lau.kernel == "attention"}
    for shape in ((4, 512, 512, 16, 16, 64, True, 0, 2),
                  (4, 1024, 1024, 16, 16, 64, False, 0, 2),
                  (4, 512, 1024, 16, 16, 64, False, 0, 2)):
        assert ("seamless-m4t-large-v2", shape) in flash, shape
    assert ("llava-next-34b", (4, 1088, 1088, 56, 8, 128, True, 0, 2)) \
        in flash
    report = tlaunch.verify_launches(launches)
    assert report.ok and report.findings == [], report.summary()


def test_launch_pass_clean_on_the_frontend_families():
    """seamless-m4t (as published and in fp32) and llava-next, served by
    ``greedy_generate`` with their frontend inputs: the encoder's
    non-causal flash over 1024 x 1024 frames, cross-attention's text x
    frames (non-causal), the causal decoder; the 256206-wide head on SA-FC
    and the GEMM, the cross K/V projections over B x 1024 rows; llava's
    vision-prefixed prefill (576 + text rows, a GQA group of 7 at hd
    128).  No finding."""
    configs = {k: v for k, v in tlaunch.lm_configs().items()
               if k.split("@")[0] in ("seamless-m4t-large-v2",
                                      "llava-next-34b")}
    assert len(configs) == 4
    launches = tlaunch.lm_launches(configs)
    flash = {lau.shape: lau.op.split(": ")[1] for lau in launches
             if lau.kernel == "attention"}
    assert flash[4, 1024, 1024, 16, 16, 64, False, 0, 2] == \
        "encoder attn [attention]"
    assert flash[4, 16, 1024, 16, 16, 64, False, 0, 2] == \
        "cross attn [attention]"
    assert flash[4, 16, 16, 16, 16, 64, True, 0, 2] == \
        "attn window 0 [attention]"
    assert flash[2, 608, 608, 56, 8, 128, True, 0, 2] == \
        "attn window 0 [attention]"
    heads = {(lau.kernel, lau.shape[:3]) for lau in launches
             if "lm_head" in lau.op and "seamless" in lau.op}
    assert ("sa_fc", (4, 1024, 256206)) in heads             # decode, b = 4
    assert ("sa_conv", (2048, 256206, 1024)) in heads        # 4 x 512 rows
    assert any(lau.kernel == "sa_conv" and lau.shape[:3] == (4096, 1024, 1024)
               and "seamless-m4t-large-v2 prefill" in lau.op
               for lau in launches)                    # encoder and cross K/V
    assert any(lau.kernel == "sa_conv" and lau.shape[0] == 2 * 608
               and "llava-next-34b prefill b2x32" in lau.op
               for lau in launches)
    report = tlaunch.verify_launches(launches)
    assert report.ok and report.findings == [], report.summary()


def test_noncausal_edge_launches_sweep_the_shapes_phase_13_needs():
    edges = tlaunch.noncausal_edge_launches()
    assert {lau.op for lau in edges} <= {lau.op for lau in
                                         tlaunch.edge_launches()}
    seen = set()
    for lau in edges:
        b, sq, skv, hq, hkv, d, causal, window, itemsize = lau.shape
        (g,) = lau.geoms
        assert not causal and window == 0 and g.q_tiles % 2 and sq % g.bq
        assert tlaunch.check_launch(lau) == [], lau.op
        seen |= {("rel", (sq > skv) - (sq < skv)), ("paired", g.paired),
                 ("d", d), ("itemsize", itemsize), ("group", hq // hkv)}
    assert seen == {("rel", -1), ("rel", 0), ("rel", 1), ("paired", False),
                    ("paired", True), ("d", 64), ("d", 128), ("itemsize", 2),
                    ("itemsize", 4), ("group", 1), ("group", 2),
                    ("group", 4), ("group", 7)}


@pytest.mark.parametrize("fault", ["causal loop", "short grid"])
def test_launch_catches_a_fault_in_a_noncausal_flash_launch(monkeypatch,
                                                             fault):
    """A kernel loop that stops at the diagonal on a non-causal launch
    (the kernel's ``kv_range`` taking every launch as causal) drops keys
    the rows see; a grid one query tile short leaves rows unwritten."""
    op = "edge non-causal sq>skv paired g7 d128 bf16 [attention]"
    lau = _edge(op)
    if fault == "causal loop":
        real = tattn.live_tiles

        def live_tiles(iq, sq, skv, *, causal, window, bq):
            return real(iq, sq, skv, causal=True, window=window, bq=bq)

        monkeypatch.setattr(tattn, "live_tiles", live_tiles)
        msgs = _only(lau)
        assert "attention coverage: keys: query row" in msgs, msgs
        assert "live_tiles drops a visible kv tile" in msgs, msgs
    else:
        g = lau.geoms[0]
        msgs = _only(dataclasses.replace(lau, geoms=(dataclasses.replace(
            g, q_tiles=g.q_tiles - 1),)))
        assert "attention coverage: out" in msgs, msgs
        assert "written by no CTA" in msgs or "query tiles" in msgs, msgs


def test_launch_pass_clean_on_every_bf16_flash_launch():
    """Every flash launch of a served or trained bf16 path runs the
    tensor-core kernel, its wgmma fragment map covering each query tile
    once and its shared memory within the card's: OLMo-1B's causal d 128,
    zamba2's d 80, seamless's non-causal d 64 encoder and cross-attention,
    llava's GQA group of 7 at d 128.  No finding."""
    configs = {k: v for k, v in tlaunch.lm_configs().items()
               if k in ("olmo-1b", "zamba2-2.7b", "seamless-m4t-large-v2",
                        "llava-next-34b")}
    flash = [lau for lau in tlaunch.lm_launches(configs)
             if lau.kernel == "attention"]
    assert flash and all(lau.shape[-1] == 2 for lau in flash)
    assert all(lau.geoms[0].tensor_cores and lau.geoms[0].threads ==
               2 * lau.geoms[0].bq for lau in flash)
    shapes = {lau.shape for lau in flash}
    for want in ((4, 512, 512, 16, 16, 128, True, 0, 2),
                 (4, 1024, 1024, 16, 16, 64, False, 0, 2),
                 (4, 16, 1024, 16, 16, 64, False, 0, 2),
                 (2, 608, 608, 56, 8, 128, True, 0, 2)):
        assert want in shapes, want
    assert any(s[5] == 80 for s in shapes)
    for lau in flash:
        b, sq, skv, hq, hkv, d, causal, window, itemsize = lau.shape
        assert lau.geoms[0].smem_bytes == tattn.smem_bytes(
            lau.geoms[0].bq, d, 2) <= tlaunch.SMEM_OPTIN
    report = tlaunch.verify_launches(flash)
    assert report.ok and report.findings == [], report.summary()


@pytest.mark.parametrize("fault", ["a warpgroup short", "fma loop",
                                   "fragment rows", "shared memory"])
def test_launch_catches_a_fault_in_a_bf16_flash_geometry(monkeypatch, fault):
    """A bf16 launch with one consumer warpgroup too few leaves query rows
    unwritten; one put on the FMA loop breaks the dtype's kernel; a
    fragment map that misses the accumulator's rows + 8 races and leaves
    rows unwritten; a shared-memory figure that misses the Q tiles' second
    buffer disagrees with the launch."""
    lau = _edge("edge non-causal sq==skv paired g7 d128 bf16 [attention]")
    g = lau.geoms[0]
    assert g.tensor_cores and g.bq == 128 and tlaunch.check_launch(lau) == []
    if fault == "a warpgroup short":
        monkeypatch.setattr(tattn.FlashGeometry, "threads",
                            property(lambda self: 2 * self.bq - 128))
        bad = g
    elif fault == "fma loop":
        bad = dataclasses.replace(g, tensor_cores=False)
    elif fault == "shared memory":
        bad = dataclasses.replace(g, smem_bytes=g.smem_bytes - 2 * 128 * 128)
    else:
        real = tattn.FlashGeometry.thread_outputs

        def fragment(self, t, d):
            # the accumulator's rows + 8 forgotten: each row the map gives
            # stored twice, rows 8..15 of each warp never
            rows, cols = real(self, t, d)
            return [rows[0], rows[0]], cols
        monkeypatch.setattr(tattn.FlashGeometry, "thread_outputs", fragment)
        bad = g
    msgs = _only(dataclasses.replace(lau, geoms=(bad,)))
    if fault == "a warpgroup short":
        assert "attention coverage: out: 8192 outputs of the CTA's tile " \
            "owned by no thread" in msgs, msgs
    elif fault == "fma loop":
        assert "attention order: out: bf16 on the FMA loop" in msgs, msgs
    elif fault == "shared memory":
        assert "attention residency: " in msgs
        assert "launch and geometry disagree" in msgs, msgs
    else:
        assert "attention coverage: out:" in msgs, msgs
        assert "attention race: out:" in msgs, msgs


def test_launch_pass_clean_on_the_declined_pool_and_strips():
    """A pool the planner declines runs on the pool kernel (checked at
    every vector width a pointer may give it), and a pool window wider
    than a CTA runs SA-CONV in column strips."""
    from repro_torch.core.dataflow import PoolSpec
    from repro_torch.core.engine import DispatchPolicy
    from repro_torch.core.schedule import ConvOpKey
    policy = DispatchPolicy()
    plan = policy.plan_conv(2, 29, 29, 64, 3, 3, 96, 1, act_bytes=4,
                            weight_bytes=4, pool=PoolSpec(3, 2),
                            act="gelu")           # not monotone: declined
    assert not plan.fuse_pool
    key = ConvOpKey("c", 2, 29, 29, 64, 3, 3, 96, 1, "float32", "float32",
                    3, 2)
    launches = tlaunch.launches_for(key, plan)
    assert [lau.kernel for lau in launches] == ["sa_conv_implicit",
                                                "pool_act"]
    assert [g.vec_bytes for g in launches[1].geoms] == [16, 8, 4]
    wide = tlaunch.conv_launch("wide [sa_conv_implicit]", 2, 224, 300, 16,
                               3, 3, 40, 1, 3, 2, 0)
    assert len(wide.strips) > 1
    for lau in (*launches, wide):
        assert tlaunch.check_launch(lau) == [], lau.op


def test_edge_launches_are_clean_and_at_their_edges():
    edges = {lau.op: lau for lau in tlaunch.edge_launches()}
    for lau in edges.values():
        assert tlaunch.check_launch(lau) == [], lau.op
    for op in ("edge b=1 [sa_fc]", "edge b=65 [sa_fc]"):
        fl = edges[op].geoms[0]
        b, k, n = edges[op].shape[:3]
        assert fl.split and n % fl.cols
        chunks = -(-k // tfc.K_CHUNK)
        assert chunks % (fl.seg_k // tfc.K_CHUNK) and k % tfc.K_CHUNK
    assert edges["edge b=65 [sa_fc]"].geoms[0].grid[1] == 2
    gemm = edges["edge 130x200 [sa_conv]"].geoms[0]
    assert (gemm.row_tiles, gemm.col_tiles) == (2, 2)
    flat = edges["edge flat [sa_conv_implicit]"].geoms[0]
    assert not flat.bands and flat.per_cta > flat.conv_h * flat.conv_w
    band = edges["edge bands [sa_conv_implicit]"].geoms[0]
    assert band.bands and band.band_rows()[-1] < band.rows
    assert [edges[op].geoms[0].vec_bytes for op in (
        "edge 16 B [pool_act]", "edge 8 B [pool_act]", "edge 4 B [pool_act]",
        "edge bf16 element [pool_act]")] == [16, 8, 4, 2]
    for op in ("edge paired [attention]", "edge paired window [attention]"):
        g = edges[op].geoms[0]
        assert g.paired and g.q_tiles % 2 and edges[op].shape[1] % g.bq
    sq, window = 392, 100
    g = edges["edge paired window [attention]"].geoms[0]
    assert tattn.live_tiles(g.q_tiles - 1, sq, sq, causal=True,
                            window=window, bq=g.bq).start > 0


# -- the launch pass: seeded faults -------------------------------------------

def _only(lau):
    return _messages(tlaunch.check_launch(lau))


def _edge(op):
    return next(lau for lau in tlaunch.edge_launches() if lau.op == op)


@pytest.mark.parametrize("op,short", [
    ("edge b=65 [sa_fc]", lambda g: dataclasses.replace(
        g, grid=(g.grid[0] - 1, *g.grid[1:]))),
    ("edge 130x200 [sa_conv]", lambda g: dataclasses.replace(
        g, col_tiles=g.col_tiles - 1)),
    ("edge 130x200 bf16 [sa_conv]", lambda g: dataclasses.replace(
        g, row_tiles=g.row_tiles - 1)),
    ("edge paired [attention]", lambda g: dataclasses.replace(
        g, q_tiles=g.q_tiles - 1)),
])
def test_launch_catches_a_grid_one_cta_short(op, short):
    lau = _edge(op)
    bad = dataclasses.replace(lau, geoms=(short(lau.geoms[0]),))
    findings = tlaunch.check_launch(bad)
    assert findings and all(f.pass_name == "launch" and f.op == op
                            for f in findings)
    msgs = _messages(findings)
    assert f"{lau.kernel} coverage: out" in msgs, msgs
    assert "written by no CTA" in msgs or "query tiles" in msgs, msgs


def test_launch_catches_a_band_that_splits_a_pool_window():
    lau = _edge("edge bands [sa_conv_implicit]")
    g = lau.geoms[0]
    bad = dataclasses.replace(lau, geoms=(dataclasses.replace(
        g, pool_window=g.pool_window - 1),))
    msgs = _only(bad)
    assert "sa_conv_implicit coverage: out at batch" in msgs
    assert "the band splits a pool window" in msgs, msgs


@pytest.mark.parametrize("op", ["edge bands bf16 [sa_conv_implicit]",
                                "edge bands 512 bf16 [sa_conv_implicit]",
                                "edge ci=3 stride 4 bf16 [sa_conv_implicit]"])
def test_launch_catches_a_bf16_band_that_splits_a_pool_window(op):
    """The tensor-core geometry's bands, planted one conv row short of
    their pool windows."""
    lau = _edge(op)
    g = lau.geoms[0]
    assert g.mb and g.bands and tlaunch.check_launch(lau) == []
    bad = dataclasses.replace(lau, geoms=(dataclasses.replace(
        g, pool_window=g.pool_window - 1),))
    msgs = _only(bad)
    assert "sa_conv_implicit coverage: out at batch" in msgs
    assert "the band splits a pool window" in msgs, msgs


@pytest.mark.parametrize("op", ["edge flat bf16 [sa_conv_implicit]",
                                "edge bands bf16 [sa_conv_implicit]"])
def test_launch_catches_a_bf16_tile_that_follows_the_batch(monkeypatch, op):
    """A tensor-core tiling that changes with the launch (here: every other
    geometry asked for takes the other tile) would change which k steps
    and tiles an output sees between batched and unbatched runs."""
    from repro_torch.kernels import sa_conv_implicit as tconv
    real = tconv.conv_geometry
    calls = []

    def geometry(*a, **kw):
        g = real(*a, **kw)
        calls.append(a)
        if len(calls) % 2 or not g.mb:
            return g
        mb, bco = next(t for t in tconv.TC_TILES if t != (g.mb, g.bco))
        return dataclasses.replace(g, mb=mb, bco=bco, pixels=128 * mb,
                                   smem_bytes=tconv.tc_smem(mb, bco),
                                   per_cta=g.per_cta if g.bands
                                   else 128 * mb)
    lau = _edge(op)
    monkeypatch.setattr(tconv, "conv_geometry", geometry)
    msgs = _only(lau)
    assert "sa_conv_implicit order: out: the tile at batch" in msgs, msgs


@pytest.mark.parametrize("short", ["segment", "tile"])
def test_launch_catches_split_scratch_too_short(monkeypatch, short):
    lau = _edge("edge b=65 [sa_fc]")
    b, _, n = lau.shape[:3]
    real = tfc._scratch

    def scratch(device, stream, tiles, partials):
        arrivals, part = real(device, stream, tiles, partials)
        if short == "tile":
            return arrivals[:tiles - 1], part
        return arrivals, part[:partials - b * n]

    monkeypatch.setattr(tfc, "_scratch", scratch)
    msgs = _only(lau)
    if short == "tile":
        assert "sa_fc race: arrival counters: 63 < 64" in msgs, msgs
    else:
        assert "sa_fc race: partials workspace" in msgs, msgs
        assert f"< 18 segments x {b} x {n}" in msgs


def test_launch_catches_scratch_shared_across_streams(monkeypatch):
    lau = _edge("edge b=1 [sa_fc]")
    real = tfc._scratch
    monkeypatch.setattr(tfc, "_scratch", lambda device, stream, *a: real(
        device, 0, *a))
    assert "not kept per (device, stream)" in _only(lau)


# -- the tensor-core kernel: seeded faults -----------------------------------

#: an edge launch of each tensor-core mode, split over k: narrow (n =
#: 1001) and wide (n = 4104)
DECODE_EDGES = ["edge tc b=8 odd n [sa_fc_tc]",
                "edge tc wide b=8 313 segments [sa_fc_tc]"]


def _decode_edge(op, units=None, **fields):
    """The edge tensor-core launch ``op``, its geometry's fields replaced by
    ``fields`` and, where ``units`` is given, its workers running
    ``units(real geometry, cta, worker)``."""
    lau = _edge(op)
    real = g = lau.geoms[0]
    assert g.split and g.ctas > 1 and tlaunch.check_launch(lau) == []
    if units is not None:
        class Faulty(type(real)):
            def worker_units(self, c, i):
                return units(real, c, i)
        g = Faulty(**dataclasses.asdict(real))
    return dataclasses.replace(lau, geoms=(dataclasses.replace(g, **fields),))


@pytest.mark.parametrize("op", DECODE_EDGES)
@pytest.mark.parametrize("fault", ["last segment", "segments field"])
def test_launch_catches_a_decode_geometry_that_skips_a_segment(op, fault):
    if fault == "last segment":
        bad = _decode_edge(op, lambda g, c, i: [
            u for u in g.worker_units(c, i) if u[1] != g.segments - 1])
    else:
        bad = _decode_edge(op, segments=_edge(op).geoms[0].segments - 1)
    msgs = _only(bad)
    assert "sa_fc_tc coverage: units" in msgs, msgs
    assert "run by no worker — a k segment or a column tile is never " \
        "summed" in msgs


@pytest.mark.parametrize("op", DECODE_EDGES)
@pytest.mark.parametrize("fault", ["two workers of a CTA", "two CTAs"])
def test_launch_catches_a_decode_output_with_two_writers(op, fault):
    """A unit run twice writes its partials twice (and, wide, arrives twice
    on its tile's counter, so the sum runs before the last segment is
    in)."""
    if fault == "two workers of a CTA":    # worker 1 also runs worker 0's
        bad = _decode_edge(op, lambda g, c, i: g.worker_units(c, i) + (
            g.worker_units(c, 0)[:1] if i == 1 else []))
    else:                                  # CTA 1 also runs CTA 0's
        bad = _decode_edge(op, lambda g, c, i: g.worker_units(c, i) + (
            g.worker_units(0, 0)[:1] if (c, i) == (1, 0) else []))
    msgs = _only(bad)
    assert "sa_fc_tc race: units" in msgs, msgs
    assert "run by more than one" in msgs
    if fault == "two CTAs" and "b=8 odd n" in op:
        assert "which does not own tile 0 — two CTAs write its outputs" in msgs


@pytest.mark.parametrize("op", DECODE_EDGES)
def test_launch_catches_a_decode_assignment_that_follows_the_batch(
        monkeypatch, op):
    """A grid that changes with b would hand an output's segments to other
    workers between batched and unbatched runs."""
    lau = _decode_edge(op)
    real = tfc.tc_launch

    def launch(b, k, n, w_bytes=2):
        d = real(b, k, n, w_bytes)
        return d if b < 4 else dataclasses.replace(d, ctas=d.ctas - 1)
    monkeypatch.setattr(tfc, "tc_launch", launch)
    msgs = _only(lau)
    assert "sa_fc_tc order: out: the units at b=4 differ" in msgs


def test_launch_catches_an_sa_fc_launch_on_the_wrong_kernel():
    """fp32 x on the tensor-core kernel, bf16 x on the FMA kernel, and a
    narrow geometry at n > 4096: routes the wrapper never takes."""
    lau = _decode_edge(DECODE_EDGES[0])
    b, k, n, w_kind, _ = lau.shape
    assert "sa_fc_tc order: out: the tensor-core kernel runs b=8, x kind 0" \
        in _only(dataclasses.replace(lau, shape=(b, k, n, w_kind, 0)))
    fma = dataclasses.replace(lau, kernel="sa_fc",
                              geoms=(tfc.fc_launch(b, k, n),))
    assert "sa_fc order: out: b=8 with bf16 x on the FMA kernel" in \
        _only(fma)
    wide = _edge(DECODE_EDGES[1])
    as_narrow = dataclasses.replace(wide, geoms=(dataclasses.replace(
        wide.geoms[0], narrow=True),))
    assert "narrow tiles of 16 at b <= 8 for k and n up to 4096" in \
        _only(as_narrow)


def test_launch_catches_narrow_decode_partials_past_shared_memory():
    """The narrow kernel keeps every partial of a CTA in shared memory, at
    most 64 KiB: k and n up to 4096 never give more (the edge launch's 125
    segments of 8 rows are 64000 B), a span one larger would."""
    lau = _edge("edge tc b=8 125 segments [sa_fc_tc]")
    g = lau.geoms[0]
    assert g.narrow and tlaunch.check_launch(lau) == []
    bad = dataclasses.replace(lau, geoms=(dataclasses.replace(
        g, span=2, smem=tfc.narrow_smem_bytes(2, g.segments, 2)),))
    msgs = _only(bad)
    assert "sa_fc_tc residency: partials: 128000 B over the 65536 B" \
        in msgs, msgs


@pytest.mark.parametrize("short", ["segment", "tile"])
def test_launch_catches_decode_scratch_too_short(monkeypatch, short):
    """The wide tensor-core kernel's split launches index the FMA kernel's
    scratch: (S, b, n) partials and one counter per (row tile, 64-column
    tile)."""
    lau = _edge(DECODE_EDGES[1])
    b, _, n = lau.shape[:3]
    real = tfc._scratch

    def scratch(device, stream, tiles, partials):
        arrivals, part = real(device, stream, tiles, partials)
        if short == "tile":
            return arrivals[:tiles - 1], part
        return arrivals, part[:partials - b * n]

    monkeypatch.setattr(tfc, "_scratch", scratch)
    msgs = _only(lau)
    if short == "tile":
        assert "sa_fc_tc race: arrival counters: 64 < 65" in msgs, msgs
    else:
        assert "sa_fc_tc race: partials workspace" in msgs, msgs


def _fc_launch_reading_b():
    """fc_launch with a split over k that reads the batch: a segment twice
    as long from b = 2 on."""
    real = tfc.fc_launch

    def launch(b, k, n):
        fl = real(b, k, n)
        if b < 2 or fl.segments < 2:
            return fl
        seg_k = 2 * fl.seg_k
        chunks = -(-k // tfc.K_CHUNK)
        segments = -(-chunks // (seg_k // tfc.K_CHUNK))
        return dataclasses.replace(
            fl, segments=segments, seg_k=seg_k,
            grid=(*fl.grid[:2], segments if fl.split else 1))
    return launch


def test_launch_catches_an_fc_split_that_reads_b(monkeypatch):
    monkeypatch.setattr(tfc, "fc_launch", _fc_launch_reading_b())
    lau = tlaunch.fc_launch("fc6 [sa_fc]", 4, 3999, 1000, 0, 0)
    msgs = _only(lau)
    assert "sa_fc order: out sums k in 18 segments of 224 at b=1 but 9 of " \
        "448 at b=4" in msgs, msgs


@pytest.mark.parametrize("op", ["edge b=1 [sa_fc]", "edge 130x200 [sa_conv]",
                                "edge bands [sa_conv_implicit]",
                                "edge paired [attention]"])
def test_launch_catches_shared_memory_one_byte_over(monkeypatch, op):
    """The limit set 1 B below what the launch takes is the launch 1 B
    over the limit; the GEMM, two CTAs an SM, is held per SM as well."""
    lau = _edge(op)
    (_, _, need), *_ = tlaunch.smem_queries(lau)
    total = need + tlaunch.STATIC_SMEM[lau.kernel]
    assert tlaunch.check_launch(lau) == []
    if lau.kernel == "sa_conv":
        per_sm = 2 * (total + tlaunch.SMEM_RESERVED)
        monkeypatch.setattr(tlaunch, "SMEM_PER_SM", per_sm - 1)
        assert f"2 CTAs of {total} B do not fit an SM's {per_sm - 1} B" in \
            _only(lau)
    monkeypatch.setattr(tlaunch, "SMEM_OPTIN", total - 1)
    msgs = _only(lau)
    assert f"{lau.kernel} residency: " in msgs
    assert f"{total} B of shared memory" in msgs
    assert f"over the {total - 1} B a CTA may opt into" in msgs, msgs


def test_launch_catches_a_geometry_that_misstates_its_shared_memory():
    lau = _edge("edge flat [sa_conv_implicit]")
    g = lau.geoms[0]
    bad = dataclasses.replace(lau, geoms=(dataclasses.replace(
        g, smem_bytes=g.smem_bytes - 4),))
    assert "launch and geometry disagree" in _only(bad)


def test_launch_catches_live_tiles_dropping_a_visible_tile(monkeypatch):
    real = tattn.live_tiles

    def live(iq, sq, skv, *, causal, window, bq):
        r = real(iq, sq, skv, causal=causal, window=window, bq=bq)
        return range(r.start + 1, r.stop) if len(r) > 1 else r

    monkeypatch.setattr(tattn, "live_tiles", live)
    msgs = _only(_edge("edge paired window [attention]"))
    assert "attention coverage: keys: query row" in msgs
    assert "live_tiles drops a visible kv tile" in msgs, msgs


def test_launch_catches_a_tile_that_follows_the_batch(monkeypatch):
    """A conv tiling that reads the launch's batch would change an
    output's summation order between batched and unbatched runs."""
    from repro_torch.kernels import sa_conv_implicit as tconv
    real = tconv.column_strips
    calls = []

    def strips(*a, **kw):
        calls.append(a)
        out = real(*a, **kw)
        return out if len(calls) % 2 else out + out[-1:]
    lau = _edge("edge flat [sa_conv_implicit]")
    monkeypatch.setattr(tconv, "column_strips", strips)
    msgs = _only(lau)
    assert "sa_conv_implicit order: out: the tile at batch" in msgs, msgs


def test_static_tables_match_the_kernel_source():
    """The launch pass's static shared memory of SA-CONV implicit counts
    the tables csrc/sa_conv_implicit.cu declares."""
    src = (ROOT / "src/repro_torch/kernels/csrc/sa_conv_implicit.cu"
           ).read_text()
    assert "__shared__ int s_row[MAX_ROWS];" in src
    assert "__shared__ int s_seg[MAX_SEGMENTS][SG_FIELDS];" in src
    assert "__shared__ int s_count[3];" in src
    fields = src.split("enum { ")[1].split("};")[0]
    assert fields.count(",") + 1 == tlaunch.SG_FIELDS + 1   # + SG_FIELDS
    assert "__shared__ int last;" in (
        ROOT / "src/repro_torch/kernels/csrc/sa_fc.cu").read_text()


def test_c8_static_shared_memory_counts_the_alignment():
    """C8: ptxas allots SA-CONV implicit's static tables (1932 B) up to the
    16-byte alignment of the dynamic buffer, 1936 B on the card (phase 11
    of chip_smoke.py); the geometry's budget must leave that much, so a
    CTA's dynamic shared memory is at most 232448 - 1936 B."""
    from repro_torch.kernels import sa_conv_implicit as tconv
    tables = 4 * (tconv.MAX_ROWS + tlaunch.SG_FIELDS * tconv.MAX_SEGMENTS
                  + 3)
    assert tables == 1932
    assert tconv.SMEM_STATIC == tlaunch.STATIC_SMEM["sa_conv_implicit"] \
        == 1936
    assert tconv.SMEM_MAX + tconv.SMEM_STATIC == tlaunch.SMEM_OPTIN
    assert tlaunch.STATIC_SMEM["sa_fc"] == 16        # one int, aligned
