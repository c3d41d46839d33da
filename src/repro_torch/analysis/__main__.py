"""``python -m repro_torch.analysis`` — the static schedule verifier CLI.

Compiles schedules shape-only (``meta`` tensors; zero kernel execution),
runs every verification pass — the reference's four over the plans and
``launch`` over the CUDA kernels' launches — prints one summary block per
verified variant, and exits nonzero on any error-severity finding.

Examples::

    python -m repro_torch.analysis --net alexnet
    python -m repro_torch.analysis --net vgg16 --batch 8
    python -m repro_torch.analysis --all-zoo-variants

The launches of the LM configs (flash attention is never scheduled) are
checked by :func:`repro_torch.analysis.launch.lm_launches`.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.analysis.determinism import lint_scheduler_sources
from repro_torch.analysis.report import AnalysisReport, merge_reports
from repro_torch.analysis.verify import verify_stage_pair
from repro_torch.core.schedule import ScheduleRegistry


def _verify_named_nets(nets: list[str], batch: int) -> list[AnalysisReport]:
    registry = ScheduleRegistry()
    return [verify_stage_pair(registry.register(net, batch=batch),
                              label=f"{net}@b{batch}")
            for net in nets]


def _meta_cnn_params(net: str, in_res: int, weight_dtype: str) -> list:
    """A CNN's parameters as ``meta`` tensors (shapes and dtypes only, the
    counterpart of the reference's ``jax.eval_shape`` of ``init_cnn``):
    VGG-16's 553 MB of fp32 weights are not drawn just to be planned.  An
    int8 variant quantizes the meta tree, so its keys carry the 1-byte
    weight stream."""
    from repro_torch.core.quant import quantize_cnn_params
    from repro_torch.models import cnn
    params = []
    for kind, shape in cnn.param_shapes(net, in_res=in_res):
        if kind == "pool":
            params.append({})
            continue
        params.append({"f" if kind == "conv" else "w":
                       torch.empty(shape, device="meta"),
                       "b": torch.empty(shape[-1], device="meta")})
    if weight_dtype == "int8":
        params = quantize_cnn_params(params)
    return params


def zoo_variant_pairs(max_batch: int) -> list[tuple[str, tuple]]:
    """(label, stage-schedule pair) of every
    :data:`~repro_torch.configs.registry.ZOO_MODELS` variant, registered
    exactly the way :class:`~repro_torch.serve.zoo.ModelZooServer`
    registers it: meta parameter trees, the server's planner-preferred
    micro-batch, the server's engine policy."""
    from repro_torch.configs.registry import ZOO_MODELS
    from repro_torch.serve.cnn_server import CNNServer

    registry = ScheduleRegistry()
    out = []
    for spec in ZOO_MODELS.values():
        params = _meta_cnn_params(spec.net, spec.in_res, spec.weight_dtype)
        srv = CNNServer(spec.net, params, in_res=spec.in_res,
                        max_batch=max_batch, device="meta")
        pair = registry.register(
            spec.net, dtype_tag=spec.weight_dtype, batch=srv.microbatch,
            in_res=srv.in_res, in_ch=srv.in_ch,
            width_mult=srv.width_mult, dtype=srv.dtype,
            policy=srv.engine.policy, params=srv.params)
        out.append((f"{spec.name}@b{srv.microbatch}", pair))
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Statically verify compiled schedules and the CUDA "
                    "kernels' launches (no kernel execution).")
    ap.add_argument("--net", action="append", default=[],
                    help="verify one network's stage schedules "
                         "(repeatable; e.g. --net alexnet --net vgg16)")
    ap.add_argument("--batch", type=int, default=1,
                    help="batch size for --net schedules (default 1)")
    ap.add_argument("--all-zoo-variants", action="store_true",
                    help="verify every zoo registry variant at its "
                         "planner-preferred micro-batch")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="zoo server admission cap for "
                         "--all-zoo-variants (default 8, the zoo's)")
    ap.add_argument("--skip-determinism-lint", action="store_true",
                    help="skip the scheduler-determinism source lint")
    args = ap.parse_args(argv)

    if not args.net and not args.all_zoo_variants:
        ap.error("nothing to verify: pass --net and/or --all-zoo-variants")

    reports: list[AnalysisReport] = []
    if args.net:
        reports.extend(_verify_named_nets(args.net, args.batch))
    if args.all_zoo_variants:
        reports.extend(verify_stage_pair(pair, label=label) for label, pair
                       in zoo_variant_pairs(args.max_batch))
    if not args.skip_determinism_lint:
        reports.append(lint_scheduler_sources())

    for rep in reports:
        print(rep.summary())
    total = merge_reports("repro_torch.analysis", reports)
    print(total.summary())
    return 0 if total.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
