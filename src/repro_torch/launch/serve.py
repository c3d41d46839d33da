"""Serving launcher: batched requests against a (reduced) assigned arch, on
the port's kernels — the counterpart of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
        --requests 8 --max-new 16 [--dtype bfloat16]

Runs on the card unless ``--device cpu`` is given (the kernels' plain
versions then run).  ``--dtype`` sets the parameters, the compute and the
KV cache: fp32 by default, or bf16, the dtype every LM config is published
in.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.base import reduced
from repro_torch.configs.registry import all_lm_configs
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Request, ServeEngine


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    choices=sorted(all_lm_configs()))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="parameters, compute and KV cache")
    args = ap.parse_args(argv)

    cfg = reduced(all_lm_configs()[args.arch], param_dtype=args.dtype,
                  compute_dtype=args.dtype)
    if cfg.enc_dec or cfg.vision_tokens:
        raise SystemExit("multimodal serving: use repro_torch.serve."
                         "serve_step.greedy_generate(..., extra=...) with "
                         "the stubbed frontend inputs")
    params = T.init_params(cfg, 0, device=args.device)
    eng = ServeEngine(cfg, params, batch_size=args.batch_size,
                      max_seq=args.max_seq,
                      cache_dtype=getattr(torch, args.dtype))
    rng = np.random.default_rng(0)
    for uid in range(args.requests):
        eng.submit(Request(uid=uid,
                           prompt=rng.integers(
                               0, cfg.vocab_size, 8).astype(np.int32),
                           max_new=args.max_new))
    done = eng.run()
    for r in done:
        print(f"req {r.uid}: {r.output.tolist()}")


if __name__ == "__main__":
    main()
