"""Training launcher — the counterpart of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --steps 20 --batch 4 --seq 512

Runs on the card with the ``"kernels"`` backend unless told otherwise:
``--device cpu --reduced`` trains the reduced same-family config on the
CPU, where the kernels' wrappers take their plain versions; ``--backend
torch`` runs the plain versions on any device.  Without ``--reduced`` the
config is the published one (OLMo-1B: bf16 parameters and compute).  A
vision config (llava-next) trains on its text behind the stubbed vision
embeddings of each batch, an encoder-decoder config (seamless-m4t) on its
text beside the stubbed audio frames, with no schedule
(:func:`repro_torch.train.train_step.make_grad_fn`).
"""
from __future__ import annotations

import argparse

from repro_torch.configs.base import TrainConfig, reduced
from repro_torch.configs.registry import all_lm_configs
from repro_torch.core.accelerator import resolve_device
from repro_torch.core.engine import BACKENDS, Engine
from repro_torch.optim.grad_compress import SCHEMES
from repro_torch.train import trainer


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    choices=sorted(all_lm_configs()))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--grad-compress", default="none", choices=SCHEMES)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config in fp32")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--backend", default="kernels", choices=BACKENDS)
    args = ap.parse_args(argv)

    cfg = all_lm_configs()[args.arch]
    if args.reduced:
        cfg = reduced(cfg, param_dtype="float32", compute_dtype="float32")
    dev = resolve_device(args.device)
    print(f"[train] {cfg.name}: {cfg.n_params() / 1e6:.1f}M params on "
          f"{dev} ({args.backend} backend)")
    tc = TrainConfig(global_batch=args.batch, seq_len=args.seq,
                     total_steps=args.steps, lr=args.lr,
                     microbatch=args.microbatch,
                     grad_compress=args.grad_compress, remat="block")
    rep = trainer.run(cfg, tc, ckpt_dir=args.ckpt_dir, log_every=10,
                      device=dev, engine=Engine(backend=args.backend))
    print(f"[train] loss {rep.losses[0]:.4f} -> {rep.final_loss:.4f}")


if __name__ == "__main__":
    main()
