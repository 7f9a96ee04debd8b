"""Training launcher: a model config's ``Trainer`` on the card.

Port of the reference's ``repro.launch.train`` with its flags, plus
``--device`` (``cuda`` by default; ``cpu`` runs the plain versions)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m --smoke --device cpu --steps 4

``--mesh host`` is every rank of the process group as a ``(data, model)``
mesh, and the step is data-parallel over it.  When no process group is
set (a plain ``python -m`` run), the launcher starts a world-1 group over
an in-process store — NCCL on the card, gloo on the CPU — and destroys it
at the end; under ``torchrun`` or an initialized group it uses that one.
``--mesh single`` / ``multi`` are the production meshes (256 / 512
ranks).  ``main`` returns the ``Trainer`` after its run.
"""
from __future__ import annotations

import argparse

import torch.distributed as dist

from repro_torch.configs import get_config, smoke as smoke_cfg
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.optim import CompressionConfig, OptimizerConfig
from repro_torch.sharding import Rules
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["main"]


def main(argv=None) -> Trainer:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--clip-mode", default="global_norm",
                    choices=["none", "global_norm", "quantile"])
    ap.add_argument("--compress-rho", type=float, default=0.0,
                    help=">0 enables histogram-threshold grad compression")
    ap.add_argument("--checkpoint-dir", default="checkpoints")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="host", choices=["host", "single", "multi"])
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_cfg(cfg)
    own_group = not dist.is_initialized()
    if own_group:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = {
            "host": lambda: make_host_mesh(dev.type),
            "single": lambda: make_production_mesh(multi_pod=False, device_type=dev.type),
            "multi": lambda: make_production_mesh(multi_pod=True, device_type=dev.type),
        }[args.mesh]()
        rules = Rules(cfg, mesh, "train", seq_len=args.seq_len)
        opt_cfg = OptimizerConfig(
            peak_lr=args.lr, clip_mode=args.clip_mode,
            decay_steps=max(args.steps, 10),
            warmup_steps=min(20, args.steps // 5 + 1),
        )
        comp = (
            CompressionConfig(enabled=True, rho=args.compress_rho)
            if args.compress_rho > 0
            else None
        )
        tcfg = TrainerConfig(
            total_steps=args.steps,
            log_every=args.log_every,
            checkpoint_every=args.checkpoint_every,
            checkpoint_dir=args.checkpoint_dir,
            seed=args.seed,
            resume=not args.no_resume,
        )
        trainer = Trainer(
            cfg, opt_cfg, tcfg,
            seq_len=args.seq_len, global_batch=args.global_batch,
            mesh=mesh, rules=rules, comp_cfg=comp, device=dev,
        )
        trainer.install_signal_handler()
        trainer.run()
        return trainer
    finally:
        if own_group:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
