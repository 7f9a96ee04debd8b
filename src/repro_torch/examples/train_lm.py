"""End-to-end LM training with the histogram plane switched on.

Port of ``examples/train_lm.py``.  Trains smollm-135m (reduced config by
default; --full for the real 135M) for a few hundred steps with:
  * histogram-quantile gradient clipping (paper Theorem 1 as an optimizer
    feature; on the card the row-sort and merge kernels, each step),
  * histogram-threshold gradient compression with error feedback,
  * checkpoint every 50 steps + deterministic resume,
  * straggler monitoring via merged step-time summaries.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200 [--device cpu]
      PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200 --resume-demo
"""
import argparse
import os
import shutil
import tempfile

from repro_torch.configs import get_config, smoke
from repro_torch.optim import CompressionConfig, OptimizerConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

CLOCK_FIELDS = (r"step_time=(\d+\.\d+)ms", r"steps in (\d+\.\d+)s", r"\(p95=(\d+\.\d+)ms\)")
MODEL_FIELDS = (r"loss=(\d+\.\d+)", r"grad_norm=(\d+\.\d+)", r"^loss: (\d+\.\d+)", r"→ (\d+\.\d+)$")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full", action="store_true",
                    help="real 135M config (slow on CPU)")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--resume-demo", action="store_true",
                    help="interrupt at half steps, restart, verify resume")
    ap.add_argument("--device", default=None, help="cpu runs the plain versions (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config("smollm-135m")
    if not args.full:
        cfg = smoke(cfg)
    opt = OptimizerConfig(
        peak_lr=3e-3, warmup_steps=20, decay_steps=args.steps,
        clip_mode="quantile", clip_q=0.999,  # ← the paper as an optimizer
    )
    comp = CompressionConfig(enabled=args.compress, rho=0.01)

    def make(steps):
        return Trainer(
            cfg, opt,
            TrainerConfig(total_steps=steps, log_every=20,
                          checkpoint_every=50, checkpoint_dir=args.ckpt_dir),
            seq_len=args.seq_len, global_batch=args.global_batch,
            comp_cfg=comp, device=args.device,
        )

    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    if args.resume_demo:
        half = args.steps // 2 - args.steps // 2 % 50 or 50
        print(f"== phase 1: train to step {half}, then 'preempt' ==")
        make(half).run()
        print("== phase 2: restart from latest checkpoint ==")
        tr = make(args.steps)
        assert tr.start_step == half, tr.start_step
        tr.run()
    else:
        tr = make(args.steps)
        tr.run()
        first = tr.telemetry.scalars["loss"][0][1]
        last = tr.telemetry.scalars["loss"][-1][1]
        print(f"loss: {first:.3f} → {last:.3f}")
    print("train_lm OK")


if __name__ == "__main__":
    main()
