"""Trainer: the fault-tolerant loop around make_train_step.

Port of ``repro.train.trainer`` with the same behaviours:
  * checkpoint/restart — atomic manifests, LATEST pointer, periodic +
    SIGTERM-triggered saves (preemption handling), elastic restore
    (``repro_torch.checkpoint``, the reference's on-disk format: either
    package resumes the other's run).
  * deterministic resume — data batches are a pure function of
    ``(seed, step)`` (``data.SyntheticLM``), so the only data state is the
    step.
  * straggler mitigation — per-host step times summarized with the paper's
    histograms; hosts beyond the merged quantile are flagged
    (``core.telemetry.StragglerDetector``, on the trainer's device) and
    reported each log interval.

Parameters are drawn by ``init_model`` from a ``torch.Generator`` seeded
with ``tcfg.seed`` on the trainer's device (``None`` → the card), so a
fresh run on the card and one on the CPU start from different values.
The host is the process-group rank (0 without a group).  A step's one
host sync is the read of its loss, which also stops its clock.
"""
from __future__ import annotations

import dataclasses
import math
import signal
import time
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.checkpoint import gc_checkpoints, latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs.base import ModelConfig
from repro_torch.core.telemetry import StragglerDetector, TelemetryLog
from repro_torch.data import SyntheticLM, shard_batch
from repro_torch.device import resolve_device
from repro_torch.models.model import init_model
from repro_torch.optim import CompressionConfig, OptimizerConfig
from repro_torch.train.train_step import make_opt_state, make_train_step

__all__ = ["Trainer", "TrainerConfig"]


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3
    seed: int = 0
    resume: bool = True


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        opt_cfg: OptimizerConfig,
        tcfg: TrainerConfig,
        *,
        seq_len: int,
        global_batch: int,
        mesh=None,
        rules=None,
        comp_cfg: CompressionConfig | None = None,
        device=None,
    ):
        self.cfg, self.opt_cfg, self.tcfg = cfg, opt_cfg, tcfg
        self.mesh, self.rules = mesh, rules
        self.device = resolve_device(device)
        self.data = SyntheticLM(
            vocab_size=cfg.vocab_size,
            seq_len=seq_len,
            global_batch=global_batch,
            seed=tcfg.seed,
        )
        self.telemetry = TelemetryLog()
        self.straggler = StragglerDetector(device=self.device)
        self._preempted = False
        self.host = dist.get_rank() if dist.is_initialized() else 0

        self.step_fn = make_train_step(cfg, opt_cfg, rules, comp_cfg=comp_cfg, mesh=mesh)

        # --- init or resume -------------------------------------------------
        gen = torch.Generator(device=self.device).manual_seed(tcfg.seed)
        params = init_model(cfg, gen, device=self.device)
        opt_state = make_opt_state(params, opt_cfg, comp_cfg)
        self.start_step = 0
        if tcfg.resume and latest_step(tcfg.checkpoint_dir) is not None:
            params, opt_state, self.start_step = restore_checkpoint(
                tcfg.checkpoint_dir, None, params, opt_state
            )
            print(f"[trainer] resumed from step {self.start_step}")
        self.params, self.opt_state = params, opt_state

    # ---- preemption: checkpoint on SIGTERM then exit cleanly ---------------
    def install_signal_handler(self):
        def handler(signum, frame):
            self._preempted = True

        signal.signal(signal.SIGTERM, handler)

    def _maybe_checkpoint(self, step: int, force: bool = False):
        if force or (step > 0 and step % self.tcfg.checkpoint_every == 0):
            save_checkpoint(
                self.tcfg.checkpoint_dir, step, self.params, self.opt_state
            )
            gc_checkpoints(self.tcfg.checkpoint_dir, self.tcfg.keep_checkpoints)

    def run(self, on_metrics: Callable[[int, dict], None] | None = None):
        t_loop = time.perf_counter()
        step = self.start_step
        while step < self.tcfg.total_steps:
            batch = shard_batch(self.data.batch_at(step), self.rules, self.mesh, self.device)
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch
            )
            loss = float(metrics["loss"])  # the step's one host sync
            dt = time.perf_counter() - t0
            self.straggler.record(self.host, dt)
            step += 1

            if step % self.tcfg.log_every == 0 or step == self.tcfg.total_steps:
                self.telemetry.log_scalar("loss", step, loss)
                self.telemetry.log_scalar("step_time", step, dt)
                flagged, p95 = self.straggler.flag()
                msg = (
                    f"[trainer] step={step} loss={loss:.4f} "
                    f"step_time={dt*1e3:.1f}ms grad_norm="
                    f"{float(metrics.get('grad_norm', math.nan)):.3f}"
                )
                if flagged:
                    msg += f" STRAGGLERS={flagged} (p95={p95*1e3:.1f}ms)"
                print(msg, flush=True)
                if on_metrics:
                    on_metrics(step, {**metrics, "step_time": dt})

            self._maybe_checkpoint(step)
            if self._preempted:
                print("[trainer] SIGTERM received — checkpointing and exiting")
                self._maybe_checkpoint(step, force=True)
                return step
        self._maybe_checkpoint(step, force=True)
        print(
            f"[trainer] done: {step - self.start_step} steps in "
            f"{time.perf_counter() - t_loop:.1f}s"
        )
        return step
