"""Batched serving + histogram-calibrated int8 activation scales.

Port of ``examples/serve_calibrated.py``.  Builds a (reduced) qwen3-8b
from a seeded generator, serves a batch of prompts through the
prefill/decode engine, then calibrates int8 activation clip ranges from
merged equi-depth summaries of calibration batches — the
quantization-calibration integration of the paper (bounded-rank-error
p99.9 instead of an outlier-hostage max).  On the card each batch's
summary is the row-sort kernel and their merge the merge kernel.

Run: PYTHONPATH=src python -m repro_torch.examples.serve_calibrated [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, smoke
from repro_torch.models import init_model
from repro_torch.serve import Engine, ServeConfig

CLOCK_FIELDS = ()
MODEL_FIELDS = (r"clip=(\d+\.\d+)", r"int8_scale=(\d+\.\d+)")  # quantiles of the model's activations


def main(device=None) -> None:
    cfg = smoke(get_config("qwen3-8b"))
    # seed 0, drawn on the host: the same model on every device
    params = init_model(cfg, torch.Generator().manual_seed(0))
    eng = Engine(
        cfg, params,
        ServeConfig(max_seq=64, max_new_tokens=12, temperature=0.0),
        device=device,
    )

    rng = np.random.default_rng(0)
    prompts = [
        rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
        for n in (6, 11, 17, 9)
    ]
    outs = eng.generate(prompts)
    for i, o in enumerate(outs):
        print(f"req{i}: {len(prompts[i])} prompt → {len(o)} total tokens")

    print("\n== int8 calibration from merged histograms ==")
    batches = []
    for i in range(4):
        k = np.random.default_rng([7, i])
        batches.append(
            {"tokens": k.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)}
        )
    calib = eng.calibrate(batches, q=0.999, T=512)
    print(f"clip={calib['clip']:.4f}  int8_scale={calib['int8_scale']:.6f}")
    print(f"rank error bound: ±{calib['rank_error_bound']:.0f} of "
          f"{calib['n_calibration_values']:,} calibration values "
          f"({100*calib['rank_error_bound']/calib['n_calibration_values']:.2f}%)")
    print("serve_calibrated OK")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cpu runs the plain versions (default: the card)")
    main(ap.parse_args().device)
