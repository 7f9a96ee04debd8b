"""Serving launcher: batched generation with a model config on the card.

Port of the reference's ``repro.launch.serve`` with its flags, plus
``--device`` (``cuda`` by default; ``cpu`` runs the plain versions)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b --smoke --device cpu

``--metrics-dir DIR`` attaches a :class:`HistogramService` sidecar: each
request's generation latency is recorded as a durable histogram window,
and a standing subscription on the latency metric demonstrates the push
plane — the pushed update's eps is printed after the batch, then the
sidecar checkpoints and closes.

``--replicate-to DIR`` additionally ships the sidecar's WAL to a
hot-standby directory: after the batch, a replica-role service is opened
over the shipped log and its bounded-staleness answer is printed.

``main`` prints what the reference's prints and returns the outputs, the
pushed update and the primary's and the replica's answers to the panel.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke as smoke_cfg
from repro_torch.device import resolve_device
from repro_torch.models.model import init_model
from repro_torch.serve import Engine, HistogramService, ServeConfig

__all__ = ["main"]

PANEL = ("gen_latency_ms", 0, 1 << 20)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument(
        "--metrics-dir", default=None,
        help="attach a HistogramService sidecar recording per-request "
        "generation latency, with a standing push subscription",
    )
    ap.add_argument(
        "--replicate-to", default=None,
        help="hot-standby directory: ship the sidecar's WAL there and "
        "print a replica-role bounded-staleness answer after the batch "
        "(requires --metrics-dir)",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.replicate_to is not None and args.metrics_dir is None:
        ap.error("--replicate-to requires --metrics-dir")

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_cfg(cfg)
    params = init_model(cfg, torch.Generator(device=dev).manual_seed(0))
    eng = Engine(
        cfg, params,
        ServeConfig(
            max_seq=args.prompt_len + args.max_new_tokens + 1,
            max_new_tokens=args.max_new_tokens,
            temperature=args.temperature,
        ),
        device=dev,
    )
    del params
    svc = sub = None
    result = {"outputs": [], "update": None, "primary": None, "replica": None}
    if args.metrics_dir is not None:
        replicate_to = (args.replicate_to,) if args.replicate_to else ()
        svc = HistogramService(
            args.metrics_dir, num_buckets=64, replicate_to=replicate_to, device=dev
        )
        # standing dashboard panel: p-latency over the whole run so far
        sub = svc.subscribe(*PANEL, beta=64)

    rng = np.random.default_rng(0)
    prompts = [
        rng.integers(2, cfg.vocab_size, size=rng.integers(4, args.prompt_len + 1)).astype(np.int32)
        for _ in range(args.batch)
    ]
    latencies = []
    outs = result["outputs"]
    for i, p in enumerate(prompts):
        t0 = time.perf_counter()
        outs.append(eng.generate([p])[0])
        latencies.append((time.perf_counter() - t0) * 1e3)
        if svc is not None:
            svc.record("gen_latency_ms", i, np.float32([latencies[-1]]))
    for i, o in enumerate(outs):
        print(f"req{i}: prompt_len={len(prompts[i])} output={o.tolist()}")

    if svc is not None:
        svc.subscriptions.flush()  # push barrier: deliver the update
        update = result["update"] = sub.get(timeout=5.0)
        if update is not None:
            print(
                f"pushed update: metric=gen_latency_ms windows=0..{1 << 20} "
                f"eps={update.eps:g} degraded={update.degraded} "
                f"lag={update.lag_seconds * 1e3:.1f}ms"
            )
        stats = svc.subscriptions.stats()
        print(
            "subscription plane: "
            f"delivered={stats['updates_delivered']} "
            f"dispatches={stats['eval_batches']}"
        )
        if args.replicate_to is not None:
            result["primary"] = svc.query_many([PANEL], beta=64)[0]
            replica = HistogramService(
                args.replicate_to, role="replica", num_buckets=64, device=dev
            )
            replica.sync()
            ans = result["replica"] = replica.query_many([PANEL], beta=64)[0]
            repl = svc.health()["replication"]
            print(
                f"replica answer: eps={ans.eps:g} degraded={ans.degraded} "
                f"lag_s={ans.lag_seconds} "
                f"(primary shipped_lsn={repl['shipped_lsn']} "
                f"ships={repl['ships']})"
            )
            replica.close()
        svc.checkpoint()
        svc.close()
    return result


if __name__ == "__main__":
    main()
