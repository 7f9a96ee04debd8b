"""Runs one cell of a served model once (a configuration whose adapter's
``KIND`` is ``"model"``): the harness's second kind of run.

Set-up draws the weights from the seed on the device
(``reference/model.py``), builds the adapter's system from them, and
serves one throwaway turn at the cell's shapes (``warm``).  The window
is a closed loop of one client: a turn is one ``generate`` of ``batch`` prompts of
``prompt_tokens`` ids, drawn uniformly over the vocabulary from the seed
and new every turn, each answered with ``new_tokens`` greedy tokens; the
next turn starts when it returns, until ``seconds`` have passed.  The
last turn started in the window ends it, so the window's time covers
every token it counts.

Once it has closed, the peak device memory is read and the system freed;
then every answer is checked for its form (the prompt it was asked,
then ``new_tokens`` ids of the vocabulary), and a sample of ``JUDGED``
answers drawn from the seed is judged by the reference: teacher-forced
through one full forward in float32, each served token's logit below the
reference's best (``reference/model.py``'s ``token_gaps``).
"""
from __future__ import annotations

import gc
import os
import time

import numpy as np
import torch

from hbench.reference.model import DTYPES, Decoder, full_float32, token_gaps
from hbench.trace import Tracer

JUDGED = 32  # answers the reference judges a run
ROWS = 4  # sequences the reference forwards at once


def prompts_of(traffic: dict, vocab: int, rng: np.random.Generator) -> list:
    """One turn's prompts: ``batch`` rows of ``prompt_tokens`` uniform ids."""
    ids = rng.integers(0, vocab, size=(int(traffic["batch"]), int(traffic["prompt_tokens"])), dtype=np.int64)
    return list(ids.astype(np.int32))


def well_formed(prompt: np.ndarray, answer, new: int, vocab: int) -> bool:
    """``answer`` is ``prompt`` followed by ``new`` ids of the vocabulary."""
    a = np.asarray(answer)
    return (a.shape == (len(prompt) + new,) and np.array_equal(a[: len(prompt)], prompt)
            and a.min() >= 0 and a.max() < vocab)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, cell: dict, cfg: dict, traffic: dict,
             limits: dict, bench: dict, device, control: bool, root: str, t0: float) -> dict:
    from hbench import harness

    cuda = torch.device(device).type == "cuda"
    vocab, new = int(cfg["vocab_size"]), int(traffic["new_tokens"])
    prompt, batch = int(traffic["prompt_tokens"]), int(traffic["batch"])
    # the traced stretch is one whole turn, the first to start past 40 % of the window
    tracer = Tracer(trace and cuda, harness.TRACE_START * seconds, 0.0)
    clock = time.perf_counter()
    System = harness.system_class(cfg, False, root)  # the program is imported before any work
    if cuda:
        torch.cuda.init()
    harness.log(f"set-up: program imported and device ready in {time.perf_counter() - clock:.3f} s")
    clock = time.perf_counter()
    dec = Decoder(cfg, os.path.join(root, "hbench", "reference", "layers"))
    params = dec.make_params(seed, device, DTYPES[cfg["torch_dtype"]])
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t_weights = time.perf_counter() - clock
    clock = time.perf_counter()
    sysobj = System(cfg, traffic, params, device)
    del params
    sysobj.warm(prompts_of(traffic, vocab, np.random.default_rng([int(seed), 0x3A4D, 1])))
    if cuda:
        torch.cuda.synchronize()
    tracer.warm()
    gc.collect()
    gc.freeze()
    harness.log(f"set-up: weights {t_weights:.3f} s, engine and warm-up turn {time.perf_counter() - clock:.3f} s")
    c0 = sysobj.counters()
    setup_s = time.perf_counter() - t0

    rng = np.random.default_rng([int(seed), 0x3A4D])
    asked, answered, errors = [], [], []
    turns = failed = tokens = 0
    plain_turns, plain_s = 0, 0.0  # the turns the profiler did not record, and their time
    start = time.perf_counter()
    while True:
        elapsed = time.perf_counter() - start
        if elapsed >= seconds:
            break
        tracer.turn(elapsed)
        traced = tracer.active
        prompts = prompts_of(traffic, vocab, rng)
        clock = time.perf_counter()
        try:
            with tracer.span("turn"):
                out = sysobj.generate(prompts)
        except Exception as exc:  # the program failed this turn: counted, the window ends
            failed += 1
            errors.append(repr(exc))
            break
        if not traced:
            plain_turns += 1
            plain_s += time.perf_counter() - clock
        asked.append(prompts)
        answered.append(out)
        tokens += sum(max(0, len(a) - len(p)) for p, a in zip(prompts, out))
        turns += 1
    window_s = time.perf_counter() - start
    tracer.stop()
    counters = harness._delta(sysobj.counters(), c0)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        harness.log(f"window: device memory peak {peak} B allocated, {torch.cuda.max_memory_reserved()} B reserved")
    sysobj.close()
    del sysobj
    tracer.finish()
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    harness.log(f"window: {turns} turns, {tokens} tokens, {failed} failed, {window_s:.3f} s")

    clock = time.perf_counter()
    checks = {}
    if failed == 0 and turns:
        rows = [(p, a) for prompts, out in zip(asked, answered) for p, a in zip(prompts, out)]
        whole = [np.asarray(a, np.int64) for p, a in rows if well_formed(p, a, new, vocab)]
        # an answer missing from a turn counts as malformed too
        missing = sum(abs(len(p) - len(a)) for p, a in zip(asked, answered))
        checks["answers_malformed"] = len(rows) - len(whole) + missing
        if whole:
            pick = np.random.default_rng([int(seed), 0x1D6E]).choice(len(whole), min(JUDGED, len(whole)), replace=False)
            seqs = np.stack([whole[i] for i in sorted(pick)])
            with torch.no_grad(), full_float32():
                params = dec.make_params(seed, device)
                gaps = token_gaps(dec, params, seqs, prompt, device, ROWS, control=control)
                del params
            checks["token_gap_sd"] = float(gaps.max())
            q = np.quantile(gaps, [0.5, 0.99, 1.0])
            harness.log(f"reference: token gaps (sd) median {q[0]:.4g}, 99th percentile {q[1]:.4g}, max {q[2]:.4g}, "
                        f"{int((gaps > 0).sum())} of {gaps.size} tokens not the reference's best")
        if cuda:
            torch.cuda.empty_cache()
    harness.log(f"reference: {turns * batch} answers checked, {min(JUDGED, turns * batch)} judged"
                f" in {time.perf_counter() - clock:.3f} s")
    correct = (failed == 0 and turns > 0 and checks.keys() == limits.keys()
               and all(v <= limits[k] for k, v in checks.items()))

    e2e = {"setup_s": setup_s}
    if window_s > 0 and turns:
        e2e["output_tokens_per_s"] = tokens / window_s
    run = None
    if trace:
        counters.update(turns=turns, tokens=tokens, window_s=window_s, plain_turns=plain_turns, plain_s=plain_s)
        run = {"config": cfg, "traffic": traffic, "counters": counters, "trace": tracer.parsed or None,
               "platform": "gpu" if cuda else "cpu"}
    outcome = {"correct": correct, "attempted": (turns + failed) * batch, "failed": failed * batch, "errors": errors}
    return harness.result_line(workload, cell, bench, root, tracer, run, e2e, outcome, peak, cuda, checks, limits)
