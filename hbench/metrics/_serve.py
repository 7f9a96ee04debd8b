"""What the readers of a served model's turn share: the phases of the
one turn the trace holds, found on the device's clock.

The traced stretch is one whole ``generate`` (the harness's span
``hbench.turn``).  Its device-to-host copies are the served tokens
reaching the host, one a decode step: the first ends the prefill (which
the span's start begins), and each later one ends a decode step.  A
kernel belongs to the decode steps when it starts between the first and
the last of those copies.  ``None`` where the trace holds no whole turn.
"""


def turn_phases(run):
    """``(prefill_s, decode_s, steps, decode_kernels, prompt tokens a
    row, batch)`` of the traced turn, or ``None``."""
    tr, traffic = run["trace"], run["traffic"]
    if not tr or "batch" not in traffic:
        return None
    turns = [(s, e) for s, e, name in tr.get("spans", ()) if name == "hbench.turn"]
    if len(turns) != 1:
        return None
    start = turns[0][0]
    d2h = sorted(e for name, cat, s, e, span in tr["device"]
                 if cat == "gpu_memcpy" and "DtoH" in name and span == "hbench.turn")
    if len(d2h) != int(traffic["new_tokens"]):
        return None
    first, last = d2h[0], d2h[-1]
    kernels = sum(1 for name, cat, s, e, span in tr["device"] if cat == "kernel" and first < s < last)
    return ((first - start) * 1e-6, (last - first) * 1e-6, len(d2h) - 1, kernels,
            int(traffic["prompt_tokens"]), int(traffic["batch"]))
