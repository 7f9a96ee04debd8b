"""The traced turn's prefill scans against the H100's memory bandwidth:
the least bytes of every Mamba layer's scan (:func:`scan_bytes`) at 3.35
TB/s, over the device time of the work launched inside the program span
``mamba.scan`` during the prefill (from the turn's start to its first
served token's copy to the host), in %.

The span runs from a mixer's post-convolution input ``x1`` to its scan
output ``y``: the Δ, B and C projections and norms, then the chunked
scan.  So the least bytes are what goes in and out of it once:

- ``x1`` read and ``y`` written, ``d_inner`` values a token each, in the
  served dtype (Δ, B and C are made from ``x1`` inside the span and count
  nothing of their own);
- the two projections read once, ``d_inner × (dt_rank + 2 · d_state)``
  and ``dt_rank × d_inner``, in the served dtype;
- the final state written once, ``d_inner × d_state`` in float32 a row
  (the prefill starts from a zero state, which it does not read).

``None`` where the trace holds no whole turn, or nothing ran under the
span (a program without it).
"""
from hbench import cost, model_cost
from hbench.metrics._serve import turn_phases


def scan_bytes(c: dict, batch: int, prompt: int, dtype: str) -> float:
    """One Mamba layer's prefill scan of ``batch`` rows of ``prompt``
    tokens, in bytes."""
    w = model_cost.DTYPE_BYTES[dtype]
    di, n, r = int(c["mamba_expand"]) * int(c["hidden_size"]), int(c["mamba_d_state"]), int(c["mamba_dt_rank"])
    return 2.0 * batch * prompt * di * w + (di * (r + 2 * n) + r * di) * w + batch * di * n * 4.0


def read(run):
    ph = turn_phases(run)
    tr = run["trace"]
    if ph is None or ph[0] <= 0:
        return None
    prefill_s, _, _, _, prompt, batch = ph
    start = next(s for s, e, name in tr["spans"] if name == "hbench.turn")
    end = start + prefill_s * 1e6
    busy = sum(e - s for (name, cat, s, e, span), program in zip(tr["device"], tr.get("program_spans", ()))
               if program == "mamba.scan" and start <= s < end) * 1e-6
    if busy <= 0:
        return None
    c = run["config"]
    layers = sum(1 for kind in model_cost.layer_kinds(c) if "mamba" in kind.split("+"))
    return 100.0 * cost.least_seconds(layers * scan_bytes(c, batch, prompt, c["torch_dtype"])) / busy
