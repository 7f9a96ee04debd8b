"""Rows the expert products computed for each token-slot the expert
layers routed: the program's ``moe.expert_rows`` over its
``moe.routed_slots`` (real tokens times the experts a token), over the
whole window, the captured decode steps' replays included.  1.0 where
each routed slot is computed once and nothing is padded; ``E / k`` where
every expert holds a place for every token.  ``None`` where the program
lacks either counter, or the window routed nothing."""


def read(run):
    c = run["counters"]
    rows, slots = c.get("moe.expert_rows"), c.get("moe.routed_slots")
    if rows is None or not slots:
        return None
    return rows / slots
