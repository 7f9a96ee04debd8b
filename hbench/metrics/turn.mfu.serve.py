"""The whole turn's share of the H100's dense bfloat16 peak: the model
operations of the window's turns that the profiler did not record
(``model_cost.turn_flops``: the prefill and the decode steps whose tokens
are served) over those turns' time on the host's clock, in %.  The traced
turn is left out, with its time: the profiler's cost a launch would
otherwise set the share.  Bounds every kernel's share; ``None`` off the
card, or where every turn was traced."""
from hbench import model_cost


def read(run):
    c, t = run["counters"], run["traffic"]
    if run.get("platform") != "gpu" or not c.get("plain_turns") or not c.get("plain_s"):
        return None
    flops = c["plain_turns"] * model_cost.turn_flops(run["config"], int(t["batch"]), int(t["prompt_tokens"]),
                                                     int(t["new_tokens"]))
    return 100.0 * flops / (c["plain_s"] * model_cost.PEAK_BF16_FLOPS)
