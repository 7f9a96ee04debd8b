"""The traced turn's decode steps against the H100's memory bandwidth:
the bytes each step must read (``model_cost.decode_bytes``: the weights
in the served dtype, the KV cache up to the step's position) at 3.35
TB/s, over the time between the first and the last served token's copy
to the host, in %.  Step ``k`` of those runs at position
``prompt + k - 1``."""
from hbench import cost, model_cost
from hbench.metrics._serve import turn_phases


def read(run):
    ph = turn_phases(run)
    if ph is None or ph[2] < 1 or ph[1] <= 0:
        return None
    _, decode_s, steps, _, prompt, batch = ph
    dtype = run["config"]["torch_dtype"]
    need = sum(model_cost.decode_bytes(run["config"], batch, prompt + k - 1, dtype) for k in range(1, steps + 1))
    return 100.0 * cost.least_seconds(need) / decode_s
