"""The traced turn's prefill against the H100's dense bfloat16 peak: the
prefill's model operations (``model_cost.prefill_flops``) over the time
from the turn's start to its first served token on the host (the first
device-to-host copy), in %."""
from hbench import model_cost
from hbench.metrics._serve import turn_phases


def read(run):
    ph = turn_phases(run)
    if ph is None or ph[0] <= 0:
        return None
    prefill_s, _, _, _, prompt, batch = ph
    return 100.0 * model_cost.prefill_flops(run["config"], batch, prompt) / (prefill_s * model_cost.PEAK_BF16_FLOPS)
