"""Faults of the ``jamba2_mini`` configuration: each puts back one
departure from the published model that the port's options remove, and
turns a sound run of ``jamba2_mini.offline`` into one that ``correct``
must call wrong.  Each works on the device alone, so a captured decode
step runs it too.

``CASES`` is empty: ``tests/test_torch_jamba2.py`` runs each of these at
the cell's tiny size; ``control.py --fault`` plants one at its full size.
"""
import dataclasses

from repro_torch.models import mamba, model, moe


def state_not_carried(real):
    """Every Mamba decode step hands its state back as it found it: each
    token reads the prefill's state."""
    def step(cfg, p, x, cache):
        out, new = real(cfg, p, x, cache)
        return out, {**new, "h": cache["h"]}
    return step


def with_field(real, **fields):
    """``real(cfg, ...)`` on ``cfg`` with ``fields`` replaced."""
    return lambda cfg, *a: real(dataclasses.replace(cfg, **fields), *a)


FAULTS = {
    "mamba_state_not_carried": lambda mp: mp.setattr(mamba, "decode_mamba_step",
                                                     state_not_carried(mamba.decode_mamba_step)),
    "gates_renormalised": lambda mp: mp.setattr(moe, "_top_k", with_field(moe._top_k, moe_renormalize=True)),
    # sinusoidal positions added to the stream, in the prefill and at every decode step
    "positions_added": lambda mp: mp.setattr(model, "_sinusoidal", lambda cfg: True),
    "dt_bc_norms_skipped": lambda mp: mp.setattr(mamba, "_ssm_inputs",
                                                 with_field(mamba._ssm_inputs, mamba_dbc_norm=False)),
}
CASES = []
