"""Kernels the device ran a decode step in the traced turn: those that
started between the first and the last served token's copy to the host,
over the steps between them."""
from hbench.metrics._serve import turn_phases


def read(run):
    ph = turn_phases(run)
    if ph is None or ph[2] < 1:
        return None
    return ph[3] / ph[2]
