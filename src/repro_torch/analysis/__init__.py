"""The port's copy of the runtime lock-discipline witness
(:mod:`repro_torch.analysis.witness`)."""
from repro_torch.analysis.witness import (  # noqa: F401
    LockOrderError,
    OrderedLock,
    OrderedRLock,
    RANKS,
    arm,
    armed,
    disarm,
)
