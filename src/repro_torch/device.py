"""Where the port's public functions run.

Every public entry point runs on the card unless the caller asks for the
CPU: input that is not a tensor (a NumPy array, a list, a scalar) goes to
``"cuda"`` by default, and a ``device=`` keyword names another device.
Without a card the default raises instead of falling back to the CPU, so a
run never measures or serves the plain versions by accident.  A tensor
stays where it lies.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["as_tensor", "home", "resolve_device"]

# 64-bit host arrays are taken as 32 bits, as the reference's
# ``jnp.asarray`` (x64 off) takes them
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32}


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on the GPU by default and CUDA is not available "
            "here; pass device='cpu' to run the plain versions"
        )
    return dev


def home(*xs, device=None):
    """The device for a call on ``xs``: ``device`` if given, else that of
    the first tensor among ``xs``, else ``None`` (the card)."""
    if device is not None:
        return device
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return None


def as_tensor(x, device=None) -> torch.Tensor:
    """``x`` as a tensor.  A tensor moves only when ``device`` is given;
    anything else is narrowed from 64 to 32 bits and placed on ``device``
    (``None`` → the card, :func:`resolve_device`)."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    a = np.asarray(x)
    if a.dtype in _NARROW:
        a = a.astype(_NARROW[a.dtype])
    elif not a.flags.writeable:  # torch tensors may not alias read-only memory
        a = a.copy()
    return torch.as_tensor(a, device=resolve_device(device))
