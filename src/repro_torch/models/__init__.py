"""Model stack of the port: the dense pattern-assembled transformers
(``models.model``), their attention, feed-forward and shared primitives."""
from repro_torch.models.model import (
    Model,
    decode_step,
    forward_hidden,
    init_cache,
    init_model,
    prefill,
)

__all__ = [
    "Model", "decode_step", "forward_hidden", "init_cache", "init_model", "prefill",
]
