"""Model stack of the port: the pattern-assembled transformers
(``models.model``) of the dense, MoE and hybrid Mamba families, their
training loss, attention, feed-forward, the capacity-routed experts
(``models.moe``), the selective scan (``models.mamba``) and shared
primitives."""
from repro_torch.models.model import (
    Model,
    decode_step,
    forward_hidden,
    init_cache,
    init_model,
    loss_fn,
    prefill,
)
from repro_torch.models.common import chunked_softmax_xent

__all__ = [
    "Model", "chunked_softmax_xent", "decode_step", "forward_hidden", "init_cache",
    "init_model", "loss_fn", "prefill",
]
