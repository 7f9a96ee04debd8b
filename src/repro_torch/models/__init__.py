"""Model stack of the port: the pattern-assembled models
(``models.model``) of every family — dense, MoE, hybrid Mamba, RWKV-6,
the whisper encoder-decoder and the pixtral vision frontend — their
training loss, attention and cross-attention, feed-forward, the
capacity-routed experts (``models.moe``), the selective scan
(``models.mamba``), the RWKV-6 time and channel mix (``models.rwkv``) and
shared primitives."""
from repro_torch.models.model import (
    Model,
    cache_specs,
    decode_step,
    forward_hidden,
    init_cache,
    init_model,
    loss_fn,
    param_specs,
    prefill,
)
from repro_torch.models.common import chunked_softmax_xent

__all__ = [
    "Model", "cache_specs", "chunked_softmax_xent", "decode_step", "forward_hidden", "init_cache",
    "init_model", "loss_fn", "param_specs", "prefill",
]
