"""rwkv6-7b "Finch" — attention-free, data-dependent decay.

[arXiv:2404.05892; hf]  32L, d_model=4096 (64 heads x 64), channel-mix
d_ff=14336, vocab=65536.  O(1) decode state => runs long_500k.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b",
        family="ssm",
        pattern=("rwkv",),
        repeats=32,
        d_model=4096,
        num_heads=64,       # informational; attention is never instantiated
        num_kv_heads=64,
        head_dim=64,
        d_ff=14336,
        vocab_size=65536,
        rwkv_heads=64,
        rwkv_decay_lora=64,
    )
