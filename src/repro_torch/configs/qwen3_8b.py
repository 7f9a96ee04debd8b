"""qwen3-8b — dense GQA with per-head qk RMS-norm.

[hf:Qwen/Qwen3-8B; hf]  36L, d_model=4096, 32H (GQA kv=8, hd=128),
d_ff=12288, vocab=151936.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b",
        family="dense",
        pattern=("attn+mlp",),
        repeats=36,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=12288,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1000000.0,
    )
