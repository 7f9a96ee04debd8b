"""deepseek-7b — llama-arch dense, full MHA (kv=32).

[arXiv:2401.02954; hf]  30L, d_model=4096, 32H (kv=32, hd=128),
d_ff=11008, vocab=102400.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b",
        family="dense",
        pattern=("attn+mlp",),
        repeats=30,
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,
        head_dim=128,
        d_ff=11008,
        vocab_size=102400,
    )
