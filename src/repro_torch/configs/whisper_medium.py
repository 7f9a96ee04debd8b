"""whisper-medium — encoder-decoder, conv frontend stubbed.

[arXiv:2212.04356; unverified]  24 encoder + 24 decoder layers,
d_model=1024, 16H (kv=16, hd=64), d_ff=4096, vocab=51865 (padded to 51872
for clean 16-way vocab sharding — Megatron-style padding, noted).  The
conv1d audio frontend is a STUB per the assignment: input_specs() provides
precomputed frame embeddings (B, 1500, d).  Sinusoidal positions, LayerNorm,
ungated GELU FFN; decode shapes exercise the decoder self-attn KV cache +
cross-attention to the stub encoder states.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium",
        family="audio",
        pattern=("attn+cross+mlp",),
        repeats=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        vocab_size=51872,
        use_rope=False,
        norm_type="layernorm",
        norm_eps=1e-5,
        encoder_layers=24,
        encoder_seq=1500,
        frontend="audio",
        tie_embeddings=True,
    )
