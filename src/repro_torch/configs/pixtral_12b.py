"""pixtral-12b — VLM: pixtral-ViT frontend STUB + mistral-nemo decoder.

[hf:mistralai/Pixtral-12B-2409; unverified]  40L, d_model=5120, 32H
(GQA kv=8, hd=128), d_ff=14336, vocab=131072.  The ViT frontend is a STUB
per the assignment: input_specs() provides precomputed patch embeddings
(B, 1024, d) that are prepended to the token stream (1D RoPE over the fused
sequence — the 2D image RoPE is a frontend concern, noted in DESIGN.md).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b",
        family="vlm",
        pattern=("attn+mlp",),
        repeats=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=131072,
        rope_theta=1000000.0,
        frontend="vision",
        frontend_tokens=1024,
    )
