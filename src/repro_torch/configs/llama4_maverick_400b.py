"""llama4-maverick-400b-a17b — MoE 128e top-1, interleaved dense/MoE.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]  48L, d_model=5120,
40H (GQA kv=8, hd=128), d_ff=8192, vocab=202048, 128 experts top-1.
Dense/MoE layers alternate (as in the released Maverick checkpoints) —
this is what lands total params at ~400B with ~17B active; all-MoE at this
d_ff would exceed the published 400B.  "Early fusion" refers to the
multimodal token path; the assigned spec is the LM backbone, so inputs are
token ids (the frontend stub applies to pixtral/whisper only).  bf16
optimizer moments (optimizer_dtype) keep the single-pod (256-chip)
footprint under HBM — DESIGN.md §7.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        pattern=("attn+mlp", "attn+moe"),
        repeats=24,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202048,
        num_experts=128,
        num_experts_per_token=1,
        rope_theta=500000.0,
        optimizer_dtype="bfloat16",
    )
