"""smollm-135m — llama-arch small dense model.

[hf:HuggingFaceTB/SmolLM-135M; hf]  30L, d_model=576, 9H (GQA kv=3, hd=64),
d_ff=1536, vocab=49152, tied embeddings.  9 heads do not divide a 16-way TP
axis: attention weights replicate over "model" (DESIGN.md §7) while the MLP
and vocab dims still shard.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m",
        family="dense",
        pattern=("attn+mlp",),
        repeats=30,
        d_model=576,
        num_heads=9,
        num_kv_heads=3,
        head_dim=64,
        d_ff=1536,
        vocab_size=49152,
        tie_embeddings=True,
    )
