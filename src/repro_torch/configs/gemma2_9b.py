"""gemma2-9b — dense, local(4k window)/global alternating, logit softcaps.

[arXiv:2408.00118; hf]  42L, d_model=3584, 16H (GQA kv=8, hd=256),
d_ff=14336, vocab=256000.  Attention logit softcap 50, final logit softcap
30, embeddings scaled by sqrt(d), tied unembedding.  The local/global pair
is the scanned super-block (21 repeats).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b",
        family="dense",
        pattern=("local+mlp", "global+mlp"),
        repeats=21,
        d_model=3584,
        num_heads=16,
        num_kv_heads=8,
        head_dim=256,
        d_ff=14336,
        vocab_size=256000,
        attn_softcap=50.0,
        final_softcap=30.0,
        sliding_window=4096,
        embed_scale=True,
        tie_embeddings=True,
    )
