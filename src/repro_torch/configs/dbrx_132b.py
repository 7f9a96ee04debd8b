"""dbrx-132b — fine-grained MoE, 16 experts top-4.

[hf:databricks/dbrx-base; unverified]  40L, d_model=6144, 48H (GQA kv=8,
hd=128), d_ff=10752 per expert, vocab=100352.  Every layer is MoE.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b",
        family="moe",
        pattern=("attn+moe",),
        repeats=40,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=10752,
        vocab_size=100352,
        num_experts=16,
        num_experts_per_token=4,
        # §Perf P5: C = g·k·cf/E; g=512 gave C=160 and a one-hot dispatch
        # einsum 16× the expert FFN flops. g=128 → C=40 (4× less dispatch
        # compute) with 25% capacity headroom at k=4.
        moe_group_size=128,
        rope_theta=500000.0,
    )
