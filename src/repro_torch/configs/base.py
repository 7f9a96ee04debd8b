"""Config system: architectures, input shapes, smoke reductions.

A copy of the reference's ``repro.configs.base`` (JAX-free, but copied so
that the port imports nothing of ``repro``).  Every architecture is a
``ModelConfig`` built from a repeating layer ``pattern`` whose parameters
are stacked over ``repeats``.  ``smoke()`` derives a reduced same-family
config for CPU tests.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

LayerKind = Literal[
    "attn+mlp", "attn+moe", "local+mlp", "global+mlp",
    "mamba+mlp", "mamba+moe", "rwkv", "attn+cross+mlp",
]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    pattern: tuple[str, ...]
    repeats: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention variants
    qk_norm: bool = False
    attn_softcap: float | None = None
    final_softcap: float | None = None
    sliding_window: int | None = None
    rope_theta: float = 10000.0
    use_rope: bool = True
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-6
    embed_scale: bool = False  # gemma: scale embeddings by sqrt(d)
    tie_embeddings: bool = False
    # MoE
    num_experts: int = 0
    num_experts_per_token: int = 0
    moe_group_size: int = 512
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    moe_z_weight: float = 1e-3
    # Mamba
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_chunk: int = 256
    mamba_scan_dtype: str = "float32"  # bf16 halves scan traffic (§Perf P6)
    # RWKV
    rwkv_heads: int = 0
    rwkv_decay_lora: int = 64
    rwkv_chunk: int = 256
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0  # stub frame-embedding count
    # modality frontend stubs
    frontend: str | None = None  # None | "audio" | "vision"
    frontend_tokens: int = 0  # vision: patch embeddings prepended to stream
    # execution
    attn_q_chunk: int = 512
    scan_unroll: int = 1  # dry-run costing: full unroll for exact HLO counts
    loss_chunk: int = 512
    remat_policy: str = "full"  # none | full | dots
    compute_dtype: str = "bfloat16"
    optimizer_dtype: str = "float32"  # bf16 moments for the 400B config

    @property
    def num_layers(self) -> int:
        return len(self.pattern) * self.repeats

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return not any(
            k.split("+")[0] in ("attn", "local", "global")
            for k in self.pattern
        )

    @property
    def has_subquadratic_path(self) -> bool:
        """Eligible for long_500k: SSM/hybrid/linear-attn or local+global."""
        kinds = {k.split("+")[0] for k in self.pattern}
        if kinds & {"mamba", "rwkv"}:
            return True
        return "local" in kinds  # gemma-2 alternation: half the layers local

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + unembed)."""
        d, f, V = self.d_model, self.d_ff, self.vocab_size
        total = V * d * (1 if self.tie_embeddings else 2)
        attn = d * self.num_heads * self.head_dim + 2 * (
            d * self.num_kv_heads * self.head_dim
        ) + self.num_heads * self.head_dim * d
        mlp = (2 if self.norm_type == "layernorm" else 3) * d * f
        moe = self.num_experts * 3 * d * f + d * self.num_experts
        d_in = self.mamba_expand * d
        mamba = (
            2 * d * d_in + d_in * self.mamba_d_conv
            + d_in * (max(d // 16, 1) + 2 * self.mamba_d_state)
            + max(d // 16, 1) * d_in + d_in * self.mamba_d_state
            + d_in * d
        )
        rwkv_tm = 5 * d * d + 2 * d * self.rwkv_decay_lora
        rwkv_cm = 2 * d * f + d * d
        for kind in self.pattern:
            for part in kind.split("+"):
                total += {
                    "attn": attn, "local": attn, "global": attn,
                    "cross": attn, "mlp": mlp, "moe": moe,
                    "mamba": mamba, "rwkv": rwkv_tm + rwkv_cm,
                }[part] * self.repeats
        if self.encoder_layers:
            total += self.encoder_layers * (attn + mlp)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts instead of all E)."""
        if self.num_experts == 0:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        full_moe = self.num_experts * 3 * d * f
        active_moe = self.num_experts_per_token * 3 * d * f
        n_moe_layers = sum(
            1 for k in self.pattern if "moe" in k
        ) * self.repeats
        return self.param_count() - n_moe_layers * (full_moe - active_moe)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode | decode_long


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode_long"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(applicable, reason) — the DESIGN.md §6 skip rules."""
    if shape.kind == "decode_long" and not cfg.has_subquadratic_path:
        return False, "pure full-attention arch: 500k decode KV excluded by assignment"
    return True, ""


def smoke(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    heads = 4
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        repeats=1,
        d_model=128,
        num_heads=heads,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        sliding_window=32 if cfg.sliding_window else None,
        num_experts=4 if cfg.num_experts else 0,
        num_experts_per_token=min(cfg.num_experts_per_token, 2)
        if cfg.num_experts
        else 0,
        moe_group_size=16,
        mamba_d_state=8,
        mamba_chunk=8,
        mamba_scan_dtype="float32",  # smoke = full precision everywhere
        rwkv_heads=4 if cfg.rwkv_heads else 0,
        rwkv_decay_lora=8,
        rwkv_chunk=8,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_seq=16 if cfg.encoder_layers else 0,
        frontend_tokens=8 if cfg.frontend_tokens else 0,
        attn_q_chunk=16,
        loss_chunk=16,
        remat_policy="none",
        compute_dtype="float32",
    )
