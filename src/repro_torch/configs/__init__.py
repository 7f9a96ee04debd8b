"""Configurations of the port (copies; nothing imported from
``repro.configs``): the architecture registry (``--arch <id>`` resolves
here) and the paper's log-statistics workload."""
from repro_torch.configs import (
    dbrx_132b,
    deepseek_7b,
    gemma2_9b,
    jamba_v0_1_52b,
    llama4_maverick_400b,
    pixtral_12b,
    qwen3_8b,
    rwkv6_7b,
    smollm_135m,
    whisper_medium,
)
from repro_torch.configs.base import (
    SHAPES,
    ModelConfig,
    ShapeConfig,
    shape_applicable,
    smoke,
)
from repro_torch.configs.paper_logstats import LogStatsConfig, config

REGISTRY = {
    "jamba-v0.1-52b": jamba_v0_1_52b.config,
    "smollm-135m": smollm_135m.config,
    "deepseek-7b": deepseek_7b.config,
    "gemma2-9b": gemma2_9b.config,
    "qwen3-8b": qwen3_8b.config,
    "dbrx-132b": dbrx_132b.config,
    "llama4-maverick-400b-a17b": llama4_maverick_400b.config,
    "rwkv6-7b": rwkv6_7b.config,
    "whisper-medium": whisper_medium.config,
    "pixtral-12b": pixtral_12b.config,
}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]()


def list_archs() -> list[str]:
    return sorted(REGISTRY)


__all__ = [
    "LogStatsConfig", "ModelConfig", "REGISTRY", "SHAPES", "ShapeConfig",
    "config", "get_config", "list_archs", "shape_applicable", "smoke",
]
