"""The port's optimizer plane (``repro.optim`` on PyTorch): AdamW with
histogram-quantile clipping and histogram-threshold compression."""
from repro_torch.optim.adamw import (
    OptimizerConfig,
    adamw_update,
    clip_grads,
    init_opt_state,
    lr_schedule,
    opt_state_specs,
)
from repro_torch.optim.compression import (
    CompressionConfig,
    compress_grads,
    init_residual,
)

__all__ = [
    "OptimizerConfig", "adamw_update", "clip_grads", "init_opt_state",
    "lr_schedule", "opt_state_specs",
    "CompressionConfig", "compress_grads", "init_residual",
]
