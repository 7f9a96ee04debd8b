"""Shape-and-dtype stand-ins for every model input (the dry-run contract).

Port of ``repro.launch.specs``: the same entries, shapes and dtypes as the
reference's ``jax.ShapeDtypeStruct`` trees (``int32`` tokens, ``float32``
mask, ``bfloat16`` ``patch_embeds`` and ``frames``; a vision config's
text takes ``S − frontend_tokens`` positions), as frozen :class:`Spec`
records that allocate nothing.  :meth:`Spec.empty` makes a tensor of the
spec on request (a ``meta`` tensor for the dry-run's pass).  Modality
frontends are stubs, as in the reference: whisper receives precomputed
frame embeddings, pixtral precomputed patch embeddings.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig

__all__ = [
    "Spec", "batch_logical_specs", "decode_input_specs", "prefill_input_specs", "train_input_specs",
]


@dataclasses.dataclass(frozen=True)
class Spec:
    """A tensor's shape and dtype, without a tensor."""

    shape: tuple[int, ...]
    dtype: torch.dtype

    def empty(self, device="meta") -> torch.Tensor:
        """An uninitialized tensor of this spec on ``device``."""
        return torch.empty(self.shape, dtype=self.dtype, device=device)


def _frontend(cfg: ModelConfig, B: int) -> dict:
    specs = {}
    if cfg.frontend == "vision":
        specs["patch_embeds"] = Spec((B, cfg.frontend_tokens, cfg.d_model), torch.bfloat16)
    if cfg.is_encoder_decoder:
        specs["frames"] = Spec((B, cfg.encoder_seq, cfg.d_model), torch.bfloat16)
    return specs


def _text_len(cfg: ModelConfig, S: int) -> int:
    return S - (cfg.frontend_tokens if cfg.frontend == "vision" else 0)


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    B, S = shape.global_batch, shape.seq_len
    return {
        "tokens": Spec((B, _text_len(cfg, S)), torch.int32),
        "targets": Spec((B, S), torch.int32),
        "mask": Spec((B, S), torch.float32),
        **_frontend(cfg, B),
    }


def batch_logical_specs(cfg: ModelConfig) -> dict:
    """Logical sharding for each batch entry (train/prefill)."""
    specs = {
        "tokens": ("act_batch", None),
        "targets": ("act_batch", None),
        "mask": ("act_batch", None),
    }
    if cfg.frontend == "vision":
        specs["patch_embeds"] = ("act_batch", None, None)
    if cfg.is_encoder_decoder:
        specs["frames"] = ("act_batch", None, None)
    return specs


def prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Prompt batch for the prefill step (no targets)."""
    B, S = shape.global_batch, shape.seq_len
    return {"tokens": Spec((B, _text_len(cfg, S)), torch.int32), **_frontend(cfg, B)}


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    B = shape.global_batch
    return {"token": Spec((B, 1), torch.int32), "pos": Spec((), torch.int32)}
