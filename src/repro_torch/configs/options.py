"""Options of the port that the reference's ``ModelConfig`` lacks.

``ModelConfig`` and the registry are held equal to the JAX package's, so
what a published model needs beyond them lives here: ``PortConfig`` is a
``ModelConfig`` with four more fields, and :func:`option` reads one of
them from either class, a plain ``ModelConfig`` giving the default.  The
defaults are the reference's behaviour, bit for bit.

- ``positions``: ``"default"`` is RoPE, or sinusoidal positions added to
  the stream where ``use_rope`` is off; ``"none"`` adds no positions at
  all (Jamba's attention layers carry none), and needs ``use_rope`` off.
- ``mamba_dbc_norm``: an RMSNorm on Δ, B and C between the ``w_dbc``
  product and the scan (Jamba's ``dt_layernorm``, ``b_layernorm``,
  ``c_layernorm``), three more leaves a Mamba mixer.
- ``moe_renormalize``: the top-k gates divided by their sum; off, they are
  used as the softmax gives them.
- ``moe_dispatch``: ``"capacity"``, GShard's grouped capacity with one-hot
  dispatch (what the registry's configs train with); ``"dropless"``, every
  routed token-slot sorted by expert on the device and computed once
  through grouped products (``models.moe``).  Where the capacity is E/k or
  more neither drops a token and both give one output, but the capacity
  dispatch stays the one a config names: the reference's aux (its slots,
  pads included, and its routing's shape) holds it there, as
  ``tests/test_torch_moe.py::test_moe_dropless_at_high_capacity`` and the
  capacity-16 cases of ``tests/test_torch_models.py`` check.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig

__all__ = ["PortConfig", "option", "with_options"]

POSITIONS = ("default", "none")
DISPATCHES = ("capacity", "dropless")


@dataclasses.dataclass(frozen=True)
class PortConfig(ModelConfig):
    positions: str = "default"
    mamba_dbc_norm: bool = False
    moe_renormalize: bool = True
    moe_dispatch: str = "capacity"

    def __post_init__(self):
        if self.positions not in POSITIONS:
            raise ValueError(f"positions {self.positions!r} is none of {POSITIONS}")
        if self.positions == "none" and self.use_rope:
            raise ValueError("positions 'none' needs use_rope=False: RoPE is a position")
        if self.moe_dispatch not in DISPATCHES:
            raise ValueError(f"moe_dispatch {self.moe_dispatch!r} is none of {DISPATCHES}")


_DEFAULTS = {f.name: f.default for f in dataclasses.fields(PortConfig) if f.name not in
             {g.name for g in dataclasses.fields(ModelConfig)}}


def option(cfg: ModelConfig, name: str):
    """``cfg``'s value of the port option ``name``; its default where
    ``cfg`` is a plain ``ModelConfig``."""
    return getattr(cfg, name, _DEFAULTS[name])


def with_options(cfg: ModelConfig, **options) -> PortConfig:
    """``cfg`` as a ``PortConfig`` with ``options`` (port options or
    ``ModelConfig`` fields) replaced."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return PortConfig(**{**fields, **options})
