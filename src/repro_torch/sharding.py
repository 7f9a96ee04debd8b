"""Logical-axis sharding rules: DP / FSDP / TP / EP / SP / KV-seq CP.

Port of ``repro.sharding.Rules``: every parameter, cache and activation
leaf carries a tuple of *logical* axis names, and ``Rules`` maps them to
mesh axes per (mesh, shape kind, arch divisibility) with the reference's
table.  ``rules(logical)`` gives, per tensor dimension, what the
reference's ``PartitionSpec`` holds: a mesh axis name, a tuple of them, or
``None`` (replicated).  :meth:`Rules.placements` gives the same layout as
``torch.distributed.tensor`` placements, one per mesh dimension.

The mesh is anything with the mesh's axis names and sizes: a
``DeviceMesh`` (``mesh_dim_names``, ``shape``), or a stand-in with those
two attributes, as the tests use — building the table touches no device
and no process group.

Layout summary (the reference's): weights TP over "model" on
heads/mlp/experts/vocab dims and FSDP over "data" on the embed dim,
replicated over "pod"; activations batch over ("pod", "data"), the
residual stream sequence-sharded over "model" between blocks; decode KV
caches batch over ("pod", "data") and *sequence* over "model" (over
("data", "model") for ``decode_long``).  A logical axis whose size does
not divide its mesh axes degrades to replication (smollm's 9 heads),
listed by :meth:`Rules.degradations`.

The port's train step uses the ``act_batch`` entry (data parallelism);
placing parameters by these rules (FSDP, TP) is not done yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.configs.base import ModelConfig

__all__ = ["Rules"]


def _axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _mesh_size(sizes: dict[str, int], axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


@dataclasses.dataclass
class Rules:
    """Callable: logical-axis tuple → per-dimension mesh axes."""

    cfg: ModelConfig
    mesh: Any
    shape_kind: str  # train | prefill | decode | decode_long
    seq_len: int = 0
    fsdp: bool = True
    sequence_parallel: bool = True
    table: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        cfg, sizes = self.cfg, _axis_sizes(self.mesh)
        has_pod = "pod" in sizes
        model = "model" if "model" in sizes else None
        data = "data" if "data" in sizes else None
        dp = (("pod", "data") if has_pod else ("data",)) if data else None
        msize = _mesh_size(sizes, model)

        def tp_if(n: int):
            return model if model and n % max(msize, 1) == 0 else None

        decode = self.shape_kind in ("decode", "decode_long")
        long = self.shape_kind == "decode_long"

        # split-KV: the *sequence* dim of the KV cache carries the sharding
        kv_seq = ("data", "model") if long else (model,)
        batch_axes = None if long else dp

        self.table = {
            # ---- weights -------------------------------------------------
            "layers": None,
            "embed": (data if self.fsdp else None),
            "vocab": tp_if(cfg.vocab_size),
            "heads": tp_if(cfg.num_heads),
            "kv_heads": tp_if(cfg.num_kv_heads),
            "mlp": tp_if(cfg.d_ff),
            "experts": tp_if(max(cfg.num_experts, 1)),
            # the activation expert-dim pin: only when ≥ 2 experts land per device
            "experts_act": (
                model
                if model
                and cfg.num_experts >= 2 * max(msize, 1)
                and cfg.num_experts % max(msize, 1) == 0
                else None
            ),
            "expert_mlp": None,
            "mamba_inner": tp_if(cfg.mamba_expand * cfg.d_model),
            "rwkv_proj": tp_if(cfg.d_model),
            "rwkv_heads": tp_if(max(cfg.rwkv_heads, 1)),
            # ---- activations ----------------------------------------------
            "act_batch": batch_axes,
            "act_seq": (
                model
                if (
                    self.sequence_parallel
                    and not decode
                    and model
                    and self.seq_len % max(msize, 1) == 0
                )
                else None
            ),
            "enc_seq": None,  # whisper's 1500 frames: not 16-divisible
            # ---- decode caches ---------------------------------------------
            "batch_kv": batch_axes,
            "kv_seq": kv_seq,
            "kv_heads_cache": None,  # seq-sharding carries the memory
        }

    def __call__(self, logical: tuple) -> tuple:
        return tuple(None if name is None else self.table.get(name) for name in logical)

    def batch_axes(self) -> tuple[str, ...]:
        """The mesh axes ``act_batch`` splits over: data parallelism."""
        axes = self.table.get("act_batch")
        return (axes,) if isinstance(axes, str) else tuple(axes or ())

    def placements(self, logical: tuple) -> list:
        """The layout of :meth:`__call__` as DTensor placements, one per
        mesh dimension: ``Shard(i)`` where tensor dimension ``i`` is split
        over that mesh axis, else ``Replicate()``.  A dimension over several
        mesh axes is split over them in the mesh's order."""
        from torch.distributed.tensor import Replicate, Shard

        dims = {}
        for i, entry in enumerate(self(logical)):
            for ax in (entry,) if isinstance(entry, str) else (entry or ()):
                dims[ax] = i
        return [Shard(dims[ax]) if ax in dims else Replicate() for ax in self.mesh.mesh_dim_names]

    def degradations(self) -> list[str]:
        """Human-readable list of divisibility fallbacks (for the report)."""
        cfg, sizes = self.cfg, _axis_sizes(self.mesh)
        msize = _mesh_size(sizes, "model" if "model" in sizes else None)
        out = []
        for name, n in [
            ("heads", cfg.num_heads),
            ("kv_heads", cfg.num_kv_heads),
            ("vocab", cfg.vocab_size),
            ("mlp", cfg.d_ff),
        ]:
            if msize > 1 and n % msize != 0:
                out.append(f"{name}={n} !% model={msize} -> replicated")
        return out
