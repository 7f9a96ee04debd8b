"""The port's data plane (``repro.data`` on PyTorch)."""
from repro_torch.data.pipeline import LengthBucketer, SyntheticLM, shard_batch

__all__ = ["LengthBucketer", "SyntheticLM", "shard_batch"]
