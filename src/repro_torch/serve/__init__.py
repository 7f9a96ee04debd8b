"""Serving plane of the port: the model-serving ``Engine`` (prefill/decode
with histogram-calibrated int8 scales), the crash-recoverable
``HistogramService`` (with WAL shipping to replicas and failover) and the
standing-query subscription plane."""
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.service import HistogramService
from repro_torch.serve.subscriptions import (
    POLICIES,
    Subscription,
    SubscriptionPlane,
    Update,
)

__all__ = [
    "Engine",
    "HistogramService",
    "POLICIES",
    "ServeConfig",
    "Subscription",
    "SubscriptionPlane",
    "Update",
]
