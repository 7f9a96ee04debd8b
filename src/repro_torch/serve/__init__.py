"""Serving plane of the port: the crash-recoverable ``HistogramService``
(with WAL shipping to replicas and failover) and the standing-query
subscription plane."""
from repro_torch.serve.service import HistogramService
from repro_torch.serve.subscriptions import (
    POLICIES,
    Subscription,
    SubscriptionPlane,
    Update,
)

__all__ = [
    "HistogramService",
    "POLICIES",
    "Subscription",
    "SubscriptionPlane",
    "Update",
]
