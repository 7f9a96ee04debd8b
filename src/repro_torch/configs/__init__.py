"""Workload configurations of the port (copies; nothing imported from
``repro.configs``)."""
from repro_torch.configs.paper_logstats import LogStatsConfig, config

__all__ = ["LogStatsConfig", "config"]
