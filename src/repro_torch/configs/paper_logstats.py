"""The paper's own workload config: log-analytics histogram framework.

Not an LM — this configures the Summarizer/Merger deployment of the paper
(partition count, T, beta per the paper's experiments: B=254 Oracle-default
query buckets, T = B*254*2^n summary sizes, 31 daily partitions of the
January-2015 Wikipedia pageview workload, Gumbel-skewed synthetic).
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class LogStatsConfig:
    name: str = "paper-logstats"
    beta: int = 254                 # final histogram buckets (Oracle default)
    T_factor: int = 8               # T = beta * T_factor
    num_partitions: int = 31        # one month of daily logs
    tuples_per_partition: int = 200_000
    distribution: str = "gumbel"    # gumbel | wiki_pagesize
    seed: int = 0

    @property
    def T(self) -> int:
        return self.beta * self.T_factor


def config() -> LogStatsConfig:
    return LogStatsConfig()
