from repro_torch.metrics.logger import MetricsLogger, read_metrics
from repro_torch.metrics.spans import count, counters, span

__all__ = ["MetricsLogger", "read_metrics", "count", "counters", "span"]
