from repro_torch.metrics.logger import MetricsLogger, read_metrics

__all__ = ["MetricsLogger", "read_metrics"]
