from repro_torch.metrics.logger import MetricsLogger

__all__ = ["MetricsLogger"]
