from .meters import AverageMeter, MetricMonitor
from .train_logs import write_train_logs

__all__ = ["AverageMeter", "MetricMonitor", "write_train_logs"]
