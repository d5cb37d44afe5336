from .meters import AverageMeter, MetricMonitor
from .profiling import PhaseTimer, Throughput, annotate, trace
from .train_logs import write_train_logs

__all__ = [
    "AverageMeter",
    "MetricMonitor",
    "write_train_logs",
    "PhaseTimer",
    "Throughput",
    "annotate",
    "trace",
]
