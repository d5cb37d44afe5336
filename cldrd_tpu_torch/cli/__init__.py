"""Command-line entry points: ``python -m cldrd_tpu_torch.cli.{index,retrieve,evaluate}``."""
