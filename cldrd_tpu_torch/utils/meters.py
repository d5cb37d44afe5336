"""Running-average meters and step-keyed metric tables.

Copy of ``cldrd_tpu/utils/meters.py``; parity with the reference
``utils/average_meter.py`` and ``utils/metric_monitor.py:4-38`` (the dead ``MetricMonitor_old`` and the
duplicate copy in ``utils/utils.py`` are not reproduced).
"""
from __future__ import annotations

from typing import Dict, List


class AverageMeter:
    """Classic val/sum/count/avg windowed meter."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val: float, n: int = 1) -> None:
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class MetricMonitor:
    """Step-keyed metric table -> aligned TSV string / file."""

    def __init__(self):
        self._rows: Dict[int, Dict[str, float]] = {}
        self._columns: List[str] = []

    def update(self, step: int, **metrics: float) -> None:
        row = self._rows.setdefault(int(step), {})
        for name, value in metrics.items():
            if name not in self._columns:
                self._columns.append(name)
            row[name] = float(value)

    def to_tsv(self) -> str:
        lines = ["\t".join(["step"] + self._columns)]
        for step in sorted(self._rows):
            row = self._rows[step]
            cells = [str(step)] + [
                f"{row[c]:.6f}" if c in row else "" for c in self._columns
            ]
            lines.append("\t".join(cells))
        return "\n".join(lines) + "\n"

    def write(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.to_tsv())
