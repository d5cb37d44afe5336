"""Append-only TSV training log, a byte-compatible copy of
``cldrd_tpu/utils/train_logs.py`` (reference ``nway_listwise_1.py:78-90``)
plus a structured JSONL sibling (SURVEY §5.5: "same TSV contract +
structured JSONL").

Columns: ``epoch step loss mrr@<k> recall@<k> lr [reg_loss total_aux_ratio]``,
one row per ``logging_steps`` window, header written on first append. The
JSONL file (``<filename>.jsonl``) carries the same fields as one object per
line for machine consumption.
"""
from __future__ import annotations

import json
import os
from typing import Optional


def write_train_logs(
    epoch: int,
    step: int,
    loss: float,
    mrr: float,
    recall: float,
    lr: float,
    filename: str,
    cutoff: int = 10,
    reg_loss: Optional[float] = None,
    total_aux_ratio: Optional[float] = None,
    jsonl: bool = True,
) -> None:
    if jsonl:
        record = {
            "epoch": epoch, "step": step, "loss": loss,
            f"mrr@{cutoff}": mrr, f"recall@{cutoff}": recall, "lr": lr,
        }
        if reg_loss is not None:
            record["reg_loss"] = reg_loss
            record["total_aux_ratio"] = total_aux_ratio
        with open(filename + ".jsonl", "a", encoding="utf-8") as f:
            f.write(json.dumps(record) + "\n")
    new_file = not os.path.exists(filename)
    with open(filename, "a", encoding="utf-8") as f:
        if new_file:
            header = ["epoch", "step", "loss", f"mrr@{cutoff}", f"recall@{cutoff}", "lr"]
            if reg_loss is not None:
                header += ["reg_loss", "total_aux_ratio"]
            f.write("\t".join(header) + "\n")
        row = [
            str(epoch),
            str(step),
            f"{loss:.6f}",
            f"{mrr:.6f}",
            f"{recall:.6f}",
            f"{lr:.8f}",
        ]
        if reg_loss is not None:
            row += [f"{reg_loss:.6f}", f"{total_aux_ratio:.6f}"]
        f.write("\t".join(row) + "\n")
