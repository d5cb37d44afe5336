"""Host-side TSV loaders for queries and passages (pure-Python copy of
the loaders in ``cldrd_tpu/data/loaders.py``)."""
from __future__ import annotations

from typing import Dict, Union

Passage = Union[str, Dict[str, str]]


def load_queries(path: str) -> Dict[int, str]:
    """TSV ``qid\\ttext`` -> {qid: text}."""
    out: Dict[int, str] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            qid, text = line.rstrip("\n").split("\t", 1)
            out[int(qid)] = text.strip()
    return out


def load_passages(path: str) -> Dict[int, Passage]:
    """TSV ``pid\\ttext`` or ``pid\\ttitle\\tpara`` -> {pid: text | {title, para}}."""
    out: Dict[int, Passage] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) == 2:
                out[int(parts[0])] = parts[1].strip()
            elif len(parts) == 3:
                out[int(parts[0])] = {"title": parts[1], "para": parts[2]}
            else:
                raise ValueError(f"illegal TSV row with {len(parts)} columns")
    return out


def passage_text(passage: Passage, sep_token: str = "[SEP]") -> str:
    """Normalize a passage record to plain text; titled passages are joined
    ``title [SEP] para``."""
    if isinstance(passage, str):
        return passage
    return passage["title"] + " " + sep_token + " " + passage["para"]
