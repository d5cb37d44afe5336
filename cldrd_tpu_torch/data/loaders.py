"""Host-side TSV / JSONL loaders for queries, passages and teacher
rankings (pure-Python copy of ``cldrd_tpu/data/loaders.py``)."""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional, Union

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


def iter_jsonl(path: str, rank: int = -1,
               nranks: Optional[int] = None) -> Iterable[dict]:
    """Stream a JSONL file; with ``rank >= 0`` yield only the lines where
    ``line_idx % nranks == rank``."""
    if rank >= 0:
        assert nranks and 0 <= rank < nranks
    with open(path, "r", encoding="utf-8") as f:
        for line_idx, line in enumerate(f):
            if rank >= 0 and line_idx % nranks != rank:
                continue
            yield json.loads(line)


def load_train_examples(path: str, fmt: str = "relT_most_semi_hard",
                        rank: int = -1,
                        nranks: Optional[int] = None) -> List[Dict[str, Any]]:
    """Teacher-ranking training files -> ``{qid, relT_pids, neg_pids}``
    examples (plus ``relT_scores``/``neg_scores`` when the file has them).

    fmt: ``json`` (one array of canonical examples), ``jsonl`` (one per
    line), ``rel_pid`` (JSONL with one ``rel_pid``), or
    ``relT_most_semi_hard`` (JSONL; negatives are most_hard + semi_hard).
    """
    if fmt == "json":
        with open(path, "r", encoding="utf-8") as f:
            examples = json.load(f)
        if rank >= 0:
            examples = [e for i, e in enumerate(examples)
                        if i % nranks == rank]
        return examples
    out: List[Dict[str, Any]] = []
    for example in iter_jsonl(path, rank, nranks):
        if fmt == "jsonl":
            out.append(example)
        elif fmt == "rel_pid":
            assert "relT_pids" not in example and "rel_pid" in example
            example["relT_pids"] = [example.pop("rel_pid")]
            example.setdefault("neg_pids", [])
            out.append(example)
        elif fmt == "relT_most_semi_hard":
            canonical = {
                "qid": example["qid"],
                "relT_pids": example["relT_pids"],
                "neg_pids": example.get("most_hard_pids", [])
                + example.get("semi_hard_pids", []),
            }
            if "relT_scores" in example:
                canonical["relT_scores"] = example["relT_scores"]
                canonical["neg_scores"] = example.get(
                    "most_hard_scores", []) + example.get(
                    "semi_hard_scores", [])
            out.append(canonical)
        else:
            raise ValueError(f"unknown training-file format {fmt!r}")
    return out
