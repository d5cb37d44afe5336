"""Random-access id -> passage text over a TSV corpus, without loading it
(copy of ``cldrd_tpu/data/docstore.py``).

``load_passages`` reads the whole collection into a dict (~3 GB of host
RAM for the 8.8M-passage MS MARCO TSV). A serving daemon that reranks
the top-k of each request touches a few thousand rows an hour;
``TsvDocStore`` gives those lookups O(log n) per id over an mmap'd file.

Layout contract (same as ``load_passages``): ``pid\ttext`` or
``pid\ttitle\tpara`` rows, ``\n`` terminated. The first open builds a
sidecar ``<path>.docstore.npz`` (version 1: int64 line offsets + parsed
ids) so reopening is instant; the sidecar is invalidated by file size +
mtime. Both packages write and reuse the same sidecar.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, Iterable, List, Union

import numpy as np

Passage = Union[str, Dict[str, str]]

logger = logging.getLogger(__name__)

_SIDECAR_VERSION = 1


def _sidecar_path(path: str) -> str:
    return path + ".docstore.npz"


def _scan_tsv(data: np.ndarray) -> tuple:
    """One pass over the mmap'd bytes: line spans + the id column.

    Returns (ids int64 [n], starts int64 [n], ends int64 [n]) where line i
    is ``data[starts[i]:ends[i]]`` (newline excluded). Vectorized newline /
    tab discovery; the int parse itself is a Python loop — one-time work,
    amortized away by the sidecar.
    """
    if data.size == 0:
        e = np.empty(0, np.int64)
        return e, e.copy(), e.copy()
    newlines = np.flatnonzero(data == 0x0A).astype(np.int64)
    if data[-1] != 0x0A:  # tolerate a missing trailing newline
        newlines = np.append(newlines, data.size)
    starts = np.empty_like(newlines)
    starts[0] = 0
    starts[1:] = newlines[:-1] + 1
    ends = newlines
    tabs = np.flatnonzero(data == 0x09).astype(np.int64)
    idx = np.searchsorted(tabs, starts)
    if np.any(idx >= tabs.size):
        raise ValueError(
            f"line {int(np.argmax(idx >= tabs.size))}: no tab separator "
            "— not a pid\\ttext TSV"
        )
    first_tab = tabs[idx]
    if np.any(first_tab >= ends):
        raise ValueError(
            f"line {int(np.argmax(first_tab >= ends))}: no tab separator "
            "— not a pid\\ttext TSV"
        )
    view = data.tobytes()  # bytes slicing below is ~3x memmap fancy-indexing
    ids = np.fromiter(
        (int(view[s:t]) for s, t in zip(starts, first_tab)),
        dtype=np.int64,
        count=len(starts),
    )
    return ids, starts, ends


class TsvDocStore:
    """mmap-backed ``{pid -> passage}`` lookups over a passages TSV.

    ``get``/``get_many`` return the same ``Passage`` values as
    ``load_passages`` (plain text, or ``{"title", "para"}`` for 3-column
    rows), so ``passage_text`` and every downstream consumer work
    unchanged.
    """

    def __init__(self, path: str, sidecar: bool = True):
        self.path = path
        self._data = np.memmap(path, dtype=np.uint8, mode="r")
        st = os.stat(path)
        ids = starts = ends = None
        sc = _sidecar_path(path)
        if sidecar and os.path.exists(sc):
            try:
                with np.load(sc) as z:
                    if (
                        int(z["version"]) == _SIDECAR_VERSION
                        and int(z["size"]) == st.st_size
                        and int(z["mtime_ns"]) == st.st_mtime_ns
                    ):
                        ids, starts, ends = z["ids"], z["starts"], z["ends"]
                    else:
                        logger.info("stale docstore sidecar %s: rebuilding", sc)
            except (OSError, KeyError, ValueError) as e:
                logger.warning("unreadable docstore sidecar %s (%s): "
                               "rebuilding", sc, e)
        if ids is None:
            ids, starts, ends = _scan_tsv(self._data)
            if sidecar:
                # .npz suffix keeps np.savez from renaming; atomic publish
                tmp = sc + ".tmp.npz"
                np.savez(
                    tmp, version=_SIDECAR_VERSION, size=st.st_size,
                    mtime_ns=st.st_mtime_ns, ids=ids, starts=starts, ends=ends,
                )
                os.replace(tmp, sc)
        if len(np.unique(ids)) != len(ids):
            raise ValueError(f"{path}: duplicate passage ids")
        self._order = np.argsort(ids).astype(np.int64)
        self._sorted_ids = ids[self._order]
        self._starts = starts
        self._ends = ends

    def __len__(self) -> int:
        return int(self._sorted_ids.size)

    def __contains__(self, pid: int) -> bool:
        i = int(np.searchsorted(self._sorted_ids, int(pid)))
        return i < len(self) and int(self._sorted_ids[i]) == int(pid)

    def _rows(self, pids: np.ndarray) -> np.ndarray:
        pos = np.searchsorted(self._sorted_ids, pids)
        ok = (pos < len(self)) & (
            self._sorted_ids[np.minimum(pos, len(self) - 1)] == pids
        )
        if not np.all(ok):
            missing = pids[~ok][:8].tolist()
            raise KeyError(
                f"{len(pids) - int(ok.sum())} passage id(s) not in "
                f"{self.path} (first few: {missing})"
            )
        return self._order[pos]

    def _decode(self, row: int) -> Passage:
        s, e = int(self._starts[row]), int(self._ends[row])
        parts = bytes(self._data[s:e]).decode("utf-8").rstrip("\r").split("\t")
        if len(parts) == 2:
            return parts[1].strip()
        if len(parts) == 3:
            return {"title": parts[1], "para": parts[2]}
        raise ValueError(
            f"{self.path} row at byte {s}: illegal TSV row with "
            f"{len(parts)} columns"
        )

    def get(self, pid: int) -> Passage:
        return self._decode(int(self._rows(np.asarray([int(pid)]))[0]))

    def get_many(self, pids: Iterable[int]) -> List[Passage]:
        """Passages for ``pids``, in request order. KeyError if any id is
        absent (serving turns that into a 400, naming the ids)."""
        arr = np.asarray([int(p) for p in pids], dtype=np.int64)
        if arr.size == 0:
            return []
        return [self._decode(int(r)) for r in self._rows(arr)]
