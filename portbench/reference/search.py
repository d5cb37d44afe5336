"""Exact inner-product search over an int8 store, in plain float32.

``quantize`` is per-row symmetric int8: scale ``max|row| / 127`` (1 for
a zero row), codes the quotient rounded half to even. A row scores
``q . (codes * scale)``. ``exact_topk`` takes the best ``k`` of every
row for a block of queries, a block of store rows at a time, and
``scores_of`` scores given rows.
"""
from __future__ import annotations

from typing import Tuple

import torch


def quantize(rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    amax = rows.abs().amax(1).float()
    s = amax / torch.full_like(amax, 127.0)
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    return torch.round(rows.float() / s[:, None]).to(torch.int8), s


def exact_topk(queries: torch.Tensor, codes: torch.Tensor,
               scales: torch.Tensor, k: int, row_block: int = 1 << 20,
               query_block: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores [Q, k] descending, row positions [Q, k])."""
    out_s, out_i = [], []
    for q0 in range(0, queries.shape[0], query_block):
        q = queries[q0:q0 + query_block].float()
        best_s = best_i = None
        for r0 in range(0, codes.shape[0], row_block):
            rows = codes[r0:r0 + row_block].float() \
                * scales[r0:r0 + row_block, None]
            s = q @ rows.t()
            top_s, top_i = s.topk(min(k, s.shape[1]), dim=1)
            top_i = top_i + r0
            if best_s is not None:
                top_s = torch.cat([best_s, top_s], 1)
                top_i = torch.cat([best_i, top_i], 1)
                top_s, sel = top_s.topk(k, dim=1)
                top_i = torch.gather(top_i, 1, sel)
            best_s, best_i = top_s, top_i
            del rows, s
        out_s.append(best_s)
        out_i.append(best_i)
    return torch.cat(out_s), torch.cat(out_i)


def scores_of(queries: torch.Tensor, positions: torch.Tensor,
              codes: torch.Tensor, scales: torch.Tensor,
              query_block: int = 256) -> torch.Tensor:
    """Scores [Q, k] of the rows at ``positions`` [Q, k] (all valid)."""
    out = []
    for q0 in range(0, queries.shape[0], query_block):
        pos = positions[q0:q0 + query_block]
        rows = codes[pos].float() * scales[pos][..., None]
        out.append(torch.einsum("qd,qkd->qk",
                                queries[q0:q0 + query_block].float(), rows))
    return torch.cat(out)
