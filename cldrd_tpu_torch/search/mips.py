"""Exact maximum-inner-product top-k search (PyTorch port of
``cldrd_tpu/search/mips.py``).

The corpus never materializes a ``[B, N]`` score tensor on the production
path: the extract route (``_binmax_segment_extract``) runs the fused
scores + two-level extraction kernel (``ops.extract_topk``, K1) over the
whole corpus and selects the final top-k from its per-super-block
candidates, certifying each query against its own k-th value. The
portable route (``_binmax_segment``) scores one segment at a time with
the fused scores + bin-max kernel (``ops.fused_binmax``, K2). Both are
exact: a query whose certificate fails is flagged (``on_miss='flag'``)
or re-scanned (``'fallback'``).

Semantics kept from the reference:

- every top-k breaks exact score ties toward the smaller row position
  (a stable sort on the position key, then on the value);
- int8 codes widen to the query dtype and the per-row scale multiplies
  after the dot, in fp32;
- rows with ``row_id < 0`` score ``-inf``; empty result slots are
  ``(-inf, -1)``.

Routing is by shape alone (``_extract_eligible``); the device picks kernel
or plain version inside ``ops``. ``precision='high'|'highest'`` is the
plain fp32 ``torch.matmul`` route, as it bypasses the kernels in the
reference.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from cldrd_tpu_torch.ops.extract_topk import extract_topk
from cldrd_tpu_torch.ops.fused_binmax import block_scores, fused_binmax

NEG_INF = float("-inf")
_PRECISIONS = ("default", "high", "highest")


def _topk_with_payload(values: torch.Tensor, payload: torch.Tensor, k: int):
    """Descending top-k of ``values`` [..., W] carrying ``payload`` along.
    Exact ties break toward the smaller payload: a stable sort on the
    payload, then a stable descending sort on the value (the reference's
    two-key ``lax.sort``; ``torch.topk``'s tie order is undefined)."""
    p_sorted, order = torch.sort(payload, dim=-1, stable=True)
    v = values.gather(-1, order)
    v_sorted, order2 = torch.sort(v, dim=-1, descending=True, stable=True)
    p = p_sorted.gather(-1, order2)
    return v_sorted[..., :k], p[..., :k]


def _total_order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 keys ordering fp32 values as XLA's ``top_k`` does (IEEE total
    order: -0.0 below +0.0)."""
    bits = x.contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: descending, ties to the lower
    index. Returns (values, int64 indices)."""
    _, idx = torch.sort(_total_order_key(x), dim=-1, descending=True,
                        stable=True)
    idx = idx[..., :k]
    return x.gather(-1, idx), idx


def topk_with_payload_chunked(values: torch.Tensor, payload: torch.Tensor,
                              k: int):
    """Exact descending top-k of ``values`` [B, W] carrying ``payload``,
    selected in ~``_SELECT_WIDTH`` chunks for wide W: every global top-k
    element survives its chunk's depth-k strip, so one merge over the
    strips is exact, with the same smaller-payload tie-break."""
    b, w = values.shape
    k = min(k, w)
    if w <= max(_SELECT_WIDTH, 2 * k):
        return _topk_with_payload(values, payload, k)
    width = max(_SELECT_WIDTH, k)
    nseg = -(-w // width)
    pad = nseg * width - w
    if pad:
        values = torch.cat([values, values.new_full((b, pad), NEG_INF)], 1)
        payload = torch.cat([payload, payload.new_full((b, pad), -1)], 1)
    cv, cp = _topk_with_payload(values.view(b, nseg, width),
                                payload.view(b, nseg, width), k)
    return _topk_with_payload(cv.reshape(b, nseg * k),
                              cp.reshape(b, nseg * k), k)


def topk_dense(queries, corpus, row_ids, k: int, precision: str = "default",
               row_scales=None):
    """Single full-matrix top-k (materializes [B, N]); for small corpora
    and as the correctness oracle. k > N pads with (-inf, -1). Every
    precision scores in true fp32 here (TF32 is off,
    ``cldrd_tpu_torch.device``), which is what 'high'/'highest' ask of the
    reference."""
    assert precision in _PRECISIONS, precision
    n = corpus.shape[0]
    bz = queries.shape[0]
    scores = block_scores(queries, corpus, row_scales)
    scores = torch.where(row_ids[None, :] >= 0, scores, NEG_INF)
    k_eff = min(k, n)
    top_s, top_idx = _top_k(scores, k_eff)
    top_i = row_ids[top_idx]
    if k_eff < k:
        top_s = torch.cat([top_s, top_s.new_full((bz, k - k_eff), NEG_INF)],
                          -1)
        top_i = torch.cat([top_i, top_i.new_full((bz, k - k_eff), -1)], -1)
    top_i = torch.where(torch.isfinite(top_s), top_i,
                        torch.full_like(top_i, -1))
    return top_s, top_i


def topk_streaming(queries, corpus, row_ids, k: int, block_rows: int = 8192,
                   precision: str = "default", row_scales=None):
    """Streaming blocked top-k: corpus [N, D] walked in ``block_rows``
    chunks (N a multiple of ``block_rows``; pad with id -1 rows), a
    running [B, k] buffer merged per block. Returns (scores [B, k] fp32
    desc, ids [B, k], -1 for empty slots)."""
    assert precision in _PRECISIONS, precision
    n = corpus.shape[0]
    bz = queries.shape[0]
    if n <= block_rows:
        return topk_dense(queries, corpus, row_ids, k, precision, row_scales)
    assert n % block_rows == 0, (n, block_rows)
    top_s = torch.full((bz, k), NEG_INF, dtype=torch.float32,
                       device=queries.device)
    top_i = torch.full((bz, k), -1, dtype=row_ids.dtype,
                       device=queries.device)
    for r0 in range(0, n, block_rows):
        r1 = r0 + block_rows
        s = block_scores(queries, corpus[r0:r1],
                         None if row_scales is None else row_scales[r0:r1])
        i_blk = row_ids[r0:r1]
        s = torch.where(i_blk[None, :] >= 0, s, NEG_INF)
        cat_s = torch.cat([top_s, s], -1)
        cat_i = torch.cat([top_i, i_blk[None, :].expand(bz, block_rows)], -1)
        top_s, top_i = _topk_with_payload(cat_s, cat_i, k)
    return top_s, top_i


# --------------------------------------------------------------------------
# Bin-max exact top-k (see the reference module for the exactness
# argument). The depth rules below are copied verbatim from it.
# --------------------------------------------------------------------------

_EXTRACT_ROUNDS = 7   # level 1 MAX: 6 candidates + 1 remainder bound per bin
_SUPER_ROWS = 2048    # rows per level-2 super-block
_SUPER_ROUNDS = 16    # level 2 MAX: 15 candidates + 1 remainder per block
_SELECT_WIDTH = 8160  # selection-chunk candidate width


def _select_rounds(n: int, nsup: int, bz: int, k: int, m2: int) -> int:
    """Per-super-block candidate depth actually entering selection: the
    smallest depth m whose Poisson tail puts the expected (block, query)
    misses per batch below ~1e-4 (a deeper block fails the certificate
    and its query re-runs, so the result is exact at any depth)."""
    lam = k * _SUPER_ROWS / n
    pmf = math.exp(-lam)
    cdf = pmf
    for m in range(1, m2):
        pmf *= lam / m
        cdf += pmf
        # tail = P(X >= m + 1): blocks holding more top-k items than kept
        if m * nsup >= k and (1.0 - cdf) * nsup * bz <= 1e-4:
            return m
    return m2


def _extract_rounds(n: int, bz: int, k: int, bin_rows: int) -> int:
    """Level-1 extraction rounds (candidates + 1 remainder) for an n-row
    segment: the smallest depth whose expected (bin, query) misses per
    batch stay below ~5e-4."""
    lam = k * bin_rows / n
    nbins = n // bin_rows
    pmf = math.exp(-lam)
    cdf = pmf
    for m in range(1, _EXTRACT_ROUNDS - 1):
        pmf *= lam / m
        cdf += pmf
        # tail = P(X >= m + 1): bins holding more top-k items than kept
        if (1.0 - cdf) * nbins * bz <= 5e-4:
            return m + 1
    return _EXTRACT_ROUNDS


def _super_rounds(n: int, nsup: int, bz: int, k: int) -> int:
    """Level-2 rounds the kernel EMITS (a multiple of 8). Reduced mode (8
    at the 8.86M full corpus): every emitted round is a selection
    candidate and the last doubles as the block remainder bound."""
    lam = k * _SUPER_ROWS / n
    for r2 in range(8, _SUPER_ROUNDS, 8):
        if r2 * nsup < k:
            continue
        tail = 1.0 - math.exp(-lam) * sum(
            lam**i / math.factorial(i) for i in range(r2))
        if tail * nsup * bz <= 5e-4:
            return r2
    return _SUPER_ROUNDS


def _tile_plan(bz: int):
    """(tile_rows, tiles_per_super_block) of the reference's TPU kernel;
    it decides which bin sizes the extract route takes."""
    tile_rows = _SUPER_ROWS if bz <= 512 else _SUPER_ROWS // 2
    return tile_rows, _SUPER_ROWS // tile_rows


def _extract_eligible(bz: int, n: int, bin_rows: int) -> bool:
    """Shape rule of the extract route, the reference's without its
    backend test: the device picks kernel or plain version, never the
    route, so routing (and the ``ok`` flags) equal the reference's."""
    t, _ = _tile_plan(bz)
    return (
        n % _SUPER_ROWS == 0
        and t % bin_rows == 0
        and bz % 128 == 0
        and bz <= 1024
        and (t // bin_rows) % 8 == 0
    )


def _positions_of(seg_row_ids: torch.Tensor) -> torch.Tensor:
    n = seg_row_ids.shape[0]
    pos = torch.arange(n, dtype=seg_row_ids.dtype, device=seg_row_ids.device)
    return torch.where(seg_row_ids >= 0, pos, torch.full_like(pos, -1))


def _binmax_segment_extract(queries, segment, seg_row_ids, k: int,
                            bin_rows: int, on_miss: str = "fallback",
                            seg_scales=None):
    """Exact segment top-k via the fused scores + two-level extraction
    kernel. Returns (values [B, k], segment-local positions [B, k]) plus
    a per-query ``ok`` when ``on_miss='flag'``. Each super-block emits its
    top candidates and two remainder bounds; the final top-k certifies
    itself against its own k-th value."""
    bz = queries.shape[0]
    n = segment.shape[0]
    R = _extract_rounds(n, bz, k, bin_rows)  # Poisson-sized level-1 depth
    R2 = _SUPER_ROUNDS
    m2 = R2 - 1
    nsup = n // _SUPER_ROWS
    dev = queries.device
    finfo_min = torch.finfo(torch.float32).min

    cand_rows = _super_rounds(n, nsup, bz, k)
    reduced = cand_rows < R2
    m_sel = cand_rows if reduced else _select_rounds(n, nsup, bz, k, m2)
    if nsup * m_sel < k:
        # not enough super-block candidates to cover k: exact streaming,
        # in positions mode (this function returns segment-local positions)
        v, p = topk_streaming(queries, segment, _positions_of(seg_row_ids),
                              k, _SUPER_ROWS, row_scales=seg_scales)
        if on_miss == "flag":
            return v, p, torch.ones((bz,), dtype=torch.bool, device=dev)
        return v, p

    sup_v, sup_p, rem1 = extract_topk(queries, segment, seg_row_ids, R,
                                      cand_rows, bin_rows, seg_scales)
    # rem2: candidates are emitted in descending order, so a block's last
    # emitted value (reduced mode) or its (m_sel+1)-th (full mode) bounds
    # everything deeper
    rem2 = sup_v[:, :, (cand_rows if reduced else m_sel + 1) - 1].amax(1)
    rem1 = rem1.amax(1)  # [B] bin-level remainder bound

    if reduced:
        kv = sup_v.reshape(bz, nsup * cand_rows)
        kp = sup_p.reshape(bz, nsup * cand_rows)
        m_lay = cand_rows
    else:
        kv = sup_v[:, :, :m_sel].reshape(bz, nsup * m_sel)
        kp = sup_p[:, :, :m_sel].reshape(bz, nsup * m_sel)
        m_lay = m_sel

    # selection in ~_SELECT_WIDTH-candidate chunks, merged (every chunk
    # strip holds >= k candidates)
    sel_sup = max(_SELECT_WIDTH // m_lay, -(-k // m_lay), 1)
    if nsup <= sel_sup:
        kept_v = torch.clamp(kv, min=finfo_min)  # -inf -> sentinel (empty)
        v, p_raw = _topk_with_payload(kept_v, kp, k)
    else:
        nseg = -(-nsup // sel_sup)
        pad = (nseg * sel_sup - nsup) * m_lay
        if pad:
            kv = torch.cat([kv, kv.new_full((bz, pad), NEG_INF)], 1)
            kp = torch.cat([kp, kp.new_full((bz, pad), -1)], 1)
        sel_w = sel_sup * m_lay
        kept_v = torch.clamp(kv.view(bz, nseg, sel_w), min=finfo_min)
        kept_p = kp.view(bz, nseg, sel_w)
        cv, cp = _topk_with_payload(kept_v, kept_p, k)
        v, p_raw = _topk_with_payload(cv.reshape(bz, nseg * k),
                                      cp.reshape(bz, nseg * k), k)
    # vk = k-th best candidate <= the true k-th score, always: if every
    # item outside the candidate set (bounded by rem1/rem2) scores below
    # it, nothing was dropped
    vk = v[:, k - 1]
    okq = (((rem1 < vk) | (rem1 == NEG_INF))
           & ((rem2 < vk) | (rem2 == NEG_INF)))  # [B] per-query certificate

    empty = v <= finfo_min  # restore the -inf convention for empty slots
    fv = torch.where(empty, NEG_INF, v)
    fp = torch.where(empty, torch.full_like(p_raw, -1), p_raw)
    if on_miss == "flag":
        return fv, fp, okq
    if bool(okq.all()):
        return fv, fp
    return topk_streaming(queries, segment, _positions_of(seg_row_ids), k,
                          _SUPER_ROWS, row_scales=seg_scales)


def _scores_and_binmax(queries, segment, seg_row_ids, bin_rows: int,
                       precision: str = "default", seg_scales=None):
    """(scores [B, n] fp32 masked, bin maxima [B, nbins] fp32). The
    default precision runs the fused kernel (K2) on the card; others are
    the plain fp32 matmul, as they bypass the kernel in the reference."""
    if precision != "default":
        bz, n = queries.shape[0], segment.shape[0]
        scores = block_scores(queries, segment, seg_scales)
        scores = torch.where(seg_row_ids[None, :] >= 0, scores, NEG_INF)
        return scores, scores.view(bz, n // bin_rows, bin_rows).amax(-1)
    return fused_binmax(queries, segment, seg_row_ids, bin_rows, seg_scales)


def _binmax_segment(queries, segment, seg_row_ids, k: int, bin_rows: int,
                    extract: int, precision: str = "default",
                    on_miss: str = "fallback", seg_scales=None):
    """Exact top-k of one corpus segment via bin-max selection. Returns
    (scores [B, k] fp32, segment-local positions [B, k], -1 for empty
    slots), plus a per-query ``ok`` when ``on_miss='flag'``."""
    bz = queries.shape[0]
    n = segment.shape[0]
    assert n % bin_rows == 0, (n, bin_rows)
    nbins = n // bin_rows
    dev = queries.device

    if precision == "default" and _extract_eligible(bz, n, bin_rows):
        return _binmax_segment_extract(queries, segment, seg_row_ids, k,
                                       bin_rows, on_miss, seg_scales)

    scores, bmax = _scores_and_binmax(queries, segment, seg_row_ids,
                                      bin_rows, precision, seg_scales)
    sb = scores.view(bz, nbins, bin_rows)

    kb = min(k, nbins)
    bvals, bsel = _top_k(bmax, kb)  # exact top-kb bins
    tau = bvals[:, kb - 1]  # [B] lower bound on the true k-th score
    cand = sb.gather(1, bsel[:, :, None].expand(bz, kb, bin_rows))

    # top-m per bin: rounds of (max, first-occurrence argmax, mask);
    # positions are arithmetic on the argmax lane
    m = min(extract, bin_rows)
    lane = torch.arange(bin_rows, device=dev)
    base_pos = bsel * bin_rows  # [B, kb]
    vals, poss = [], []
    c = cand
    for _ in range(m):
        mx = c.amax(-1)
        am = torch.where(c == mx[..., None], lane, bin_rows).amin(-1)
        vals.append(mx)
        poss.append(base_pos + am)
        c = torch.where(lane == am[..., None], NEG_INF, c)
    kept_v = torch.stack(vals, -1).reshape(bz, kb * m)
    kept_p = torch.stack(poss, -1).reshape(bz, kb * m).to(torch.int32)
    rem_max = c.amax(dim=(1, 2))

    # exact unless some non-extracted item could still reach tau
    okq = (rem_max < tau) | (rem_max == NEG_INF)

    def slow():
        cand_pos = base_pos[:, :, None] + lane
        return _topk_with_payload(cand.reshape(bz, kb * bin_rows),
                                  cand_pos.reshape(bz, kb * bin_rows)
                                  .to(torch.int32), k)

    if kb < k or kb * m < k:
        # kb < k: tau is no lower bound, but then cand holds the entire
        # segment and the slow path is an exact full top-k
        v, p = slow()
        okq = torch.ones((bz,), dtype=torch.bool, device=dev)
    elif on_miss == "flag" or bool(okq.all()):
        v, p = _topk_with_payload(kept_v, kept_p, k)
    else:
        v, p = slow()
    p = torch.where(torch.isfinite(v), p, torch.full_like(p, -1))
    if on_miss == "flag":
        return v, p, okq
    return v, p


def topk_binmax(queries: torch.Tensor, corpus: torch.Tensor,
                row_ids: torch.Tensor, k: int, bin_rows: int = 128,
                extract: int = 6, segment_rows: int = 2_097_152,
                precision: str = "default", return_positions: bool = False,
                on_miss: str = "fallback",
                row_scales: Optional[torch.Tensor] = None):
    """Exact MIPS top-k via bin-max selection.

    ``row_scales`` ([N] fp32): int8 store, real scores ``(q . c8) * s``.
    Extract-eligible shapes take ONE fused kernel pass over the whole
    corpus; others stream ``segment_rows``-row segments through the
    portable route (a Python loop replaces the reference's ``lax.scan``)
    and merge. ``return_positions=True`` returns row positions instead of
    external ids. ``on_miss='flag'`` returns ``(scores, ids_or_positions,
    ok [B] bool)``: rows with ``ok=False`` may be inexact and the caller
    re-runs them; rows with ``ok=True`` are exact."""
    assert on_miss in ("fallback", "flag"), on_miss
    assert precision in _PRECISIONS, precision
    n = corpus.shape[0]
    while bin_rows > 8 and n % bin_rows:
        bin_rows //= 2
    dev = queries.device
    row_ids = row_ids.to(torch.int32)
    pos_ids = _positions_of(row_ids)

    bz = queries.shape[0]
    ok_all = torch.ones((bz,), dtype=torch.bool, device=dev)

    def finish(v, p, ok):
        if not return_positions:
            ids = row_ids[p.clamp(min=0).long()]
            p = torch.where(p >= 0, ids, torch.full_like(ids, -1))
        if on_miss == "flag":
            return v, p, ok
        return v, p

    if n <= k or n <= bin_rows * 2 or n % bin_rows:
        v, p = topk_dense(queries, corpus, pos_ids, k, precision, row_scales)
        return finish(v, p, ok_all)  # dense is exact
    if precision == "default" and _extract_eligible(bz, n, bin_rows):
        res = _binmax_segment_extract(queries, corpus, row_ids, k, bin_rows,
                                      on_miss, row_scales)
        if on_miss == "flag":
            return finish(*res)
        return finish(res[0], res[1], ok_all)
    segment_rows = min(segment_rows, n)
    segment_rows -= segment_rows % bin_rows  # segments are bin-aligned
    # prefer an equal split when one exists
    if n % segment_rows:
        nseg = -(-n // segment_rows)
        for cand in range(nseg, nseg + 8):
            seg2 = n // cand
            if (n % cand == 0 and seg2 > k and seg2 % bin_rows == 0
                    and seg2 % _SUPER_ROWS == 0):
                segment_rows = seg2
                break
    if segment_rows <= k:
        # the portable route needs > k rows to narrow into
        segment_rows = (k // bin_rows + 1) * bin_rows
    nfull = n // segment_rows
    tail_start = nfull * segment_rows

    seg_v, seg_p = [], []

    def run_segment(start, end):
        nonlocal ok_all
        res = _binmax_segment(
            queries, corpus[start:end], row_ids[start:end], k, bin_rows,
            extract, precision, on_miss,
            None if row_scales is None else row_scales[start:end])
        if on_miss == "flag":
            v, p, seg_ok = res
            # a query is exact only if EVERY segment certified it
            ok_all = ok_all & seg_ok
        else:
            v, p = res
        seg_v.append(v)
        seg_p.append(torch.where(p >= 0, p + start, torch.full_like(p, -1)))

    for s in range(nfull):
        run_segment(s * segment_rows, (s + 1) * segment_rows)
    if tail_start < n:
        if n - tail_start <= k:  # tiny tail: dense (global positions)
            v, p = topk_dense(
                queries, corpus[tail_start:], pos_ids[tail_start:], k,
                precision,
                None if row_scales is None else row_scales[tail_start:])
            seg_v.append(v)
            seg_p.append(p)
        else:
            run_segment(tail_start, n)

    if len(seg_v) == 1:
        return finish(seg_v[0], seg_p[0], ok_all)
    v, p = _topk_with_payload(torch.cat(seg_v, -1), torch.cat(seg_p, -1), k)
    return finish(v, p, ok_all)
