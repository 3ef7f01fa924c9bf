"""Device-side phrase execution: adjacency scoring over device-resident
position lists.

**Status: implemented, parity-proven, and OFF by default**
(FUGU_DEVICE_PHRASE=1 enables).  It lost to the host matcher on earlier
hardware, whose gathers were serialized; gathers are native on a GPU,
and this path has not been measured on the H100.  This module ships each
field's position arrays to the device once (cached on the segment, like
the posting packs) and executes the common phrase shapes as one fused
XLA program per query:

1. **Doc intersection** (the PhraseMatcher front half): the rarest
   term's posting window is the candidate axis j; every other term
   resolves membership with one ``searchsorted`` over its own window.
2. **Position expansion**: candidate entries' position runs expand via
   the monotone-gather idiom (cumsum + searchsorted, no scatter).
3. **Anchor intersection** (slop=0): position p of term i anchors the
   phrase at p-i; anchors encode as ``j * 2^15 + (p - i + 4)`` — int32,
   ascending by construction (j ascending, p ascending within an entry)
   — and intersect progressively with ``searchsorted``, exactly the
   host matcher's math.  Padding slots carry INT_MAX (non-decreasing
   for searchsorted; never equal to a valid key, and term-0's ok mask
   kills pad slots regardless).
4. **Scoring**: phrase_tf per candidate = scatter-add of surviving
   anchors; score = w_p * tf/(tf + cache[fid]); dead docs masked;
   top-k ties resolve to the lowest candidate index = lowest doc id
   (ops/scoring.top_k_lowest).

The device ranking is then host-rescored with the matcher's exact
float sequence (w_p f32, tf/(tf + cache[fid]) in f32), so results are
bit-identical to ops/phrase.py (tests/test_device_phrase.py).

Eligibility gates (host fallback otherwise): single-phrase plans
(every group one SHOULD/MUST phrase over one field, the shape
quoted queries parse to), slop == 0 or single-term, <= 4 terms, <= 2^16
COMMON docs (the anchor-key budget; checked on device with an overflow
flag), max position < 2^15-8 (guaranteed by the 10k-char text cap;
checked per segment anyway), and default bm25 constants.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from fugu_tpu import jax_setup
from fugu_tpu.index.segment import Segment, _pow2_bucket
from fugu_tpu.ops import buckets
from fugu_tpu.ops.oracle import IndexStats
from fugu_tpu.query import (
    Occur,
    QueryPlan,
    bm25_weight,
    fieldnorm_cache,
)

jax_setup.configure()

import jax
import jax.numpy as jnp

from fugu_tpu.ops.scoring import top_k_lowest

_SHIFT = 15              # anchors: rank * 2^15 + (pos - i + 4)
_POS_CAP = (1 << _SHIFT) - 8
#: max COMMON docs per phrase (rank * 2^15 stays in int32); the doc
#: intersection itself is unbounded — candidates compact to ranks on
#: device, and an overflow flag routes wider matches to the host matcher
_COMMON_CAP = 1 << 16
#: flat position budget across the compacted candidates (per term);
#: exceeding it also raises the overflow flag
_PPOS_PAD = 1 << 19
#: posting-window ladder — ONE canonical pad per query (max constituent
#: df) keeps the number of compiled programs to a handful per k_terms
#: (per-term pow2 pads would compile dozens of programs).  Capped at
#: 2^17: beyond ~10^5-entry windows the host matcher's bound-ordered
#: pruning won on earlier hardware — dense-term phrases stay on the
#: host, the selective phrases real users quote go to the device
_PAD_LADDER = (1 << 13, 1 << 17)
_INT_MAX = np.int32(2**31 - 1)


def _phrase_clause(plan: QueryPlan):
    """The single PhraseClause of an eligible plan, or None."""
    if plan.match_all or plan.has_range or plan.has_subplan:
        return None
    from fugu_tpu.query import K1, B as B_CONST

    if plan.k1 != float(K1) or plan.b != float(B_CONST):
        return None
    pcs = []
    for g in plan.groups:
        if g.occur is Occur.MUST_NOT or g.clauses or g.ranges:
            return None
        if g.subplan is not None or len(g.phrases) != 1:
            return None
        pcs.append(g.phrases[0])
    if len(pcs) != 1:
        return None
    pc = pcs[0]
    slop = max(int(getattr(pc, "slop", 0) or 0), 0)
    if slop != 0 and len(pc.terms) > 1:
        return None
    if not (1 <= len(pc.terms) <= 4):
        return None
    return pc


def _device_positions(segment: Segment, field: str):
    """(pos_off, pos_dat, fid_doc, tomb_doc) device arrays for one
    field, cached on the segment; None when the field has no positions
    or positions exceed the anchor budget."""
    cache = getattr(segment, "_device_pos", None)
    if cache is None:
        cache = {}
        object.__setattr__(segment, "_device_pos", cache)
    if field in cache:
        return cache[field]
    if field not in segment.pos_offsets:
        cache[field] = None
        return None
    dat = segment.pos_data[field]
    if len(dat) and int(dat.max()) >= _POS_CAP:
        cache[field] = None  # pathological positions: host matcher only
        return None
    if len(dat) >= 2**31:
        # int64 offsets would wrap in the int32 cast below and gather
        # garbage positions with no error — host matcher only
        cache[field] = None
        return None
    off = segment.pos_offsets[field]
    off_pad = np.zeros(_pow2_bucket(len(off)), dtype=np.int32)
    off_pad[: len(off)] = off.astype(np.int32)
    off_pad[len(off) :] = off[-1]
    dat_pad = np.zeros(_pow2_bucket(max(len(dat), 32)), dtype=np.int32)
    dat_pad[: len(dat)] = dat
    fid = np.zeros(_pow2_bucket(max(segment.doc_count, 32)), dtype=np.int32)
    fid[: segment.doc_count] = segment.fieldnorm_ids.get(
        field, np.zeros(segment.doc_count, dtype=np.uint8)
    )
    tomb = np.zeros(len(fid), dtype=np.int32)
    tomb[: segment.doc_count] = segment.tombstones.astype(np.int32)
    out = (
        jnp.asarray(off_pad),
        jnp.asarray(dat_pad),
        jnp.asarray(fid),
        jnp.asarray(tomb),
    )
    cache[field] = out
    return out


def _window(e_doc, start, df, pad):
    """Masked posting window: docs of one term, INT_MAX beyond df."""
    w = jax.lax.dynamic_slice(e_doc, (start,), (pad,))
    idx = jnp.arange(pad, dtype=jnp.int32)
    return jnp.where(idx < df, w, _INT_MAX)


def _expand_positions(pos_off, pos_dat, entry_idx, valid, ppad, base):
    """Flat positions of the selected entries + their candidate index.

    entry_idx[j] (global entry id) owns run pos_off[e-base : e-base+1);
    invalid j contribute empty runs.  Returns (cand_j, pos, ok) arrays
    of length ppad via the monotone-gather idiom."""
    rel = jnp.where(valid, entry_idx - base, 0)
    starts = pos_off[rel]
    lens = jnp.where(valid, pos_off[rel + 1] - starts, 0)
    cum = jnp.cumsum(lens)
    total = cum[-1]
    p = jnp.arange(ppad, dtype=jnp.int32)
    j = jnp.searchsorted(cum, p, side="right").astype(jnp.int32)
    j = jnp.minimum(j, lens.shape[0] - 1)
    within = p - (cum[j] - lens[j])
    ok = p < total
    pos = pos_dat[jnp.where(ok, starts[j] + within, 0)]
    return j, pos, ok, total


def _build_phrase_fn(k_terms, pads, ppads, k_out):
    """jit'd single-query phrase top-k; static shape bundle."""

    @jax.jit
    def run(e_doc, pos_off, pos_dat, fid_doc, tomb_doc,
            starts, dfs, aoff, w_p, cache, field_base):
        # candidate axis: rarest term's window (term order pre-sorted by
        # df on the host; term index 0 here = rarest constituent)
        w0 = _window(e_doc, starts[0], dfs[0], pads[0])
        j_iota = jnp.arange(pads[0], dtype=jnp.int32)
        valid = w0 != _INT_MAX
        entry0 = starts[0] + j_iota
        # doc intersection + per-term entry resolution
        entries = [entry0]
        for i in range(1, k_terms):
            # same masked-window op as term 0 (df masks past-df lanes)
            wi = _window(e_doc, starts[i], dfs[i], pads[i])
            loc = jnp.searchsorted(wi, w0).astype(jnp.int32)
            loc = jnp.minimum(loc, pads[i] - 1)
            valid = valid & (wi[loc] == w0)
            entries.append(starts[i] + loc)
        # dead docs can never be hits
        doc_safe = jnp.where(valid, w0, 0)
        valid = valid & (tomb_doc[doc_safe] == 0)

        if k_terms == 1:
            # single-term "phrase": tf is the entry's position count;
            # no anchors, so no candidate cap applies
            rel = jnp.where(valid, entries[0] - field_base, 0)
            tf = jnp.where(
                valid, (pos_off[rel + 1] - pos_off[rel]).astype(jnp.float32), 0.0
            )
            score = jnp.where(
                (tf > 0.0) & valid,
                w_p * (tf / (tf + cache[fid_doc[doc_safe]])),
                -jnp.inf,
            )
            kk = min(k_out, pads[0])
            top_s, idx = top_k_lowest(score, kk)
            top_d = jnp.where(top_s > -jnp.inf, w0[idx], _INT_MAX)
            return top_s, top_d, jnp.int32(0)

        # compact the common docs to dense ranks (monotone gather) so
        # the anchor keys fit int32 regardless of the terms' doc freqs;
        # overflow (> _COMMON_CAP common docs, or more candidate
        # positions than the flat budget) falls back to the host
        c_pad = min(_COMMON_CAP, pads[0])
        cum = jnp.cumsum(valid.astype(jnp.int32))
        n_common = cum[-1]
        overflow = (n_common > c_pad).astype(jnp.int32)
        q = jnp.arange(c_pad, dtype=jnp.int32)
        src = jnp.searchsorted(cum, q + 1, side="left").astype(jnp.int32)
        src = jnp.minimum(src, pads[0] - 1)
        cvalid = q < n_common
        cdoc = jnp.where(cvalid, w0[src], 0)
        centries = [jnp.where(cvalid, e[src], 0) for e in entries]

        inter = None
        for i in range(k_terms):
            cj, pos, ok, p_total = _expand_positions(
                pos_off, pos_dat, centries[i], cvalid, ppads[i], field_base
            )
            overflow = overflow | (p_total > ppads[i]).astype(jnp.int32)
            # anchor = original-phrase-index-adjusted position: the
            # slot order is rarest-first, aoff[i] restores the
            # term's index within the quoted phrase
            keys = cj * (1 << _SHIFT) + (pos - aoff[i] + 4)
            # pads: constant INT_MAX — keeps the array non-decreasing
            # for searchsorted, provably never equals a valid key
            # (max valid = (2^16-1)*2^15 + POS_CAP + 4 <= INT_MAX-3),
            # and pad-vs-pad matches are dead anyway because term 0's
            # ok mask initializes `alive` False on pad slots
            keys = jnp.where(ok, keys, _INT_MAX)
            if inter is None:
                inter = keys
                alive = ok
            else:
                m = jnp.searchsorted(keys, inter).astype(jnp.int32)
                m = jnp.minimum(m, ppads[i] - 1)
                alive = alive & (keys[m] == inter)
        # phrase_tf per candidate rank: count surviving anchors
        jj = jnp.where(alive, inter >> _SHIFT, 0)
        tf = (
            jnp.zeros(c_pad, jnp.float32)
            .at[jj]
            .add(alive.astype(jnp.float32))
        )
        score = jnp.where(
            (tf > 0.0) & cvalid,
            w_p * (tf / (tf + cache[fid_doc[cdoc]])),
            -jnp.inf,
        )
        kk = min(k_out, c_pad)
        top_s, idx = top_k_lowest(score, kk)
        top_d = jnp.where(top_s > -jnp.inf, cdoc[idx], _INT_MAX)
        return top_s, top_d, overflow

    return run


_FN_CACHE: Dict[tuple, object] = {}


def _get_fn(k_terms, pads, ppads, k_out):
    key = (k_terms, pads, ppads, k_out)
    fn = _FN_CACHE.get(key)
    if fn is None:
        fn = _build_phrase_fn(k_terms, pads, ppads, k_out)
        _FN_CACHE[key] = fn
    return fn


def device_phrase_begin(
    segment: Segment,
    plans: Sequence[QueryPlan],
    stats: IndexStats,
    limit: int,
):
    """Queue device dispatches for the eligible phrase plans; returns a
    handle for :func:`device_phrase_collect`.  Ineligible plans stay
    None (callers keep the host matcher fallback)."""
    results: List[Optional[List[Tuple[float, int]]]] = [None] * len(plans)
    staged = []
    # strict-< ladder so rescoring always sees slack candidates at a
    # bucket boundary (mirrors pallas_scorer's k-ladder fix); limits
    # past the last bucket would silently truncate the device top-k —
    # decline them all to the exact host matcher instead
    k_out = buckets.k_extract(limit)
    if k_out is None:
        return results, staged, segment, plans, stats, limit
    e_doc = None
    for qi, plan in enumerate(plans):
        pc = _phrase_clause(plan)
        if pc is None:
            continue
        field = pc.field
        infos = [segment.term_info(field, t) for t in pc.terms]
        if any(i is None for i in infos):
            results[qi] = []  # absent term: matches nothing (Tantivy)
            continue
        dev_pos = _device_positions(segment, field)
        if dev_pos is None:
            continue
        order = sorted(range(len(infos)), key=lambda k: infos[k].doc_freq)
        dfs_idx = [stats.doc_freq(field, t) for t in pc.terms]
        if max(dfs_idx) == 0:
            results[qi] = []
            continue
        w_p = float(
            bm25_weight(max(dfs_idx), stats.doc_count, pc.boost, plan.k1)
        )
        cache = fieldnorm_cache(
            stats.avg_fieldnorm(field), plan.k1, plan.b
        ).astype(np.float32)
        if e_doc is None:
            e_doc = segment.device_pack()[0]
        base = segment.field_entry_base[field]
        k_terms = len(pc.terms)
        # term order: rarest first (the candidate axis), anchors offset
        # by the ORIGINAL term index i (pos - i)
        starts = np.array(
            [infos[k].start for k in order], dtype=np.int32
        )
        dfs = np.array([infos[k].doc_freq for k in order], dtype=np.int32)
        offsets = np.array(order, dtype=np.int32)  # original index per slot

        mx_df = int(dfs.max())
        pad = next((v for v in _PAD_LADDER if mx_df <= v), None)
        if pad is None:
            continue  # dense terms: the pruned host matcher wins there
        pads = (pad,) * k_terms
        if any(int(st) + pad > int(e_doc.shape[0]) for st in starts):
            continue  # window would clamp past the pack tail: host path
        ppads = (_PPOS_PAD,) * k_terms
        fn = _get_fn(k_terms, pads, ppads, k_out)
        out = fn(
            e_doc,
            dev_pos[0],
            dev_pos[1],
            dev_pos[2],
            dev_pos[3],
            jnp.asarray(starts),
            jnp.asarray(dfs),
            jnp.asarray(offsets),
            jnp.float32(w_p),
            jnp.asarray(cache),
            jnp.int32(base),
        )
        staged.append((qi, out))
    return results, staged, segment, plans, stats, limit


def _exact_phrase_rescore(segment, plan, stats, docs, limit):
    """Exact host re-scoring of the device-selected candidate docs —
    the same float sequence as ops/phrase.py's matcher (w_p f32, tf/(tf
    + cache[fid]) in f32), so final orderings are bit-identical."""
    pc = _phrase_clause(plan)
    field = pc.field
    docs = np.asarray(sorted(set(int(d) for d in docs)), dtype=np.int64)
    if len(docs) == 0:
        return []
    dfs = [stats.doc_freq(field, t) for t in pc.terms]
    w_p = np.float32(
        bm25_weight(max(dfs), stats.doc_count, pc.boost, plan.k1)
    )
    cache = fieldnorm_cache(stats.avg_fieldnorm(field), plan.k1, plan.b)
    fids = segment.fieldnorm_ids[field][docs].astype(np.int64)

    if len(pc.terms) == 1:
        info = segment.term_info(field, pc.terms[0])
        tdocs = segment.e_doc[info.start : info.start + info.doc_freq]
        loc = np.searchsorted(tdocs, docs.astype(tdocs.dtype))
        tf = segment.e_tf[info.start + loc].astype(np.float32)
    else:
        base = segment.field_entry_base[field]
        offs = segment.pos_offsets[field]
        dat = segment.pos_data[field]
        # per-term lookups hoisted out of the candidate loop (they were
        # rebuilt k_out*k_terms times)
        term_windows = []
        for t in pc.terms:
            info = segment.term_info(field, t)
            term_windows.append(
                (info, segment.e_doc[info.start : info.start + info.doc_freq])
            )
        tf = np.zeros(len(docs), dtype=np.float32)
        for di, d in enumerate(docs):
            inter = None
            for k, (info, tdocs) in enumerate(term_windows):
                loc = int(np.searchsorted(tdocs, np.int32(d)))
                e = info.start + loc - base
                poss = dat[offs[e] : offs[e + 1]].astype(np.int64) - k
                if k:
                    poss = poss[poss >= 0]
                inter = poss if inter is None else np.intersect1d(
                    inter, poss, assume_unique=True
                )
                if inter.size == 0:
                    break
            tf[di] = float(len(inter)) if inter is not None else 0.0
    scores = w_p * (tf / (tf + cache[fids]))
    keep = tf > 0
    order = np.lexsort((docs[keep], -scores[keep]))
    return [
        (float(scores[keep][i]), int(docs[keep][i])) for i in order
    ][:limit]


def device_phrase_collect(handle):
    """Fetch all queued phrase dispatches (one overlapped transfer) and
    host-rescore to the exact float sequence."""
    results, staged, segment, plans, stats, limit = handle
    if not staged:
        return results
    flat = jax_setup.fetch_np([a for _qi, out in staged for a in out])

    it = iter(zip(flat[0::3], flat[1::3], flat[2::3]))
    for (qi, _out), (top_s, top_d, overflow) in zip(staged, it):
        if int(overflow):
            # more common docs than the anchor-key budget: the pruned
            # host matcher takes this one (None -> caller fallback)
            results[qi] = None
            continue
        keep = np.isfinite(top_s) & (top_d != _INT_MAX)
        results[qi] = _exact_phrase_rescore(
            segment, plans[qi], stats, top_d[keep], limit
        )
    return results


def device_phrase_batch(segment, plans, stats, limit):
    return device_phrase_collect(
        device_phrase_begin(segment, plans, stats, limit)
    )
