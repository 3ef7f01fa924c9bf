"""Batched phrase engine: one sweep over a forward token stream.

Position lists are the natural phrase index, but a batch of phrases can
also be answered by ONE streaming pass over the corpus in position
order — the same shape as the term engine's phase A
(ops/batch_scorer.py):

**TokenStreamPack** (built per (segment, field), cached by the index
stats fingerprint): the corpus as a FORWARD token stream — for every
512-doc block, each live doc's tokens laid out at their position index
(holes = sentinel; POSITION_GAP holes already separate multi-value
fields), KGAP sentinel rows between docs so adjacency can never cross a
doc, each block's stream cut into 2048-row chunks that OVERLAP by KGAP
rows (a row's KGAP-1 successors are always visible in some chunk where
the row is anchor-eligible).  Each int32 row packs (doc_local << 22 |
tid).

**Sweep** (:func:`_phrase_sweep`, a Pallas kernel through Triton): for
the whole phrase batch at once, a row anchors a match of query q when
slot 0's term sits at the row and each later slot j's term sits j (+ up
to slop) rows on — shifted rows are shifted loads, since chunks overlap
by KGAP.  One program owns one 512-doc block and one tile of queries;
matches are counted per doc (phrase tf) by a one-hot product into a
register accumulator, scored w_p * tf / (tf + cacheval[doc]), and
reduced to the max score per (fine doc slice, query) plus the exact
integer (tf << 8 | 255 - fid) class of that slice's argmax doc.

Match anchors are counted once (chunk tails are masked and re-scored at
the next chunk's overlapped head), so tf IS the oracle's phrase_tf
(ops/oracle.py::phrase_postings) and the maxima are achievable doc
scores — a phrase postprocessor ships each query's top-K fine blocks
SORTED BY BOUND, and the host matches them in that order with
float-safe early termination (block-max pruning with device-exact
bounds), re-checking survivors with the exact PhraseMatcher
(ops/phrase.py) so final scores stay bit-identical to the oracle.
Reference behavior: phrase queries inside Tantivy via QueryParser ->
PhraseQuery (`/root/reference/src/db/search.rs:112`).

Eligibility: single-group single-phrase plans (the quoted-query shape),
slop <= MAX_SLOP, <= 8 terms, default k1/b, positive boost, limit <=
128, vocab < 2^22 terms in the field.  Everything else falls back to
the host matcher, which stays bit-exact.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from fugu_tpu import jax_setup
from fugu_tpu.index.segment import BM_BLOCK_DOCS, BM_CHUNK, Segment
from fugu_tpu.ops.batch_scorer import (
    BM_FINE_DOCS,
    FINE_PER_BLOCK,
    _nb_pad,
)
from fugu_tpu.ops.scoring import NEG_INF, top_k_lowest
from fugu_tpu.query import (
    Occur,
    PhraseClause,
    QueryPlan,
    bm25_weight,
    fieldnorm_cache,
)

jax_setup.configure()

#: max phrase terms on the device path; also the inter-doc sentinel gap
#: and the chunk overlap (a row's KGAP-1 successors stay visible)
KMAX = 8
KGAP = KMAX
#: max slop on the device path.  Slop semantics are the oracle's
#: ordered-window relaxation (term k anywhere in [anchor+k, anchor+k+
#: slop]; ops/oracle.py:141) — the sweep ORs each slot's hit over its
#: shift window, so device phrase_tf stays EXACT for sloppy phrases
#: too.  The forward reach (n_terms-1+slop) must stay <= KGAP: beyond
#: that a shifted row can reach past the chunk overlap and the doc-gap
#: sentinels no longer block cross-doc adjacency (see eligible_phrase).
MAX_SLOP = 2
#: term-ordinal bits in a packed stream row (doc_local rides bits 22-30,
#: sign bit stays 0: 511 << 22 | TID_MASK == 0x7FFFFFFF)
TID_BITS = 22
TID_MASK = (1 << TID_BITS) - 1
#: sentinel row: reserved never-assigned tid, doc_local 0 (harmless —
#: sentinel rows produce match 0, and match is the scatter's rhs)
SENT_ROW = np.int32(TID_MASK)

#: ladders (compile signatures)
PB_BUCKETS = (64, 128, 256)
PK_BUCKETS = (2, 4, 8)
#: kmax ladder for sloppy dispatches (smax=MAX_SLOP): the wrap/doc-gap
#: constraint is kmax_bucket - 1 + smax <= KGAP, so the top bucket is 7
PK_SLOP_BUCKETS = (2, 4, 7)

#: one sweep pays a fixed corpus-pass cost; below this many staged
#: phrases the host matcher is cheaper (fitted on earlier hardware; not
#: re-measured on the H100)
PHRASE_MIN_BATCH = int(os.environ.get("FUGU_PHRASE_MIN_BATCH", "8"))

#: auto-routing threshold: a batch of at least this many phrases
#: streams unless the df cost model below says otherwise
PHRASE_AUTO_MIN = int(os.environ.get("FUGU_PHRASE_AUTO_MIN", "128"))

#: df cost model for auto routing.  The host matcher intersects
#: rarest-first (ops/phrase.py PhraseMatcher), so its cost tracks the
#: SMALLEST constituent df plus the adjacency work on the candidate
#: intersection (E[inter] = prod(df) / N^(k-1), with a (1 + 3*min_df/N)
#: correction for the growth of positions per doc with df) — NOT the
#: summed posting mass.  The sweep's cost is df-INDEPENDENT: a fixed
#: part, a per-token part and a small per-phrase verify cost.  All five
#: constants were fitted on earlier hardware and are not re-measured on
#: the H100; FUGU_PHRASE_STREAM=1 bypasses the router.
HOST_NS_PER_MIN_POSTING = float(os.environ.get("FUGU_PHRASE_HOST_NS", "44"))
HOST_NS_PER_INTER_DOC = float(os.environ.get("FUGU_PHRASE_HOST_INTER_NS", "55.6"))
STREAM_NS_PER_TOKEN = float(os.environ.get("FUGU_PHRASE_STREAM_NS", "2.0"))
STREAM_FIXED_MS = float(os.environ.get("FUGU_PHRASE_STREAM_FIXED_MS", "45"))
STREAM_MS_PER_PHRASE = float(os.environ.get("FUGU_PHRASE_STREAM_PER_MS", "1.4"))


def phrase_stream_mode() -> str:
    """'0' (host only) | '1' (stream any batch >= PHRASE_MIN_BATCH) |
    'auto' (cost-model routing, PHRASE_AUTO_MIN forces large batches)."""
    v = os.environ.get("FUGU_PHRASE_STREAM", "auto").strip().lower()
    return v if v in ("0", "1") else "auto"


def estimate_host_ms(plans, stats) -> float:
    """Predicted host-matcher cost: rarest-posting walk + intersection
    adjacency work per phrase (see the calibration note above)."""
    n = max(stats.doc_count, 1)
    total = 0.0
    for p in plans:
        for g in p.groups:
            for pc in g.phrases:
                dfs = [stats.doc_freq(pc.field, t) for t in pc.terms]
                if not dfs or min(dfs) == 0:
                    continue  # dead phrase: host rejects instantly
                min_df = min(dfs)
                inter = 1.0
                for d in dfs:
                    inter *= d
                inter /= float(n) ** (len(dfs) - 1)
                total += min_df * HOST_NS_PER_MIN_POSTING * 1e-6
                # slop multiplies the adjacency work: each later term's
                # anchor set expands (slop+1)x before the intersection
                # (PhraseMatcher.match's np.unique over shifted copies)
                slop_f = 1.0 + max(int(getattr(pc, "slop", 0) or 0), 0)
                total += (
                    inter
                    * slop_f
                    * HOST_NS_PER_INTER_DOC
                    * 1e-6
                    * (1.0 + 3.0 * min_df / n)
                )
    return total


def estimate_stream_ms(stats, n_phrases: int) -> float:
    """Predicted stream cost: the df-independent corpus sweep plus the
    small per-phrase verify/lane cost."""
    toks = sum(stats.total_tokens.values())
    return (
        STREAM_FIXED_MS
        + toks * STREAM_NS_PER_TOKEN * 1e-6
        + n_phrases * STREAM_MS_PER_PHRASE
    )


def _stream_fits_budget(stats) -> bool:
    """False when staging the token-stream pack would blow the device
    residency budget past what is already resident.

    When the term packs already fill the budget, the token pack would
    evict them and every later mixed batch would re-upload multi-GB
    packs.  Auto mode routes to the host instead;
    ``FUGU_PHRASE_STREAM=1`` still forces the stream for operators with
    phrase-dominant workloads.  Token bytes already resident (an earlier
    phrase batch staged them) count as free, so a warm phrase-heavy
    workload keeps streaming.
    """
    from fugu_tpu.index.segment import _pow2_bucket
    from fugu_tpu.ops import residency

    budget = residency.budget_bytes()
    if budget is None:
        return True
    toks = sum(stats.total_tokens.values())
    docs = stats.doc_count
    # stream rows = tokens + per-doc KGAP sentinel gap, chunk-overlap
    # inflated, pow2/16-step bucketed; plus the [nb_pad*1024] cv/fid rows
    rows = (toks + docs * KGAP) * BM_CHUNK // max(BM_CHUNK - KGAP, 1)
    est = _pow2_bucket(max(int(rows), BM_CHUNK)) * 4
    est += _nb_pad(max((docs + BM_BLOCK_DOCS - 1) // BM_BLOCK_DOCS, 1)) * 1024 * 8
    st = residency.stats()
    already = st["by_kind"].get("token_stream", 0)
    needed = max(est - already, 0)
    return st["resident_bytes"] + needed <= budget


def want_stream(
    n_phrases: int, plans=None, stats=None, overlap_ms: float = 0.0
) -> bool:
    """``overlap_ms``: estimated wall time of the DEVICE batch the same
    call dispatches concurrently (0 for a pure phrase batch).  The host
    matcher runs on a worker thread UNDER the device wait (both sides
    release the GIL — engine/named_index), so up to ``overlap_ms`` of
    host phrase work is free, while the stream's sweep ADDS device time
    to the same serial device queue — without this credit a mixed batch
    would stream phrases whose host cost hides under the device wait.
    Callers estimate overlap with :func:`estimate_device_batch_ms`."""
    mode = phrase_stream_mode()
    if mode == "0":
        return False
    if mode == "1":
        return n_phrases >= 1  # begin() itself applies PHRASE_MIN_BATCH
    if stats is not None and not _stream_fits_budget(stats):
        return False
    if overlap_ms > 0.0:
        # a concurrent device batch: only the host excess beyond the
        # device wall competes with the stream's serial sweep (applies
        # at ANY batch size — a huge overlapped host budget beats the
        # sweep even above PHRASE_AUTO_MIN).  The credit gates on
        # overlap_ms ALONE: a caller passing overlap without plans/stats
        # must not fall through to the unconditional PHRASE_AUTO_MIN
        # stream — that is exactly what the credit prevents — so
        # missing model inputs mean "don't stream".
        if plans is None or stats is None:
            return False
        return (
            n_phrases >= PHRASE_MIN_BATCH
            and estimate_host_ms(plans, stats) - overlap_ms
            > estimate_stream_ms(stats, n_phrases)
        )
    if n_phrases >= PHRASE_AUTO_MIN and (plans is None or stats is None):
        return True  # model inputs missing: large batches favor the sweep
    if n_phrases < PHRASE_MIN_BATCH or plans is None or stats is None:
        return False
    # the cost model decides at ANY batch size when its inputs exist:
    # df-blind batch-size rules don't transfer across df profiles
    # (tools/phrase_cost_validate.py checks the model off-corpus)
    return estimate_host_ms(plans, stats) > estimate_stream_ms(stats, n_phrases)


def estimate_device_batch_ms(
    stats, n_queries: int, token_share: float = 1.0
) -> float:
    """Crude wall-time model of a concurrent two-phase device batch, for
    want_stream's overlap credit.  Phase A sweeps the same corpus the
    phrase stream does with the same cost shape (fixed cost + per-token
    sweep + per-query staging/wave cost), so the stream constants are
    reused (not re-measured on the H100).

    ``token_share``: fraction of the index's tokens the concurrent batch
    actually sweeps — multi-segment callers pass the CURRENT segment's
    share, since each segment's device batch sweeps only that segment
    (index-wide stats would overestimate the credit per segment and bias
    phrases onto the host thread)."""
    if n_queries <= 0:
        return 0.0
    toks = sum(stats.total_tokens.values()) * min(max(token_share, 0.0), 1.0)
    return (
        STREAM_FIXED_MS
        + toks * STREAM_NS_PER_TOKEN * 1e-6
        + n_queries * STREAM_MS_PER_PHRASE
    )


# --------------------------------------------------------------------------
# pack construction
# --------------------------------------------------------------------------


class _StreamArrays:
    """Host-side token stream of one (segment, field, doc range):
    (pack rows, cv, fid, chunk_offs, nb, nb_pad, tid_of, n_terms, ok).
    Shared by the single-chip TokenStreamPack and the sharded
    per-doc-range builder (parallel/phrase_sharded)."""

    __slots__ = (
        "pack", "cv", "fid", "chunk_offs", "n_blocks", "nb_pad",
        "tid_of", "n_terms", "ok",
    )


def build_stream_arrays(
    segment: Segment,
    field: str,
    stats,
    doc_lo: int = 0,
    doc_hi: Optional[int] = None,
    nb_pad: Optional[int] = None,
) -> _StreamArrays:
    """Build the forward token stream for docs in [doc_lo, doc_hi) with
    LOCAL doc ids (doc - doc_lo) — doc_lo=0/doc_hi=None is the whole
    segment.  Term ordinals are segment-global per field, so a sharded
    caller's weight matrices stay replicated across shards."""
    out = _StreamArrays()
    offs = segment.pos_offsets[field]
    data = segment.pos_data[field]
    base = segment.field_entry_base[field]
    n_ent = len(offs) - 1
    e_docs = segment.e_doc[base : base + n_ent].astype(np.int64)
    if doc_hi is None:
        doc_hi = segment.doc_count
    doc_count = doc_hi - doc_lo
    nb = max((doc_count + BM_BLOCK_DOCS - 1) // BM_BLOCK_DOCS, 1)
    out.n_blocks = nb
    out.nb_pad = nb_pad if nb_pad is not None else _nb_pad(nb)
    assert out.nb_pad >= nb

    # per-field term ordinals (the kernel's tid space)
    tmap = segment.terms[field]
    out.tid_of = {}
    tid_entry = np.zeros(max(n_ent, 1), dtype=np.int64)
    for j, (term, info) in enumerate(tmap.items()):
        out.tid_of[term] = j
        lo = info.start - base
        tid_entry[lo : lo + info.doc_freq] = j
    out.n_terms = len(tmap)
    out.ok = out.n_terms < TID_MASK  # tid 2^22-1 is the sentinel
    if not out.ok:
        return out

    # stream geometry: each LOCAL doc owns rows [row0[d], row0[d] +
    # maxpos[d] + 1 + KGAP); docs with no tokens in the field (or
    # tombstoned, or outside the range) own nothing
    lens = (offs[1:] - offs[:-1]).astype(np.int64)
    maxpos = np.full(doc_count, -1, dtype=np.int64)
    in_range = (e_docs >= doc_lo) & (e_docs < doc_hi)
    local_e = e_docs - doc_lo
    if n_ent:
        last = data[np.maximum(offs[1:] - 1, 0)].astype(np.int64)
        last = np.where(lens > 0, last, -1)
        np.maximum.at(
            maxpos, np.where(in_range, local_e, 0), np.where(in_range, last, -1)
        )
    live = ~segment.tombstones[doc_lo:doc_hi]
    has = (maxpos >= 0) & live
    dlen = np.where(has, maxpos + 1 + KGAP, 0)
    row0 = np.zeros(doc_count + 1, dtype=np.int64)
    np.cumsum(dlen, out=row0[1:])
    total_raw = int(row0[-1])

    raw = np.full(max(total_raw, 1), SENT_ROW, dtype=np.int32)
    if n_ent and total_raw:
        keep_e = in_range & has[np.where(in_range, local_e, 0)]
        rep_docs = np.repeat(local_e, lens * keep_e)
        rep_tids = np.repeat(tid_entry[:n_ent], lens * keep_e)
        pos_sel = _ragged_positions(data, offs, lens, keep_e)
        rows = row0[rep_docs] + pos_sel
        vals = rep_tids.astype(np.int64) | (
            (rep_docs % BM_BLOCK_DOCS) << TID_BITS
        )
        raw[rows] = vals.astype(np.int32)

    # per-block chunking with KGAP-row overlap: chunk i of a block
    # reads raw rows [i*(C-KGAP), i*(C-KGAP)+C) of the block's range
    usable = BM_CHUNK - KGAP
    blk_starts = row0[np.minimum(
        np.arange(nb, dtype=np.int64) * BM_BLOCK_DOCS, doc_count
    )]
    blk_ends = row0[np.minimum(
        (np.arange(nb, dtype=np.int64) + 1) * BM_BLOCK_DOCS, doc_count
    )]
    blk_len = blk_ends - blk_starts
    n_chunks = (blk_len + usable - 1) // usable  # 0 for empty blocks
    chunk_offs = np.zeros(out.nb_pad + 1, dtype=np.int32)
    np.cumsum(n_chunks, out=chunk_offs[1 : nb + 1])
    chunk_offs[nb + 1 :] = chunk_offs[nb]
    out.chunk_offs = chunk_offs
    total_chunks = int(chunk_offs[nb])

    size = _pack_rows(total_chunks)
    pack = np.full(size, SENT_ROW, dtype=np.int32)
    if total_chunks:
        blk_of = np.repeat(
            np.arange(nb, dtype=np.int64), n_chunks
        )
        within = (
            np.arange(total_chunks, dtype=np.int64)
            - chunk_offs[blk_of].astype(np.int64)
        )
        src0 = blk_starts[blk_of] + within * usable
        idx = src0[:, None] + np.arange(BM_CHUNK, dtype=np.int64)[None, :]
        valid = idx < blk_ends[blk_of][:, None]
        took = raw[np.where(valid, idx, 0)]
        pack[: total_chunks * BM_CHUNK] = np.where(
            valid, took, SENT_ROW
        ).reshape(-1)

    # per-doc BM25 denominator constants, laid out [block * 1024 +
    # doc_local] so a block reads one aligned 1024-f32 row
    cache = fieldnorm_cache(stats.avg_fieldnorm(field))
    fids = segment.fieldnorm_ids[field][doc_lo:doc_hi].astype(np.int64)
    cv = np.zeros(out.nb_pad * 1024, dtype=np.float32)
    didx = np.arange(doc_count, dtype=np.int64)
    cv[(didx // BM_BLOCK_DOCS) * 1024 + didx % BM_BLOCK_DOCS] = cache[
        fids
    ]
    # padded/empty doc slots keep cv=0; their tf is always 0, and the
    # tf > 0.5 gate excludes them before the 0/0 division could matter
    cv[cv == 0.0] = np.float32(1.0)
    # per-doc fieldnorm ids, same layout: the kernel packs each
    # block-max doc's exact INTEGER (tf, fid) class alongside the
    # f32 maxima, so the host can recompute bit-exact bounds with
    # its own float arithmetic (margin-free pruning)
    fid_arr = np.zeros(out.nb_pad * 1024, dtype=np.int32)
    fid_arr[(didx // BM_BLOCK_DOCS) * 1024 + didx % BM_BLOCK_DOCS] = fids
    out.pack = pack
    out.cv = cv
    out.fid = fid_arr
    return out


class TokenStreamPack:
    """Forward token stream of one (segment, field), block-major and
    chunk-overlapped for the phrase kernel (see module docstring)."""

    def __init__(self, segment: Segment, field: str, stats):
        arrs = build_stream_arrays(segment, field, stats)
        self.n_blocks = arrs.n_blocks
        self.nb_pad = arrs.nb_pad
        self.tid_of = arrs.tid_of
        self.n_terms = arrs.n_terms
        self.ok = arrs.ok
        if not self.ok:
            return
        self.chunk_offs = arrs.chunk_offs

        from fugu_tpu.ops import residency

        residency.reserve(
            ("tok", id(segment), field),
            arrs.pack.nbytes + arrs.cv.nbytes + arrs.fid.nbytes,
            segment,
            functools.partial(_evict_token_stream, field=field),
            kind="token_stream",
        )
        self.d_tok = jnp.asarray(arrs.pack)
        self.d_cv = jnp.asarray(arrs.cv)
        self.d_fid = jnp.asarray(arrs.fid)
        self.hbm_bytes = arrs.pack.nbytes + arrs.cv.nbytes + arrs.fid.nbytes


def _ragged_positions(data, offs, lens, keep_e):
    """data[offs[i]:offs[i]+lens[i]] concatenated over entries with
    keep_e[i] (the repeat/cumsum idiom, no Python loop)."""
    klens = lens * keep_e
    total = int(klens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    rep = np.repeat(offs[:-1].astype(np.int64), klens)
    within = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(klens) - klens, klens
    )
    return data[rep + within].astype(np.int64)


def _pack_rows(total_chunks: int) -> int:
    """Pack length bucket (jit signatures include shapes)."""
    from fugu_tpu.index.segment import _pow2_bucket

    return _pow2_bucket(max(total_chunks, 1) * BM_CHUNK)


def _evict_token_stream(seg: Segment, field: str) -> None:
    cache = getattr(seg, "_token_stream", None)
    if isinstance(cache, dict):
        cache.pop(field, None)


def get_token_stream(segment: Segment, field: str, stats) -> Optional[
    TokenStreamPack
]:
    """Cached per-field TokenStreamPack (rebuilt after deletes — keyed
    on the same df-sensitive stats fingerprint as Segment.block_major;
    residency-managed, so a cold field's stream can be evicted)."""
    from fugu_tpu.ops import residency

    if field not in segment.pos_offsets:
        return None
    cache = getattr(segment, "_token_stream", None)
    if not isinstance(cache, dict):
        cache = {}
        object.__setattr__(segment, "_token_stream", cache)
    hit = cache.get(field)
    if hit is not None and hit[0] == stats.fingerprint:
        residency.touch(("tok", id(segment), field))
        return hit[1]
    pack = TokenStreamPack(segment, field, stats)
    if not pack.ok:
        return None
    cache[field] = (stats.fingerprint, pack)
    # same reserve()->cache window as Segment.device_pack: a concurrent
    # reserve may have evicted this key in between — don't re-cache an
    # unaccounted pack (the local reference stays valid for this call)
    if not residency.contains(("tok", id(segment), field)):
        cache.pop(field, None)
    return pack


# --------------------------------------------------------------------------
# kernel
# --------------------------------------------------------------------------


#: token rows per inner step and queries per program of the sweep
_ROW_TILE = 64
_PHRASE_Q_TILE = 32


def _phrase_kernel(offs_ref, tok_ref, cv_ref, fid_ref, want_ref, wp_ref,
                   slop_ref, max_ref, cls_ref, *, kmax, smax, q_tile):
    """One program per (512-doc block, query tile): walk the block's
    chunks in row tiles, match every anchor row against each query's
    slots (shifted rows are shifted loads), count matches per doc with a
    one-hot product into a [block docs, q_tile] accumulator, then the
    score / fine-max / class epilogue."""
    j = pl.program_id(0)
    q0 = pl.program_id(1) * q_tile
    q = q0 + jnp.arange(q_tile)
    c0 = plgpu.load(offs_ref.at[j])
    c1 = plgpu.load(offs_ref.at[j + 1])
    wants = [plgpu.load(want_ref.at[jj, q])[None, :] for jj in range(kmax)]
    in_slop = [
        (ss <= plgpu.load(slop_ref.at[q]))[None, :] for ss in range(smax + 1)
    ]
    d_iota = jnp.arange(BM_BLOCK_DOCS)
    n_tiles = (BM_CHUNK - KGAP + _ROW_TILE - 1) // _ROW_TILE

    def tile(ti, acc, base):
        p = ti * _ROW_TILE + jnp.arange(_ROW_TILE)

        def tid_at(d):
            return plgpu.load(
                tok_ref.at[base + p + d], mask=p + d < BM_CHUNK,
                other=SENT_ROW,
            ) & TID_MASK

        x0 = plgpu.load(tok_ref.at[base + p])
        doc = jax.lax.shift_right_logical(x0, TID_BITS)
        match = (p < BM_CHUNK - KGAP)[:, None]
        for jj in range(kmax):
            hit = tid_at(jj)[:, None] == wants[jj]
            if jj:
                for ss in range(1, smax + 1):
                    hit = hit | (
                        (tid_at(jj + ss)[:, None] == wants[jj]) & in_slop[ss]
                    )
            match = match & (hit | (wants[jj] == -1))
        oh = (doc[None, :] == d_iota[:, None]).astype(jnp.bfloat16)
        return acc + pl.dot(oh, match.astype(jnp.bfloat16))

    def chunk(ci, acc):
        return jax.lax.fori_loop(
            0, n_tiles, functools.partial(tile, base=ci * BM_CHUNK), acc
        )

    tf = jax.lax.fori_loop(
        c0, c1, chunk, jnp.zeros((BM_BLOCK_DOCS, q_tile), jnp.float32)
    )
    cv = plgpu.load(cv_ref.at[j * 1024 + d_iota])[:, None]
    fid = plgpu.load(fid_ref.at[j * 1024 + d_iota])[:, None]
    score = plgpu.load(wp_ref.at[q])[None, :] * (tf / (tf + cv))
    matched = tf > 0.5
    res = jnp.where(matched, score, NEG_INF)
    cls = jnp.where(matched, tf.astype(jnp.int32) * 256 + (255 - fid), -1)
    for f in range(FINE_PER_BLOCK):
        inside = (
            (d_iota >= f * BM_FINE_DOCS) & (d_iota < (f + 1) * BM_FINE_DOCS)
        )[:, None]
        fmax = jnp.where(inside, res, NEG_INF).max(axis=0)
        fcls = jnp.where(inside & (res >= fmax[None, :]), cls, -1).max(axis=0)
        plgpu.store(max_ref.at[j, f, pl.ds(q0, q_tile)], fmax)
        plgpu.store(cls_ref.at[j, f, pl.ds(q0, q_tile)], fcls)


def _phrase_sweep(offs, tok, cv, fid, want, wp, slop, *, nb_pad, kmax, smax):
    """One pass over a token stream for a batch of phrases:
    ``(chunk_offs, tok, cv, fid, want, wp, slop) -> (maxima, classes)``,
    each [nb_pad, FINE_PER_BLOCK, b_pad].

    ``want[j, q]`` is the term ordinal of slot j of query q (-1: dead
    slot, matches anything; -2: padding query, matches nothing).  A row
    anchors a match of q when slot 0's term sits at the row and each
    later slot j's term sits at row + j + s for some s <= slop[q] — the
    oracle's ordered-window relaxation (ops/oracle.py).  Anchors in a
    chunk's last KGAP rows are skipped (the next chunk's overlapped head
    counts them), so tf IS the oracle's phrase_tf."""
    b_pad = wp.shape[0]
    q_tile = min(_PHRASE_Q_TILE, b_pad)
    kernel = functools.partial(
        _phrase_kernel, kmax=kmax, smax=smax, q_tile=q_tile
    )
    shape = (nb_pad, FINE_PER_BLOCK, b_pad)
    return pl.pallas_call(
        kernel,
        grid=(nb_pad, b_pad // q_tile),
        out_shape=(
            jax.ShapeDtypeStruct(shape, jnp.float32),
            jax.ShapeDtypeStruct(shape, jnp.int32),
        ),
        compiler_params=plgpu.CompilerParams(num_warps=8, num_stages=2),
        backend="triton",
        interpret=jax_setup.pallas_interpret(),
        name="fugu_phrase_sweep",
    )(offs, tok, cv, fid, want, wp, slop)


def _phrase_callable(nb_pad, kmax, smax):
    return functools.partial(_phrase_sweep, nb_pad=nb_pad, kmax=kmax, smax=smax)


_KERNEL_CACHE: dict = {}


def _get_kernel(nb_pad, b_pad, kmax, smax):
    key = (nb_pad, b_pad, kmax, smax)
    if key not in _KERNEL_CACHE:
        _KERNEL_CACHE[key] = jax.jit(_phrase_callable(nb_pad, kmax, smax))
    return _KERNEL_CACHE[key]


# --------------------------------------------------------------------------
# staging + host phase B
# --------------------------------------------------------------------------


def eligible_clause(pc: PhraseClause) -> bool:
    """Whether one phrase clause fits the stream kernel: <= KMAX terms,
    slop <= MAX_SLOP, positive boost, and forward reach (n_terms - 1 +
    slop) <= KGAP — beyond KGAP a shifted row can reach past the chunk
    overlap and the inter-doc sentinel gap no longer blocks cross-doc
    adjacency.  Sloppy dispatches additionally cap the
    kmax bucket at KGAP + 1 - MAX_SLOP (= 7 terms at slop > 0)."""
    if not pc.terms or len(pc.terms) > KMAX:
        return False
    slop = max(int(getattr(pc, "slop", 0) or 0), 0)
    if slop > MAX_SLOP:
        return False
    if slop and len(pc.terms) > KGAP + 1 - MAX_SLOP:
        return False
    if len(pc.terms) - 1 + slop > KGAP:
        return False
    if pc.boost <= 0.0:
        return False
    return True


def eligible_phrase(plan: QueryPlan) -> Optional[PhraseClause]:
    """The plan's phrase when the stream engine can serve it: ONE
    single-phrase SHOULD/MUST group (the quoted-query shape), slop <=
    MAX_SLOP (r5 — was slop 0), <= KMAX terms, default k1/b, positive
    boost.  Else None."""
    from fugu_tpu.query import B as B_CONST, K1

    if plan.match_all or plan.has_range or plan.has_subplan:
        return None
    if plan.k1 != float(K1) or plan.b != float(B_CONST):
        return None
    if len(plan.groups) != 1:
        return None
    g = plan.groups[0]
    if g.occur is Occur.MUST_NOT or g.clauses or g.ranges:
        return None
    if g.subplan is not None or len(g.phrases) != 1:
        return None
    pc = g.phrases[0]
    if not eligible_clause(pc):
        return None
    return pc


def phrase_stream_begin(
    segment: Segment,
    plans: Sequence[QueryPlan],
    stats,
    limits: Sequence[int],
    min_batch: int = PHRASE_MIN_BATCH,
):
    """Stage and dispatch the phrase batch; returns a handle for
    :func:`phrase_stream_collect`.  ``pre`` (handle[0]) carries results
    resolved without the sweep ([] for absent terms) aligned to
    ``plans``; ``staged`` entries are (plan_index, clause) pairs the
    sweep will answer; non-eligible plans stay None throughout.  A field
    with fewer than ``min_batch`` runnable phrases stays on the host."""
    pre: List[Optional[List[Tuple[float, int]]]] = [None] * len(plans)
    staged: List[Tuple[int, PhraseClause]] = []
    by_field: Dict[str, List[int]] = {}
    clauses: Dict[int, PhraseClause] = {}
    for i, plan in enumerate(plans):
        pc = eligible_phrase(plan)
        if pc is None or limits[i] > 128:
            continue
        clauses[i] = pc
        by_field.setdefault(pc.field, []).append(i)

    dispatches = []
    for field, idxs in sorted(by_field.items()):
        pack = get_token_stream(segment, field, stats)
        if pack is None:
            continue
        # absent terms can't match anything in this segment
        run = []
        for i in idxs:
            if any(t not in pack.tid_of for t in clauses[i].terms):
                pre[i] = []
            else:
                run.append(i)
        if len(run) < max(min_batch, 1):
            for i in run:
                del clauses[i]  # host path serves these
            continue
        for q_idx, smax in split_dispatch_groups(run, clauses):
            dispatches.append(
                _dispatch_group(pack, q_idx, clauses, stats, smax)
            )
            for i in q_idx:
                staged.append((i, clauses[i]))
    return (pre, staged, dispatches, segment, stats, list(limits))


def _clause_slop(pc: PhraseClause) -> int:
    return max(int(getattr(pc, "slop", 0) or 0), 0)


def split_dispatch_groups(run, clauses) -> List[Tuple[List[int], int]]:
    """[(q_idx, smax)] dispatch groups for ``run`` (eligible plan
    indices, in order) — shared by the single-device and sharded begins.

    slop-0 and sloppy queries dispatch separately: the sloppy program
    (smax=MAX_SLOP) compares (slop+1)x shifted rows per slot and
    compiles a different signature.  Each sub-run pays its own sweep, in
    groups of at most PB_BUCKETS[-1] queries."""
    out: List[Tuple[List[int], int]] = []
    cap = PB_BUCKETS[-1]
    for smax in (0, MAX_SLOP):
        sub = [i for i in run if bool(_clause_slop(clauses[i])) == bool(smax)]
        out.extend(
            (sub[lo : lo + cap], smax) for lo in range(0, len(sub), cap)
        )
    return out


def stage_group_weights(tid_of, q_idx, clauses, stats, smax):
    """(want, wp, slop, b_pad, kmax) sweep operands for one dispatch
    group — shared by the single-device and sharded launchers (term
    ordinals are segment-global per field, so the sharded path
    replicates these across shards verbatim).  See :func:`_phrase_sweep`
    for ``want``'s encoding."""
    kmax_need = max(len(clauses[i].terms) for i in q_idx)
    b_pad = next(b for b in PB_BUCKETS if len(q_idx) <= b)
    kb = PK_SLOP_BUCKETS if smax else PK_BUCKETS
    kmax = next(k for k in kb if kmax_need <= k)
    want = np.full((kmax, b_pad), -1, dtype=np.int32)
    want[0, len(q_idx) :] = -2  # padding queries match nothing
    wp = np.zeros(b_pad, dtype=np.float32)
    slop = np.zeros(b_pad, dtype=np.int32)
    for qi, i in enumerate(q_idx):
        pc = clauses[i]
        for jj, t in enumerate(pc.terms):
            want[jj, qi] = tid_of[t]
        slop[qi] = min(_clause_slop(pc), smax)
        dfs = [stats.doc_freq(pc.field, t) for t in pc.terms]
        wp[qi] = float(bm25_weight(max(dfs), stats.doc_count, pc.boost))
    return want, wp, slop, b_pad, kmax


def _dispatch_group(pack, q_idx, clauses, stats, smax=0):
    """Stage operands and launch the sweep for one group."""
    want, wp, slop, b_pad, kmax = stage_group_weights(
        pack.tid_of, q_idx, clauses, stats, smax
    )
    fn = _get_kernel(pack.nb_pad, b_pad, kmax, smax)
    with jax.profiler.TraceAnnotation(
        f"fugu:phrase_sweep b={b_pad} k={kmax} s={smax}"
    ):
        amax, acls = fn(
            jnp.asarray(pack.chunk_offs),
            pack.d_tok,
            pack.d_cv,
            pack.d_fid,
            jnp.asarray(want),
            jnp.asarray(wp),
            jnp.asarray(slop),
        )
    return (q_idx, (amax, acls), b_pad)


#: fine blocks whose (value, class, id) the phrase postprocessor ships
#: per query, sorted by bound descending.  64 covers limit<=10 scans by
#: a wide margin (ties terminate via the doc-id rule after ~limit hits)
#: while keeping the fetched buffer small.  Queries whose scan is
#: inconclusive within the shipped blocks fall back to a full-common
#: match (correct, rare).
PHRASE_TOPK = 64

_PHRASE_POST_CACHE: dict = {}


def _get_phrase_post(nb_pad: int, b_pad: int):
    """Device postproc for phrase dispatches: per query the top-K fine
    blocks by maxima (achievable scores!), their EXACT integer
    (tf, fid) classes, ids, and the finite count — the host recomputes
    each block's bound bit-exactly from the class with its own float
    arithmetic and scans in bound order with margin-free termination.

    (A kth-thresholded MASK, as phase A ships, fails here: for
    near-tied phrase scores (tf=1 everywhere) the threshold keeps nearly
    every matching block and the host re-matches them all with no order
    to stop in.)"""
    key = (nb_pad, b_pad)
    fn = _PHRASE_POST_CACHE.get(key)
    if fn is not None:
        return fn
    nb2 = nb_pad * FINE_PER_BLOCK
    k = min(PHRASE_TOPK, nb2)

    @jax.jit
    def post(amax, acls):
        col = amax.reshape(nb2, -1).T                   # [B, NB*F]
        ccol = acls.reshape(nb2, -1).T                  # [B, NB*F] i32
        finite = jnp.isfinite(col)
        count = jnp.sum(finite.astype(jnp.int32), axis=1)   # [B]
        vals, idx = top_k_lowest(col, k)                # [B, k] desc
        cls = jnp.take_along_axis(ccol, idx, axis=1)
        # one buffer: [B, 3k+1] f32 (ids < 2^24 and classes < 2^24 stay
        # f32-exact)
        return jnp.concatenate(
            [
                vals,
                idx.astype(jnp.float32),
                cls.astype(jnp.float32),
                count[:, None].astype(jnp.float32),
            ],
            axis=1,
        )

    _PHRASE_POST_CACHE[key] = post
    return post


def phrase_stream_collect(handle):
    """Finish the batch: fetch per-query ordered block bounds, then
    host-match in bound order with early termination.  Returns a list
    aligned with the plans given to begin (None = not served here)."""
    from fugu_tpu.ops.phrase import PhraseMatcher

    pre, staged, dispatches, segment, stats, limits = handle
    results = list(pre)
    if not dispatches:
        return results

    posts = [
        _get_phrase_post(arrs[0].shape[0], b_pad)(*arrs)
        for _q, arrs, b_pad in dispatches
    ]
    bufs = jax_setup.fetch_np(posts)

    clause_of = dict(staged)
    nb = max((segment.doc_count + BM_BLOCK_DOCS - 1) // BM_BLOCK_DOCS, 1)
    nb2 = nb * FINE_PER_BLOCK
    for (q_idx, _a, _b), buf in zip(dispatches, bufs):
        k = (buf.shape[1] - 1) // 3
        for qi, i in enumerate(q_idx):
            row = buf[qi]
            count = int(row[-1])
            if count == 0:
                results[i] = []
                continue
            ids = row[k : 2 * k].astype(np.int64)
            cls = row[2 * k : 3 * k].astype(np.int64)
            take = min(count, k)
            # padded-block entries (id >= nb2) carry NEG_INF and sort
            # after every finite bound; trim alongside the finite count
            keep = ids[:take] < nb2
            results[i] = _rescore_blocks(
                segment,
                clause_of[i],
                stats,
                ids[:take][keep],
                cls[:take][keep],
                count > k,
                limits[i],
            )
    return results


#: relative guard band for device-argmax class flips: the kernel picks
#: each block's class by device-f32 score, whose rounding differs from
#: the host's by a few ulp (~1e-7 rel) — any block whose exact bound
#: sits within this band of the kth must be visited (or trigger the
#: fallback), making the pruning airtight without a bf16-sized margin
_CLS_GUARD = 1e-6


def _rescore_blocks(
    segment, pc, stats, fine_ids, classes, truncated, limit,
    lo_table=None, hi_table=None,
):
    """Exact host top-k over candidate fine blocks in descending-bound
    order with margin-free early termination.

    ``lo_table``/``hi_table`` (optional): per-fine-id doc windows for
    callers whose id space is not the plain ``id * BM_FINE_DOCS``
    layout — the sharded engine maps global padded fine ids onto
    per-shard doc ranges (clamped at shard bounds so windows never
    overlap a neighbour shard's block 0).  Tables must be monotone
    non-decreasing in id (id order == doc order), which the shard
    layout guarantees.

    ``classes`` are the kernel's per-block INTEGER (tf << 8 | 255-fid)
    classes of the score-argmax doc; the host recomputes each bound
    with the same np.float32 expression as final scoring, so
    bound-vs-kth comparisons are exact.  Ties (bound == kth) use the
    doc-id rule: blocks are doc-ranges in id order, so a tied block
    whose range starts at or past the current limit-th holder's doc id
    cannot displace it (doc-ascending tie-break).  Candidate matching
    runs through ops/phrase.match_ranges — windowed posting lookups,
    no full intersection — so host work scales with limit, not df."""
    from fugu_tpu.ops.phrase import match_ranges

    if len(fine_ids) == 0:
        return []
    dfs = [stats.doc_freq(pc.field, t) for t in pc.terms]
    if max(dfs) == 0:
        return []
    w = np.float32(bm25_weight(max(dfs), stats.doc_count, pc.boost))
    cache = fieldnorm_cache(stats.avg_fieldnorm(pc.field))
    fid_all = segment.fieldnorm_ids[pc.field]

    tf_c = (classes >> 8).astype(np.float32)
    fid_c = (255 - (classes & 255)).astype(np.int64)
    bounds = (w * (tf_c / (tf_c + cache[fid_c]))).astype(np.float32)

    order = np.lexsort((fine_ids, -bounds))
    ids_o = fine_ids[order]
    bnd_o = bounds[order]

    def lo_of(ids):
        if lo_table is None:
            return ids * BM_FINE_DOCS
        return lo_table[ids]

    def hi_of(ids):
        if hi_table is None:
            return ids * BM_FINE_DOCS + BM_FINE_DOCS
        return hi_table[ids]

    hits_docs: List[np.ndarray] = []
    hits_scores: List[np.ndarray] = []
    n_hits = 0
    kth = None        # limit-th best score so far
    worst_doc = None  # its doc id (ties displace only below this)

    remaining = np.arange(len(ids_o))
    group = 8
    while len(remaining):
        if kth is not None:
            b = bnd_o[remaining]
            keep = (
                (b > kth)
                | ((b == kth) & (lo_of(ids_o[remaining]) < worst_doc))
                | ((b < kth) & (kth - b <= abs(kth) * _CLS_GUARD))
            )
            remaining = remaining[keep]
            if not len(remaining):
                break
        chunk, remaining = remaining[:group], remaining[group:]
        sel = np.sort(ids_o[chunk])
        docs, ptf = match_ranges(segment, pc, lo_of(sel), hi_of(sel))
        if len(docs):
            ptf_f = ptf.astype(np.float32)
            fids = fid_all[docs].astype(np.int64)
            scores = w * (ptf_f / (ptf_f + cache[fids]))
            hits_docs.append(docs.astype(np.int64))
            hits_scores.append(scores)
            n_hits += len(docs)
            if n_hits >= limit:
                alls = np.concatenate(hits_scores)
                alld = np.concatenate(hits_docs)
                top = np.lexsort((alld, -alls))[:limit]
                kth = float(alls[top[-1]])
                worst_doc = int(alld[top[-1]])
        group = min(group * 4, 1024)

    need_fallback = truncated
    if need_fallback and kth is not None and len(bnd_o):
        b_min = float(bnd_o[-1])
        if b_min < kth - abs(kth) * _CLS_GUARD:
            # every unshipped block's true bound sits below kth with
            # margin to spare (device ordering is within ~1e-7)
            need_fallback = False
        elif b_min == kth and worst_doc is not None:
            # unshipped ties: same-class blocks share the same device
            # value, and top_k keeps the lowest ids, so every unshipped
            # tied block starts past the shipped ones — skippable iff
            # even the next id couldn't reach worst_doc AND no OTHER
            # class collides with kth (a colliding class's blocks may
            # order differently in device f32)
            tied = ids_o[bnd_o == b_min]
            next_id = int(tied.max()) + 1
            if lo_table is None:
                next_lo = next_id * BM_FINE_DOCS
            elif next_id < len(lo_table):
                next_lo = int(lo_table[next_id])
            else:
                next_lo = segment.doc_count
            if next_lo >= worst_doc and not _class_collides(kth, w, cache):
                need_fallback = False

    if need_fallback:
        # exact, slow path: match the full intersection
        from fugu_tpu.ops.phrase import PhraseMatcher

        matcher = PhraseMatcher(segment, pc)
        if not matcher.ok or len(matcher.common) == 0:
            return []
        docs, ptf = matcher.match(
            np.arange(len(matcher.common), dtype=np.int64)
        )
        if len(docs) == 0:
            return []
        ptf_f = ptf.astype(np.float32)
        fids = fid_all[docs].astype(np.int64)
        scores = w * (ptf_f / (ptf_f + cache[fids]))
        order2 = np.lexsort((docs, -scores))[:limit]
        return [(float(scores[o]), int(docs[o])) for o in order2]

    if not hits_docs:
        return []
    docs = np.concatenate(hits_docs)
    scores = np.concatenate(hits_scores)
    order2 = np.lexsort((docs, -scores))[:limit]
    return [(float(scores[o]), int(docs[o])) for o in order2]


def _class_collides(kth: float, w, cache) -> bool:
    """True when MORE THAN ONE (tf, fid) class scores exactly ``kth``
    — then device-f32 ordering between the colliding classes is not
    guaranteed to match the host tie order and the unshipped-ties skip
    is unsafe.  Per fid, the candidate tf solves kth = w*tf/(tf+cv)
    analytically; only its integer neighbours can produce the exact f32
    value, so the check is ~256 x 4 score evaluations."""
    w64 = float(np.float32(w))
    if not (0.0 < kth < w64):
        return True  # degenerate; be conservative
    cv = cache.astype(np.float64)
    t_est = kth * cv / (w64 - kth)
    hits = 0
    for delta in (-1.0, 0.0, 1.0, 2.0):
        tf = np.floor(t_est) + delta
        ok = tf >= 1.0
        tf32 = tf.astype(np.float32)
        sc = np.float32(w) * (tf32 / (tf32 + cache))
        hits += int(((sc == np.float32(kth)) & ok).sum())
        if hits > 1:
            return True
    return hits > 1


def batch_phrase_search(
    segment: Segment,
    plans: Sequence[QueryPlan],
    stats,
    limits: Sequence[int],
    min_batch: int = PHRASE_MIN_BATCH,
) -> List[Optional[List[Tuple[float, int]]]]:
    """Synchronous begin+collect (None entries = caller's host path)."""
    return phrase_stream_collect(
        phrase_stream_begin(segment, plans, stats, limits, min_batch)
    )
