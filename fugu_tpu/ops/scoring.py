"""The device query engine: BM25 + boolean algebra + top-k, all under jit.

This replaces the hot loop inside Tantivy's ``searcher.search`` — the
per-segment postings traversal, BM25 scoring and heap top-k
(`/root/reference/src/db/search.rs:153-162`, SURVEY.md §3.3) — with a
fully vectorized pipeline:

1. **Window gather** — each clause's postings are a contiguous range of the
   segment's (doc, tf|fid) entry pack; ``dynamic_slice`` windows
   (bucket-padded) read them without host round-trips.
2. **BM25 contribution** — ``w_t * tf / (tf + c1_t + c2_t * decode(fid))``
   with the Lucene-SmallFloat fieldnorm decode done arithmetically on the
   VPU (no table gather).  Facet filter clauses use c2=0 so they score a
   constant idf — filter fusion without a separate bitset pass.
3. **Bitonic merge network** — the stacked (already sorted) clause windows
   merge in ~log T * log L compare-exchange passes (see merge_sorted_rows).
4. **Run aggregation** — runs are <= T long, so per-doc score sums and the
   OR of clause-group bit masks are T-1 static shifted adds (boolean
   algebra: MUST / MUST_NOT / SHOULD evaluated from a 32-bit group mask).
5. **Tombstone mask + top-k** — run-end entries are scored, dead docs and
   failed boolean constraints get -inf, and ``lax.top_k`` selects.

The Pallas block scorer (ops/pallas_scorer.py) is the faster engine for
large corpora; this XLA pipeline remains the second engine (smaller
compile footprint, used for small/medium segments and as the fallback).

Ties: runs are emitted in ascending doc order and :func:`top_k_lowest`
keeps the earliest index on equal scores, so ordering is score desc then
doc asc — the deterministic tiebreak we define for parity (SURVEY.md §7).
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fugu_tpu import jax_setup
from fugu_tpu.index.segment import (
    DOC_SENTINEL,
    FACET_FIELD_KEY,
    Segment,
    pack_entry_size,
)

jax_setup.configure()
from fugu_tpu.ops import buckets
from fugu_tpu.query import (
    Occur,
    QueryPlan,
    bm25_denom_consts,
    bm25_weight,
    idf,
)

NEG_INF = np.float32(-np.inf)


def _decode_fid(fid):
    """Branch-free Lucene SmallFloat 4-bit decode — the single shared
    implementation in fugu_tpu.fieldnorm, bound to the jnp namespace for
    tracers."""
    from fugu_tpu.fieldnorm import decode_fid_arithmetic

    return decode_fid_arithmetic(fid, jnp)


def merge_sorted_rows(keys, *payloads):
    """Merge T sorted rows [T, L] into one sorted flat array [T*L].

    A bitonic merge *network*, not a full sort: each level pairs rows
    (second one reversed → bitonic), then runs log2(2M) compare-exchange
    passes expressed as reshapes + min/max — pure VPU work XLA fuses
    well, an order of magnitude fewer passes than ``lax.sort`` on the
    concatenation.  T and L must be powers of two (bucketing guarantees
    it); ascending; sentinel keys sink to the tail.
    """
    arrs = (keys,) + payloads
    T, L = keys.shape
    while T > 1:
        # pair rows: a = even rows, b = odd rows reversed -> bitonic
        a = [x[0::2] for x in arrs]
        b = [jnp.flip(x[1::2], axis=-1) for x in arrs]
        arrs = [jnp.concatenate([xa, xb], axis=-1) for xa, xb in zip(a, b)]
        T //= 2
        M = arrs[0].shape[-1]
        s = M // 2
        while s >= 1:
            shaped = [x.reshape(T, M // (2 * s), 2, s) for x in arrs]
            lo = [x[:, :, 0, :] for x in shaped]
            hi = [x[:, :, 1, :] for x in shaped]
            swap = lo[0] > hi[0]
            new_lo = [jnp.where(swap, h, l) for l, h in zip(lo, hi)]
            new_hi = [jnp.where(swap, l, h) for l, h in zip(lo, hi)]
            arrs = [
                jnp.stack([nl, nh], axis=2).reshape(T, M)
                for nl, nh in zip(new_lo, new_hi)
            ]
            s //= 2
    return tuple(x.reshape(-1) for x in arrs)


class ClauseArgs(NamedTuple):
    """Per-clause device operands (host-staged numpy, padded to T)."""

    starts: np.ndarray   # int32[T] offset into the entry pack
    lens: np.ndarray     # int32[T] posting length (0 = inactive)
    weights: np.ndarray  # float32[T] idf*(k1+1)*boost
    c1: np.ndarray       # float32[T] k1*(1-b)    (facet clauses: k1)
    c2: np.ndarray       # float32[T] k1*b/avg    (facet clauses: 0)
    gbits: np.ndarray    # uint32[T] 1 << group_id


def segment_topk_merge_impl(
    e_doc,
    e_tffid,
    tomb_words,
    starts,
    lens,
    weights,
    c1,
    c2,
    gbits,
    must_mask,
    mustnot_mask,
    should_mask,
    *,
    t_pad: int,
    l_pad: int,
    k: int,
    need_bits: bool,
):
    """Merge-network scoring kernel (the fast path).

    Clause windows stay stacked [T, L] (no packed scatter), a T-way
    bitonic merge network replaces a full sort, and —
    because each clause contributes a doc at most once, so runs have
    length <= T — per-doc aggregation is T-1 static shifted adds instead
    of a log-N segmented scan.  Compile signature loses the E dimension.
    """
    lane = jnp.arange(l_pad, dtype=jnp.int32)

    doc_rows, con_rows, bit_rows = [], [], []
    for t in range(t_pad):
        s = starts[t]
        docs = jax.lax.dynamic_slice(e_doc, (s,), (l_pad,))
        packed = jax.lax.dynamic_slice(e_tffid, (s,), (l_pad,))
        tfs = packed & 0xFFFFFF
        fids = (packed >> 24) & 0xFF
        valid = lane < lens[t]
        tff = tfs.astype(jnp.float32)
        denom = tff + c1[t] + c2[t] * _decode_fid(fids).astype(jnp.float32)
        con_rows.append(jnp.where(valid, weights[t] * (tff / denom), 0.0))
        doc_rows.append(jnp.where(valid, docs, jnp.int32(DOC_SENTINEL)))
        bit_rows.append(jnp.where(valid, gbits[t], jnp.uint32(0)))

    if t_pad == 1:
        doc_s, con_s, bit_s = doc_rows[0], con_rows[0], bit_rows[0]
    else:
        doc_s, con_s, bit_s = merge_sorted_rows(
            jnp.stack(doc_rows), jnp.stack(con_rows), jnp.stack(bit_rows)
        )

    # aggregate runs (length <= t_pad) with backward shifts
    total = con_s
    bits_total = bit_s
    for w in range(1, t_pad):
        pd = jnp.concatenate([jnp.full(w, -1, doc_s.dtype), doc_s[:-w]])
        pc = jnp.concatenate([jnp.zeros(w, con_s.dtype), con_s[:-w]])
        pb = jnp.concatenate([jnp.zeros(w, bit_s.dtype), bit_s[:-w]])
        m = pd == doc_s
        total = total + jnp.where(m, pc, 0.0)
        if need_bits:
            bits_total = bits_total | jnp.where(m, pb, jnp.uint32(0))

    end_flag = jnp.concatenate([doc_s[1:] != doc_s[:-1], jnp.ones(1, dtype=bool)])
    ok = end_flag & (doc_s != jnp.int32(DOC_SENTINEL))
    if need_bits:
        ok &= (bits_total & must_mask) == must_mask
        ok &= (bits_total & mustnot_mask) == 0
        ok &= ((bits_total & should_mask) != 0) | (should_mask == 0)
    word = tomb_words[jnp.clip(doc_s >> 5, 0, tomb_words.shape[0] - 1)]
    ok &= ((word >> (doc_s & 31).astype(jnp.uint32)) & 1) == 0

    score = jnp.where(ok, total, NEG_INF)
    kk = min(k, t_pad * l_pad)
    top_scores, idx = top_k_lowest(score, kk)
    return top_scores, doc_s[idx]


def top_k_lowest(x, k: int):
    """``lax.top_k`` over the last axis of a 1-D or 2-D array, with equal
    values resolved toward the LOWEST index and the result ordered by
    (value desc, index asc).

    The engines' tie contract (score desc, doc asc) rests on this: XLA's
    GPU top_k promises no order among equal values, and a corpus holds
    many exact ties (same tf, same fieldnorm).  The kth value fixes the
    set: everything above it, plus the lowest-index entries equal to it."""
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    n_rows = x.shape[0]
    kth = jax.lax.top_k(x, k)[0][:, k - 1 : k]
    above = x > kth
    tied = x == kth
    room = k - jnp.sum(above, axis=1, keepdims=True, dtype=jnp.int32)
    take = above | (tied & (jnp.cumsum(tied, axis=1, dtype=jnp.int32) <= room))
    rank = jnp.cumsum(take, axis=1, dtype=jnp.int32) - 1
    rows = jax.lax.broadcasted_iota(jnp.int32, x.shape, 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, x.shape, 1)
    idx = (
        jnp.zeros((n_rows, k + 1), jnp.int32)
        .at[rows, jnp.where(take, rank, k)]
        .set(cols)[:, :k]
    )
    vals = jnp.take_along_axis(x, idx, axis=1)
    neg, idx = jax.lax.sort((-vals, idx), dimension=1, num_keys=2)
    vals = -neg
    if squeeze:
        return vals[0], idx[0]
    return vals, idx


def mask_i32(mask: int) -> int:
    """Group masks are 32-bit patterns built as Python ints; group index
    31 sets bit 31 (2**31), which overflows an int32 numpy assignment.
    Wrap to two's-complement — the kernels' bitwise tests are
    representation-level, so the sign bit is just another bit."""
    return mask - (1 << 32) if mask >= (1 << 31) else mask


def has_nonpositive_weight(plan: QueryPlan, stats) -> bool:
    """True when any SCORING clause's idf weight is <= 0 — possible only
    in the tombstone-inflated-df regime (df counts dead docs until
    merge, doc_count counts live ones, so df > N makes
    ln(1 + (N-df+.5)/(df+.5)) negative; Tantivy scores identically).

    Every device engine encodes "matched" as ``scores > 0`` for its
    pure/neg/gate/shift kinds, which silently DROPS negatively-scored
    hits (found r5: a majority-term query on a tombstoned corpus came
    back empty while the oracle returned 100 hits).  Callers route these
    plans to the host chain (block-max -> oracle), which is
    sign-correct.

    Exception: a single-facet MUST group is safe at any sign — the gate
    and shift kinds move its constant OUT of the kernel score (GATE_BIG
    gating / host re-shift), and the block kernel's boolean path matches
    it by presence bits, so a negative facet idf (e.g. an ancestor path
    carried by every doc on a tombstoned index) never meets the
    ``scores > 0`` test."""
    from fugu_tpu.query import Occur, idf

    for g in plan.groups:
        if g.occur is Occur.MUST_NOT:
            continue
        if (
            g.occur is Occur.MUST
            and len(g.clauses) == 1
            and g.clauses[0].is_facet
            and not g.phrases
            and not g.ranges
            and g.subplan is None
        ):
            continue
        for c in g.clauses:
            df = (
                stats.facet_doc_freq(c.term)
                if c.is_facet
                else stats.doc_freq(c.field, c.term)
            )
            if df > 0 and float(idf(df, stats.doc_count)) <= 0.0:
                return True
        if g.subplan is not None and has_nonpositive_weight(
            g.subplan, stats
        ):
            return True
    return False


def stage_clauses(
    segment: Segment,
    plan: QueryPlan,
    stats,
    t_pad: int,
) -> Tuple[Optional[ClauseArgs], int, int, int, bool]:
    """Flatten a QueryPlan into per-clause device operands for one segment.

    Returns (args, must_mask, mustnot_mask, should_mask, need_bits);
    args is None when the plan cannot run on device (phrases, >32 groups
    with constraints, match_all) — callers fall back to the oracle.
    """
    if plan.host_only:
        return None, 0, 0, 0, False

    starts: List[int] = []
    lens: List[int] = []
    weights: List[float] = []
    c1s: List[float] = []
    c2s: List[float] = []
    gbits: List[int] = []
    must_mask = 0
    mustnot_mask = 0
    should_mask = 0
    k1 = float(plan.k1)
    b = float(plan.b)

    n_groups = len(plan.groups)
    has_constraints = any(g.occur is not Occur.SHOULD for g in plan.groups)
    if has_constraints and n_groups > 32:
        return None, 0, 0, 0, False

    for gi, group in enumerate(plan.groups):
        bit = 1 << (gi % 32)
        if group.occur is Occur.MUST:
            must_mask |= bit
        elif group.occur is Occur.MUST_NOT:
            mustnot_mask |= bit
        else:
            should_mask |= bit
        for clause in group.clauses:
            if clause.is_facet:
                df = stats.facet_doc_freq(clause.term)
                info = segment.term_info(FACET_FIELD_KEY, clause.term)
                if df == 0:
                    continue
                w = float(idf(df, stats.doc_count)) * clause.boost
                # facet component is tf/(tf+k1) with tf==1 -> 1/(1+k1);
                # fold the normalization into the weight so score == idf.
                weights.append(w * (1.0 + k1))
                c1s.append(k1)
                c2s.append(0.0)
            else:
                df = stats.doc_freq(clause.field, clause.term)
                info = segment.term_info(clause.field, clause.term)
                if df == 0:
                    continue
                avg = stats.avg_fieldnorm(clause.field)
                weights.append(
                    float(bm25_weight(df, stats.doc_count, clause.boost, k1))
                )
                # shared f32 constants: the kernel's c1 + c2*norm must
                # reproduce the host fieldnorm_cache bit-for-bit
                cc1, cc2 = bm25_denom_consts(avg, k1, b)
                c1s.append(float(cc1))
                c2s.append(float(cc2))
            starts.append(info.start if info else 0)
            lens.append(info.doc_freq if info else 0)
            gbits.append(bit)

    # Tantivy boolean semantics: SHOULD groups are optional whenever any
    # MUST group exists — unless the plan's require_should preserves the
    # inner text query's constraint (see QueryPlan.require_should).
    if must_mask and not plan.require_should:
        should_mask = 0
    if must_mask and should_mask:
        has_constraints = True

    n = len(starts)
    if n == 0:
        return None, must_mask, mustnot_mask, should_mask, has_constraints
    if n > t_pad:
        raise ValueError(f"{n} clauses exceed t_pad={t_pad}")

    pad = t_pad - n
    args = ClauseArgs(
        starts=np.array(starts + [0] * pad, dtype=np.int32),
        lens=np.array(lens + [0] * pad, dtype=np.int32),
        weights=np.array(weights + [0.0] * pad, dtype=np.float32),
        c1=np.array(c1s + [1.0] * pad, dtype=np.float32),
        c2=np.array(c2s + [0.0] * pad, dtype=np.float32),
        gbits=np.array(gbits + [0] * pad, dtype=np.uint32),
    )
    # bits are needed whenever constraints exist OR score-parity demands
    # knowing that at least one SHOULD matched (always true for runs —
    # every entry comes from a matching clause), so only constraints matter.
    return args, must_mask, mustnot_mask, should_mask, has_constraints


@functools.partial(
    jax.jit, static_argnames=("t_pad", "l_pad", "k", "need_bits")
)
def segment_topk_batch(
    e_doc,
    e_tffid,
    tomb_words,
    starts,     # int32[B, T]
    lens,
    weights,    # float32[B, T]
    c1,
    c2,
    gbits,      # uint32[B, T]
    must,       # uint32[B]
    mustnot,
    should,
    *,
    t_pad,
    l_pad,
    k,
    need_bits,
):
    """Query-batched merge-network kernel: one dispatch scores B queries.

    Per-dispatch overhead dwarfs one query's compute, so a batch pays
    it once.
    """

    def one(s, l, w, a1, a2, g, m, mn, sh):
        return segment_topk_merge_impl(
            e_doc, e_tffid, tomb_words, s, l, w, a1, a2, g, m, mn, sh,
            t_pad=t_pad, l_pad=l_pad, k=k, need_bits=need_bits,
        )

    return jax.vmap(one)(starts, lens, weights, c1, c2, gbits, must, mustnot, should)


#: cap on B*T*L lanes per dispatch (memory + compile-shape control)
MAX_BATCH_LANES = 64 * 1024 * 1024
#: merge kernel handles up to this many clauses; beyond -> oracle
MERGE_MAX_T = 16


def device_search_batch(
    segment: Segment,
    plans: Sequence[QueryPlan],
    stats,
    limit: int,
) -> List[Optional[List[Tuple[float, int]]]]:
    """Run many queries over one segment with batched device dispatches.

    Returns one entry per plan: [(score, local_doc)] (score desc, doc asc),
    [] when the plan provably matches nothing, or None when that plan must
    take the oracle fallback (match_all / phrases / >32 constrained groups
    / beyond the largest bucket).
    """
    results: List[Optional[List[Tuple[float, int]]]] = [None] * len(plans)
    if limit > buckets.K_BUCKETS[-1]:
        # beyond the extraction ladder: falling back beats silently
        # truncating the result set to 4096 and presenting it as exact
        return results
    k = buckets.k_bucket(limit)
    groups: dict = {}
    for i, plan in enumerate(plans):
        if plan.host_only:
            continue
        # no has_nonpositive_weight gate here: the merge-network kernel
        # matches by group bits, not by ``scores > 0`` — verified
        # sign-correct by test_scoring_device.test_tombstones_on_device
        # (negative-idf regime, exact oracle parity)
        n_clauses = sum(len(g.clauses) for g in plan.groups)
        t_pad = buckets.t_bucket(max(n_clauses, 1))
        if t_pad > MERGE_MAX_T:
            continue  # fallback
        args, must, mustnot, should, need_bits = stage_clauses(
            segment, plan, stats, t_pad
        )
        if args is None:
            has_constraints = any(g.occur is not Occur.SHOULD for g in plan.groups)
            if has_constraints and len(plan.groups) > 32:
                continue  # fallback
            results[i] = []  # no clause has postings -> provably empty
            continue
        max_len = int(args.lens.max())
        if max_len > buckets.L_BUCKETS[-1]:
            continue  # fallback
        l_pad = buckets.l_bucket(max_len)
        # a clause window must stay inside the device entry pack: the
        # bucket ladder is coarse (16x steps), so start + l_pad can
        # exceed the pack's +8192 slack — dynamic_slice would then CLAMP
        # the start and score other terms' postings as this clause's
        # (silently wrong top-k).  Route such plans to the fallback.
        if int(args.starts.max()) + l_pad > pack_entry_size(
            len(segment.e_doc)
        ):
            continue  # fallback
        sig = (t_pad, l_pad, need_bits)
        groups.setdefault(sig, []).append((i, args, must, mustnot, should))

    for (t_pad, l_pad, need_bits), items in groups.items():
        e_docd, e_tffidd, tombd = segment.device_pack()
        b_cap = max(1, MAX_BATCH_LANES // (t_pad * l_pad))
        b_allowed = max([b for b in buckets.B_BUCKETS if b <= b_cap] or [1])
        pos = 0
        while pos < len(items):
            b_pad = min(buckets.b_bucket(len(items) - pos), b_allowed)
            chunk = items[pos : pos + b_pad]
            pos += len(chunk)
            n = len(chunk)
            starts = np.zeros((b_pad, t_pad), dtype=np.int32)
            lens = np.zeros((b_pad, t_pad), dtype=np.int32)
            weights = np.zeros((b_pad, t_pad), dtype=np.float32)
            c1 = np.ones((b_pad, t_pad), dtype=np.float32)
            c2 = np.zeros((b_pad, t_pad), dtype=np.float32)
            gbits = np.zeros((b_pad, t_pad), dtype=np.uint32)
            must = np.zeros(b_pad, dtype=np.uint32)
            mustnot = np.zeros(b_pad, dtype=np.uint32)
            should = np.zeros(b_pad, dtype=np.uint32)
            for j, (_, a, m, mn, sh) in enumerate(chunk):
                starts[j], lens[j] = a.starts, a.lens
                weights[j], c1[j], c2[j], gbits[j] = a.weights, a.c1, a.c2, a.gbits
                must[j], mustnot[j], should[j] = m, mn, sh
            annot = jax.profiler.TraceAnnotation(
                f"fugu:xla_merge t={t_pad} l={l_pad} b={b_pad} k={k}"
            )
            with annot:
                scores, docs = segment_topk_batch(
                    e_docd,
                    e_tffidd,
                    tombd,
                    jnp.asarray(starts),
                    jnp.asarray(lens),
                    jnp.asarray(weights),
                    jnp.asarray(c1),
                    jnp.asarray(c2),
                    jnp.asarray(gbits),
                    jnp.asarray(must),
                    jnp.asarray(mustnot),
                    jnp.asarray(should),
                    t_pad=t_pad,
                    l_pad=l_pad,
                    k=k,
                    need_bits=need_bits,
                )
            scores = np.asarray(scores)
            docs = np.asarray(docs)
            for j, (i, *_rest) in enumerate(chunk):
                keep = np.isfinite(scores[j])
                hits = [
                    (float(s), int(d))
                    for s, d in zip(scores[j][keep], docs[j][keep])
                ]
                # device floats -> oracle-exact host floats before the
                # final ranking (device sums run in another order)
                from fugu_tpu.ops.rescore import rescore_hits

                results[i] = rescore_hits(segment, plans[i], stats, hits)[
                    :limit
                ]
    return results


def device_search_segment(
    segment: Segment,
    plan: QueryPlan,
    stats,
    limit: int,
) -> Optional[List[Tuple[float, int]]]:
    """Single-query convenience wrapper over device_search_batch."""
    return device_search_batch(segment, [plan], stats, limit)[0]
