"""Block scorer: block-partitioned BM25 scoring + boolean + top-k.

Doc space is cut into blocks of ``BLOCK`` docs; each clause's postings
are sorted by doc id, so its entries for one block are a contiguous
subrange of its posting window.  The host stages, per (query, block),
the T subrange starts/counts (one vectorized ``np.searchsorted`` per
clause) and compacts the per-query list of nonempty blocks, so sparse
queries touch only the blocks they hit.  The two-phase batch engine
(ops/batch_scorer) passes each query's surviving candidate blocks
(``block_lists``); the single-query path visits every nonempty block.

Per dispatch, on the device:

1. gather each (query, block, clause) window of at most BLOCK entries
   from the segment's (doc, tf|fid) entry pack
2. BM25 contribution per entry — w_t * tf / (tf + c1_t + c2_t *
   smallfloat_decode(fid)) — with the branch-free fieldnorm decode
3. scatter into dense [query, block, clause, BLOCK] planes (a clause
   holds each doc at most once), sum the planes into block scores and
   OR their group bits into the boolean MUST/MUST_NOT/SHOULD masks
4. tombstone mask, then the top-k with the (score desc, doc asc) tie
   rule (ops/scoring.top_k_lowest)

Final scores are recomputed on the host (ops/rescore.py), so the hits
are bit-identical to the oracle.  Correctness oracle: fugu_tpu.ops.oracle;
parity tested in tests/test_pallas_scorer.py.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fugu_tpu import jax_setup
from fugu_tpu.index.segment import Segment
from fugu_tpu.ops import buckets
from fugu_tpu.ops.rescore import rescore_hits
from fugu_tpu.ops.scoring import (
    NEG_INF,
    _decode_fid,
    mask_i32,
    stage_clauses,
    top_k_lowest,
)
from fugu_tpu.query import QueryPlan

jax_setup.configure()

BLOCK = 2048          # docs per block (== max entries per clause-block)
#: per-row block-count ladder (compile signatures)
NB_BUCKETS = (4, 16, 64, 256)
NB_SPLIT = 256        # queries touching more blocks than this split into
                      # multiple rows over block slices (slices partition
                      # doc space, so per-slice top-k lists merge exactly)
MAX_K = 128           # largest extraction (the k_extract ladder's top)
#: budget of dense [query, block, clause, BLOCK] elements per dispatch;
#: bounds b_pad for the wide signatures
DENSE_ELEMS = 1 << 25

_INT_MAX = np.int32(2**31 - 1)


def _dense_block_scores(block_ids, starts, counts, weights, c1, c2, gbits,
                   e_doc, e_tffid, *, t_pad, nb_pad, b_pad, need_bits):
    """(scores, bits) as [b_pad, nb_pad, BLOCK] (bits None without
    boolean constraints)."""
    st = starts.reshape(b_pad, nb_pad, t_pad)
    ct = counts.reshape(b_pad, nb_pad, t_pad)
    lane = jnp.arange(BLOCK, dtype=jnp.int32)
    valid = lane < ct[..., None]                      # [b, nb, t, BLOCK]
    pos = jnp.where(valid, st[..., None] + lane, 0)
    doc = e_doc[pos]
    pk = e_tffid[pos]
    tf = (pk & 0xFFFFFF).astype(jnp.float32)
    fid = (pk >> 24) & 0xFF
    per_q = lambda a: a[:, None, :, None]             # [b, t] -> bcast
    denom = tf + per_q(c1) + per_q(c2) * _decode_fid(fid).astype(jnp.float32)
    # Tantivy associates as weight * (tf / denom) — match it so exact
    # ties stay exact ties
    contrib = per_q(weights) * (tf / denom)
    local = doc - block_ids[:, :, None, None] * BLOCK
    plane = jax.lax.broadcasted_iota(jnp.int32, valid.shape, 2)
    row = (
        jax.lax.broadcasted_iota(jnp.int32, valid.shape, 0) * nb_pad
        + jax.lax.broadcasted_iota(jnp.int32, valid.shape, 1)
    )
    size = b_pad * nb_pad * t_pad * BLOCK
    # invalid lanes go to distinct out-of-range slots (dropped), so the
    # scatter's indices stay unique
    lin = (row * t_pad + plane) * BLOCK + lane
    flat = jnp.where(valid, (row * t_pad + plane) * BLOCK + local, size + lin)
    # absent = NaN (a contribution is never NaN, but may be negative: a
    # facet's idf goes below 0 once tombstones shrink the live count)
    dense = (
        jnp.full((size,), jnp.nan, jnp.float32)
        .at[flat.reshape(-1)]
        .set(contrib.reshape(-1), mode="drop", unique_indices=True)
        .reshape(b_pad, nb_pad, t_pad, BLOCK)
    )
    scores = jnp.zeros((b_pad, nb_pad, BLOCK), jnp.float32)
    bits = jnp.zeros((b_pad, nb_pad, BLOCK), jnp.int32) if need_bits else None
    for t in range(t_pad):
        d = dense[:, :, t, :]
        present = ~jnp.isnan(d)
        scores = scores + jnp.where(present, d, 0.0)
        if need_bits:
            g = gbits[:, t]
            gbit = jnp.where(g >= 0, jnp.int32(1) << jnp.maximum(g, 0), 0)
            bits = bits | jnp.where(present, gbit[:, None, None], 0)
    return scores, bits


def build_scorer_call(t_pad: int, nb_pad: int, k: int, b_pad: int,
                      need_bits: bool):
    """The raw (unjitted) scorer ``(nblocks, block_ids, starts, counts,
    weights, c1, c2, gbits, masks, e_doc, e_tffid, tomb) -> (top_s,
    top_d)``, each [b_pad, 1, min(k, nb_pad * BLOCK)] — callers jit it
    directly (build_scorer) or trace it inside shard_map
    (parallel.pallas_sharded).  ``tomb`` holds per-doc 0/1 flags in any
    shape whose rows reshape to BLOCK docs."""

    def call(nblocks, block_ids, starts, counts, weights, c1, c2, gbits,
             masks, e_doc, e_tffid, tomb):
        scores, bits = _dense_block_scores(
            block_ids, starts, counts, weights, c1, c2, gbits, e_doc,
            e_tffid, t_pad=t_pad, nb_pad=nb_pad, b_pad=b_pad,
            need_bits=need_bits,
        )
        if need_bits:
            must = masks[:, 0, None, None]
            mustnot = masks[:, 1, None, None]
            should = masks[:, 2, None, None]
            matched = (bits & (must | should)) != 0
            matched &= (bits & must) == must
            matched &= (bits & mustnot) == 0
            matched &= ((bits & should) != 0) | (should == 0)
        else:
            # pure-should: every scored doc matches (weights are > 0)
            matched = scores > 0.0
        matched &= tomb.reshape(-1, BLOCK)[block_ids] == 0
        slot_ok = jnp.arange(nb_pad)[None, :] < nblocks[:, None]
        matched &= slot_ok[:, :, None]
        flat = jnp.where(matched, scores, NEG_INF).reshape(
            b_pad, nb_pad * BLOCK
        )
        # block_ids rows ascend, so the lowest index on a tie is the
        # lowest global doc id
        top_s, idx = top_k_lowest(flat, min(k, nb_pad * BLOCK))
        gdoc = (
            jnp.take_along_axis(block_ids, idx // BLOCK, axis=1) * BLOCK
            + idx % BLOCK
        )
        top_d = jnp.where(top_s > NEG_INF, gdoc, jnp.int32(_INT_MAX))
        return top_s[:, None, :], top_d[:, None, :]

    return call


_SCORER_CACHE: dict = {}

# CUMULATIVE wall-time attribution across all pallas_search_batch calls
# (seconds): host staging (searchsorted + table packing) vs device
# (dispatch + result sync).  Never reset — diff snapshots for per-call
# numbers.
PROFILE = {"stage_s": 0.0, "device_s": 0.0, "dispatches": 0}


def _get_scorer(t_pad, nb_pad, k, b_pad, need_bits):
    key = (t_pad, nb_pad, k, b_pad, need_bits)
    if key not in _SCORER_CACHE:
        _SCORER_CACHE[key] = jax.jit(
            build_scorer_call(t_pad, nb_pad, k, b_pad, need_bits)
        )
    return _SCORER_CACHE[key]


def nb_bucket(n: int) -> int:
    for v in NB_BUCKETS:
        if n <= v:
            return v
    return NB_BUCKETS[-1]


def plan_block_tables(e_doc_host, args, t_pad, n_blocks, must, offs_cache):
    """Per-block clause subranges for one staged plan.

    Returns (st[int64 n_blocks,T], ct, nonempty block ids) — one
    vectorized searchsorted per clause over the doc-sorted posting window,
    with conjunctive pruning (a block missing every clause of some MUST
    group cannot match).  offs_cache memoizes per (start, len) — the
    tables are query-independent, so Zipf-heavy repeated terms skip the
    searchsorted entirely.
    """
    edge = np.arange(n_blocks + 1, dtype=np.int64) * BLOCK
    st = np.zeros((n_blocks, t_pad), dtype=np.int64)
    ct = np.zeros((n_blocks, t_pad), dtype=np.int64)
    for t in range(t_pad):
        s0, ln = int(args.starts[t]), int(args.lens[t])
        if ln == 0:
            continue
        offs = offs_cache.get((s0, ln))
        if offs is None:
            window = e_doc_host[s0 : s0 + ln]
            offs = np.searchsorted(window, edge)
            offs_cache[(s0, ln)] = offs
        st[:, t] = s0 + offs[:-1]
        ct[:, t] = offs[1:] - offs[:-1]
    keep = ct.sum(axis=1) > 0
    if must:
        for g in range(32):
            if not (must >> g) & 1:
                continue
            cols = [t for t in range(t_pad) if int(args.gbits[t]) == (1 << g)]
            if cols:
                keep &= ct[:, cols].sum(axis=1) > 0
    return st, ct, np.nonzero(keep)[0]


def pallas_search_batch(
    segment: Segment,
    plans: Sequence[QueryPlan],
    stats,
    limit: int,
    block_lists: Optional[dict] = None,
) -> List[Optional[List[Tuple[float, int]]]]:
    """Block-scorer equivalent of ops.scoring.device_search_batch.

    Returns a result list aligned with `plans`; None entries mean the
    caller must use another path (oracle or the XLA kernel).

    ``block_lists`` (plan index -> allowed block ids) restricts each
    query to a caller-proven candidate set — the two-phase batch engine
    (ops/batch_scorer) passes the blocks whose phase-A maxima can still
    reach the kth score, cutting ~490 block visits per query to ~15.
    """
    return pallas_search_collect([
        pallas_search_begin(segment, plans, stats, limit, block_lists)
    ])[0]


def pallas_search_begin(
    segment: Segment,
    plans: Sequence[QueryPlan],
    stats,
    limit: int,
    block_lists: Optional[dict] = None,
):
    """Stage and queue all kernel dispatches for one batch WITHOUT
    waiting for results — callers with several independent batches (the
    two-phase engine's per-limit wave groups) begin them all and collect
    once, so the batches' device work and fetches overlap instead of
    serializing at each batch's sync point."""
    results: List[Optional[List[Tuple[float, int]]]] = [None] * len(plans)
    if limit > MAX_K:
        return (results, [], limit, 0.0, segment, plans, stats)
    prof_t0 = time.perf_counter()
    # When limit lands EXACTLY on a bucket, extract at the next step so
    # the host rescore always sees slack candidates past the boundary —
    # a last-ulp device-vs-host rounding flip at the k-th/(k+1)-th
    # boundary could otherwise exclude the true k-th doc before rescore
    # runs.  At limit == MAX_K there is no headroom (documented
    # zero-slack case).
    k = buckets.k_extract(limit) or MAX_K

    n_blocks = max((segment.doc_count + BLOCK - 1) // BLOCK, 1)
    staged = []
    for i, plan in enumerate(plans):
        if plan.host_only:
            continue
        from fugu_tpu.ops.scoring import has_nonpositive_weight

        if has_nonpositive_weight(plan, stats):
            continue  # 'scores > 0 == matched' breaks; host fallback
        n_clauses = sum(len(g.clauses) for g in plan.groups)
        # floor at 4: 1-term and 4-term queries share one compiled
        # signature and one dispatch per batch; inactive clause slots
        # cost nothing (their blocks/chunks are pruned or skipped)
        t_pad = max(buckets.t_bucket(max(n_clauses, 1)), 4)
        if t_pad > 16 or len(plan.groups) > 32:
            continue
        args, must, mustnot, should, need_bits = stage_clauses(
            segment, plan, stats, t_pad
        )
        if args is None:
            # stage_clauses returned None => every clause had df == 0
            # (the >32-group case was already filtered above): no doc
            # can score, so the empty result is exact
            results[i] = []
            continue
        staged.append((i, t_pad, args, must, mustnot, should, need_bits))

    if not staged:
        return (results, [], limit, time.perf_counter() - prof_t0, segment, plans, stats)

    by_t: dict = {}
    for item in staged:
        by_t.setdefault((item[1], item[6]), []).append(item)

    e_docd, e_tffidd, _ = segment.device_pack()
    tombd = segment.device_tomb_flags()
    e_doc_np = segment.e_doc

    # dispatches are queued async (jax dispatch returns immediately);
    # results convert after ALL chunks are in flight
    pending: list = []

    # per-term block-offset tables are query-independent — cache them on
    # the segment so repeated terms across a batch (Zipf query loads hit
    # the same heavy terms constantly) skip the searchsorted
    offs_cache = segment.__dict__.setdefault("_pallas_block_offsets", {})

    for (t_pad, need_bits), items in by_t.items():
        rows = []
        for (i, _t, args, must, mustnot, should, _nb) in items:
            st, ct, nonempty = plan_block_tables(
                e_doc_np, args, t_pad, n_blocks, must, offs_cache
            )
            if block_lists is not None and i in block_lists:
                # ascending, as the top-k tie rule needs
                nonempty = np.intersect1d(
                    np.asarray(block_lists[i], dtype=np.int64), nonempty
                )
            # block-heavy queries become several rows over block slices;
            # result assembly merges the per-slice top-k lists
            for s in range(0, max(len(nonempty), 1), NB_SPLIT):
                rows.append(
                    (i, args, must, mustnot, should, st, ct,
                     nonempty[s : s + NB_SPLIT])
                )
        if not rows:
            continue
        # bucket each row by its OWN block count: one block-heavy query
        # must not drag the whole batch into the big-NB signature (whose
        # dense-element budget forces a small b_pad)
        by_nb: dict = {}
        for r in rows:
            by_nb.setdefault(nb_bucket(max(len(r[7]), 1)), []).append(r)
        for nb_pad, nb_rows in sorted(by_nb.items()):
            _dispatch_rows(
                nb_rows, nb_pad, t_pad, k, need_bits,
                e_docd, e_tffidd, tombd, pending,
            )
    PROFILE["dispatches"] += len(pending)
    return (results, pending, limit, time.perf_counter() - prof_t0, segment, plans, stats)


def pallas_search_collect(handles):
    """Fetch and assemble results for a list of `pallas_search_begin`
    handles with one overlapped device transfer."""
    dev_t0 = time.perf_counter()
    flat = jax_setup.fetch_np(
        [a for h in handles for _c, pair in h[1] for a in pair]
    )
    it = iter(flat)
    out = []
    for results, pending, limit, stage_s, segment, plans, stats in handles:
        partial: dict = {}
        for chunk, _p in pending:
            top_s = next(it)[:, 0, :]
            top_d = next(it)[:, 0, :]
            for bi, (i, *_rest) in enumerate(chunk):
                keep = np.isfinite(top_s[bi]) & (top_d[bi] != _INT_MAX)
                partial.setdefault(i, []).extend(
                    (float(s), int(d))
                    for s, d in zip(top_s[bi][keep], top_d[bi][keep])
                )
        for i, hits in partial.items():
            # slices partition doc space; scores are then replaced with
            # oracle-exact host floats (device sums run in another
            # order) and re-ranked, so ordering is bit-identical to the
            # oracle
            results[i] = rescore_hits(segment, plans[i], stats, hits)[:limit]
        PROFILE["stage_s"] += stage_s
        out.append(results)
    PROFILE["device_s"] += time.perf_counter() - dev_t0
    return out


def _dispatch_rows(
    rows, nb_pad, t_pad, k, need_bits,
    e_docd, e_tffidd, tombd, pending,
):
    """Queue scorer dispatches for rows sharing one (t_pad, nb_pad,
    need_bits) signature; results are converted later by the caller."""
    cap = max(1, DENSE_ELEMS // (nb_pad * t_pad * BLOCK))
    # b_pad from the B ladder: the smallest rung holding every row, at
    # most the dense-element budget; a tail chunk pads with inactive rows
    b_max = max([x for x in buckets.B_BUCKETS if x <= cap] or [1])
    b_pad = min(buckets.b_bucket(len(rows)), b_max)
    pos = 0
    while pos < len(rows):
        chunk = rows[pos : pos + b_pad]
        pos += len(chunk)

        block_ids = np.zeros((b_pad, nb_pad), dtype=np.int32)
        nblocks = np.zeros(b_pad, dtype=np.int32)
        starts = np.zeros((b_pad, nb_pad, t_pad), dtype=np.int32)
        counts = np.zeros((b_pad, nb_pad, t_pad), dtype=np.int32)
        weights = np.zeros((b_pad, t_pad), dtype=np.float32)
        c1 = np.ones((b_pad, t_pad), dtype=np.float32)
        c2 = np.zeros((b_pad, t_pad), dtype=np.float32)
        gbits = np.full((b_pad, t_pad), -1, dtype=np.int32)
        masks = np.zeros((b_pad, 3), dtype=np.int32)

        for bi, (i, args, must, mustnot, should, st, ct, nonempty) in enumerate(
            chunk
        ):
            nb = len(nonempty)
            nblocks[bi] = nb
            block_ids[bi, :nb] = nonempty
            starts[bi, :nb] = st[nonempty]
            counts[bi, :nb] = ct[nonempty]
            weights[bi] = args.weights
            c1[bi] = args.c1
            c2[bi] = args.c2
            for t in range(t_pad):
                bits = int(args.gbits[t])
                gbits[bi, t] = bits.bit_length() - 1 if bits else -1
            masks[bi] = (mask_i32(must), mask_i32(mustnot), mask_i32(should))

        scorer = _get_scorer(t_pad, nb_pad, k, b_pad, need_bits)
        annot = jax.profiler.TraceAnnotation(
            f"fugu:block_scorer t={t_pad} nb={nb_pad} b={b_pad} k={k}"
        )
        with annot:
            top_s, top_d = scorer(
                jnp.asarray(nblocks),
                jnp.asarray(block_ids),
                jnp.asarray(starts.reshape(b_pad, nb_pad * t_pad)),
                jnp.asarray(counts.reshape(b_pad, nb_pad * t_pad)),
                jnp.asarray(weights),
                jnp.asarray(c1),
                jnp.asarray(c2),
                jnp.asarray(gbits),
                jnp.asarray(masks),
                e_docd,
                e_tffidd,
                tombd,
            )
        pending.append((chunk, (top_s, top_d)))
